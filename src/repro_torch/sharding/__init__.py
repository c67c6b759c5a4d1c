"""Logical-axis sharding rules on DTensor: the counterpart of
``src/repro/sharding/``.

``rules.py`` ports the reference's rules, its spec helpers and its
constraints.  The reference's ``compat.py`` has no counterpart: it only
papers over jax versions' ``shard_map``.  The port's pods and client blocks
are already ``torch.distributed`` ranks (``core/local_sgd.py``,
``core/aggregation.py``), so nothing here maps a function over mesh axes.
"""
from repro_torch.sharding.rules import (AbstractMesh, PartitionSpec,
                                        ShardingRules, active_rules,
                                        constrain, constrain_heads,
                                        placements, safe_spec, use_rules)

__all__ = ["AbstractMesh", "PartitionSpec", "ShardingRules", "active_rules",
           "constrain", "constrain_heads", "placements", "safe_spec",
           "use_rules"]
