"""PyTorch/CUDA port of the federated demand-forecasting system.

Each ``repro_torch/<path>.py`` is the counterpart of ``repro/<path>.py`` in
the JAX package, which stays the reference.  The package imports torch and
numpy, never JAX.  The fused LSTM/GRU cells are hand-written CUDA kernels
for Hopper (``csrc/``), built at first use.
"""

# The public names of the JAX package's packages that have no counterpart
# here, because they only mean something under JAX: the shard_map rounds
# (the port's mesh is torch.distributed ranks: RoundEngine(mesh=...),
# core/aggregation.py) and sharding/compat.py's shard_map shim.  Every other
# public name of repro.<package> is importable from repro_torch.<package>.
JAX_ONLY = {
    "core": ("make_pipeline_round", "make_sharded_engine_round",
             "make_sharded_round"),
    "sharding": ("shard_map",),
    "sharding.compat": ("shard_map",),
}
