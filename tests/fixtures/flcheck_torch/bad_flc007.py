"""Fixture: non-atomic ModelHandle fetches — triggers FLC007 only.

The FLC007 rule is scoped to ``src/repro_torch/serving/``; tests feed this file
to the checker under a pretend path in that scope.  Both functions race a
hot swap: the registry can publish a new generation between the two looks,
so the second look does not see what the first one decided on.
"""


def double_fetch(registry, slot):
    cfg = registry.handle(slot).cfg
    params = registry.handle(slot).params  # FLC007: second fetch, same slot
    return cfg, params


def check_then_fetch(registry, slot, last_gen):
    if registry.generation(slot) == last_gen:
        return None
    return registry.handle(slot)           # FLC007: TOCTOU on the probe
