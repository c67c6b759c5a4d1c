"""The port's ``lax.scan``: the loops of identical trips that the reference
scans (a stack's identical layers, the microbatches, the sLSTM's steps).

:func:`loop` runs every trip.  A cost model may answer a loop in its
place while it is registered in :data:`HOOKS`: the dry run's tracker
(``launch.costmodel.StepTracker``) traces three trips on fake tensors and
counts them for all, as the reference's cost model multiplies a scan's
body by its length."""
from __future__ import annotations

from typing import Callable, List

# ``hook(n, body, carry)``: (carry, [y of each trip]) in the loop's
# place, or None to leave it to run every trip; the innermost last
HOOKS: List[Callable] = []


def loop(n: int, body, carry):
    """``body(i, carry) -> (carry, y)`` for i in range(n): (carry, [y of
    each trip]), unless a hook answers for the loop."""
    for hook in reversed(HOOKS):
        out = hook(n, body, carry)
        if out is not None:
            return out
    ys = []
    for i in range(n):
        carry, y = body(i, carry)
        ys.append(y)
    return carry, ys
