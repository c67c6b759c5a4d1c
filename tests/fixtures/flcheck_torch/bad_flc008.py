"""Fixture: unbounded per-key cache growth — triggers FLC008 only.

The FLC008 rule is scoped to ``src/repro_torch/serving/``; tests feed this file
to the checker under a pretend path in that scope.  Every consumer id ever
seen stays in the dict forever: no eviction, no size check — the leak
pattern real serving traffic turns into an OOM.  (No lock attr in the
class, so FLC006 stays quiet.)
"""


class LeakyResults:
    def __init__(self):
        self._results = {}

    def record(self, consumer_id, forecast):
        self._results[consumer_id] = forecast   # FLC008: grow-only mapping

    def fetch(self, consumer_id):
        return self._results.get(consumer_id)
