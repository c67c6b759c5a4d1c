"""Fixture: unlocked mutation of shared state — triggers FLC006 only.

The FLC006 rule is scoped to ``src/repro_torch/serving/``; tests feed this file
to the checker under a pretend path in that scope.  The class owns a lock
and uses it for the evicting write, but the publish path mutates the same
shared dict WITHOUT it — the race FLC006 exists to catch.  (The locked
``pop`` keeps FLC008 quiet: the mapping has an eviction path.)
"""
import threading


class RacyRegistry:
    def __init__(self):
        self._slots = {}
        self._lock = threading.Lock()

    def publish(self, slot, handle):
        self._slots[slot] = handle         # FLC006: write outside the lock

    def retire(self, slot):
        with self._lock:
            return self._slots.pop(slot, None)
