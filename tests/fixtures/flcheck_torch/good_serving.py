"""Fixture: serving-style code that is CLEAN under FLC006-FLC009.

Same shapes as the bad fixtures, written the sanctioned way: every shared
mutation under the class's own lock, one handle snapshot per function,
bounded LRU eviction on the per-key cache, data-plane selection via
``torch.where`` instead of a Python branch.
"""
import collections
import threading

import torch


class LockedRegistry:
    def __init__(self):
        self._slots = {}
        self._lock = threading.Lock()

    def publish(self, slot, handle):
        with self._lock:
            self._slots[slot] = handle

    def retire(self, slot):
        with self._lock:
            return self._slots.pop(slot, None)


class BoundedCache:
    def __init__(self, cap=128):
        self.cap = cap
        self._entries = collections.OrderedDict()

    def record(self, consumer_id, forecast):
        self._entries[consumer_id] = forecast
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)


def snapshot_fetch(registry, slot):
    handle = registry.handle(slot)         # ONE snapshot, reused
    return handle.cfg, handle.params, handle.generation


def guard_nan(pred):
    return torch.where(torch.isnan(pred), torch.zeros_like(pred), pred)
