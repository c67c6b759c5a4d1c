"""Fixture: nondeterminism in replay-critical code — triggers FLC004 only.

The FLC004 rule is scoped to ``src/repro_torch/{core,data,serving}/``;
tests feed this file to the checker under a pretend path in that scope.
"""
import time

import numpy as np
import torch


def event_timestamp():
    return time.time()                     # FLC004: wall clock


def jitter_draw():
    return np.random.normal()              # FLC004: global numpy rng


def global_torch_draw(n):
    return torch.randn((n,))               # FLC004: torch's global generator


def shuffle(n):
    return torch.randperm(n)               # FLC004: torch's global generator


def inplace_draw(t):
    return t.normal_()                     # FLC004: in-place global draw


def stable_tag(name):
    return hash(name) % 1000               # FLC004: salted builtin hash


def collect(members):
    out = []
    for m in set(members):                 # FLC004: unordered iteration
        out.append(m)
    return out
