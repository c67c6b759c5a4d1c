"""Fixture: idiomatic port code that must produce ZERO findings under
every rule.

Exercises the sanctioned counterparts of each bad fixture: fold_in / split
derivation, SeedSequence and seeded_generator mixing, per-iteration key
refresh, comprehension key zips, seeded torch draws, perf_counter timing,
sorted iteration, explicit float32, host-side numpy float64.
"""
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.layers import seeded_generator


def derived_key(cfg_key, cid):
    return prng.fold_in(cfg_key, cid)


def split_draws(key):
    k1, k2 = prng.split(key)
    a = prng.normal(k1, (4,))
    b = prng.uniform(k2, (4,))
    return a + b


def rebind_draws(key):
    key, sub = prng.split(key)
    a = prng.normal(sub, (4,))
    key, sub = prng.split(key)             # rebind clears consumption
    b = prng.normal(sub, (4,))
    return a + b


def loop_draws(key, n):
    out = []
    for i in range(n):
        key, sub = prng.split(key)         # per-iteration refresh
        out.append(prng.normal(sub, (2,)))
    return out


def zipped_draws(key, leaves):
    ks = prng.split(key, len(leaves))
    return [x + prng.normal(k, x.shape) for x, k in zip(leaves, ks)]


def seeded_rng(seed, init):
    return np.random.default_rng(np.random.SeedSequence([seed, init]))


def seeded_init(seed, cid, n):
    g = seeded_generator(seed, cid)
    return torch.randn((n,), generator=g, dtype=torch.float32)


def bench_timing():
    t0 = time.perf_counter()               # perf_counter is fine anywhere
    return time.perf_counter() - t0


def ordered_members(members):
    return [m for m in sorted(set(members))]


def int_grid(x, scale):
    q = torch.floor(x / scale).to(torch.int32)
    return (q + 1).to(torch.int8)          # widen, compute, cast at the wire


def host_metrics(err):
    return np.asarray(err, np.float64)     # host-side fp64 is legitimate
