"""Per-round client selection strategies (``FLConfig.sampling``).

The server picks ``m`` participants from a cluster's member list every round.
Under non-IID load data the selection scheme measurably shifts accuracy
(Briggs et al. 2021; Taik & Cherkaoui 2020), so it is pluggable:

``uniform``
    Paper Alg. 1: up to ``min(m, |members|)`` distinct members uniformly at
    random; when ``m`` exceeds the membership (e.g. mesh-forced round
    sizes), the remainder is filled with evenly-cycled duplicates — fresh
    shuffled passes over the membership, never a member k+2 times before
    every member appears k+1 times.
``weighted``
    Without-replacement sampling with probability proportional to a per-client
    weight vector (typically local sample counts) — biases rounds toward
    data-rich buildings.
``round_robin``
    Deterministic cyclic schedule: round ``t`` takes the next ``m`` members of
    a fixed seed-shuffled ordering, so every client participates equally
    often regardless of rng state — useful for reproducible ablations.

All samplers share one signature: ``sample(rng, members, m, round_idx,
weights=None) -> np.ndarray`` of exactly ``m`` client ids from ``members``.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import numpy as np

# canonical name list lives with the configs (eager facade validation);
# re-exported here so `sampling.SAMPLING_STRATEGIES` keeps working
from repro_torch.configs.base import SAMPLING_STRATEGIES, SamplingConfig

Sampler = Callable[..., np.ndarray]


def _pad(rng: np.random.Generator, sel: np.ndarray, members: np.ndarray,
         m: int, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Pad a selection up to exactly m, preferring DISTINCT unselected members.

    Pool priority: (1) unselected members with nonzero weight (drawn without
    replacement, probability proportional to weight), (2) remaining
    unselected members (uniform, without replacement), (3) only once every
    member is already selected, evenly-cycled duplicate passes — fresh
    shuffles of the full membership — so no member appears k+2 times before
    every member appears k+1 times.  The old pad drew uniformly WITH
    replacement from ALL members, which could hand a weighted round to
    zero-weight clients and duplicate already-selected clients while
    distinct unselected members remained.
    """
    if len(sel) >= m:
        return sel[:m]
    out, need = [sel], m - len(sel)
    unsel = ~np.isin(members, sel)
    if weights is None:
        pools = [(unsel, None)]
    else:
        w = np.asarray(weights, np.float64)
        pools = [(unsel & (w > 0), w), (unsel & (w <= 0), None)]
    for mask, pw in pools:
        pool = members[mask]
        if need == 0 or len(pool) == 0:
            continue
        k = min(need, len(pool))
        p = None if pw is None else pw[mask] / pw[mask].sum()
        out.append(rng.choice(pool, size=k, replace=False, p=p))
        need -= k
    while need > 0:                    # everyone selected: cycle duplicates
        k = min(need, len(members))
        out.append(rng.permutation(members)[:k])
        need -= k
    return np.concatenate(out)


def uniform_sampler(rng: np.random.Generator, members: np.ndarray, m: int,
                    round_idx: int, weights: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    sel = rng.choice(members, size=min(m, len(members)), replace=False)
    return _pad(rng, sel, members, m)


def weighted_sampler(rng: np.random.Generator, members: np.ndarray, m: int,
                     round_idx: int, weights: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    if weights is None:
        return uniform_sampler(rng, members, m, round_idx)
    w = np.asarray(weights, np.float64)
    nonzero = int(np.count_nonzero(w))
    if nonzero == 0 or w.sum() <= 0:
        return uniform_sampler(rng, members, m, round_idx)
    # without-replacement draw can yield at most `nonzero` distinct clients;
    # the remainder pads from unselected members (nonzero-weight first) so
    # the exactly-m contract holds even when some clients carry zero weight
    # (e.g. no local windows)
    k = min(m, len(members), nonzero)
    sel = rng.choice(members, size=k, replace=False, p=w / w.sum())
    return _pad(rng, sel, members, m, weights=w)


def round_robin_sampler(rng: np.random.Generator, members: np.ndarray, m: int,
                        round_idx: int, weights: Optional[np.ndarray] = None,
                        *, seed: int = 0) -> np.ndarray:
    """Cyclic schedule over a seed-shuffled ordering of ``members``.

    The ordering must be FIXED across rounds (that is the whole point of
    round-robin), so it cannot come from the stateful per-round ``rng`` —
    it is derived from ``seed`` instead, which ``make_sampler`` wires to
    ``FLConfig.seed`` so the schedule actually follows the configured seed.
    The cyclic index keeps the exactly-``m`` contract even when
    ``m > len(members)`` (members repeat within a round).
    """
    n = len(members)
    order = np.random.default_rng(seed).permutation(n)
    idx = (round_idx * m + np.arange(m)) % n
    return members[order[idx]]


_SAMPLERS = {"uniform": uniform_sampler, "weighted": weighted_sampler,
             "round_robin": round_robin_sampler}


def make_sampler(strategy: Union[str, SamplingConfig], seed: int = 0
                 ) -> Sampler:
    """Resolve the select stage to a sampler callable.

    Accepts either a strategy name + ``seed`` (legacy) or a typed
    ``SamplingConfig`` (the ``FLConfig.sampling_config`` view).  ``seed``
    parameterizes schedule-type samplers (round_robin's fixed ordering);
    rng-driven samplers ignore it and use the per-call ``rng``.
    """
    if isinstance(strategy, SamplingConfig):
        strategy, seed = strategy.strategy, strategy.seed
    if strategy not in _SAMPLERS:
        raise ValueError(f"unknown sampling strategy {strategy!r}; expected "
                         f"one of {SAMPLING_STRATEGIES}")
    if strategy == "round_robin":
        return functools.partial(round_robin_sampler, seed=seed)
    return _SAMPLERS[strategy]
