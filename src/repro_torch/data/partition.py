"""Client partitioning + per-round sampling (paper Alg. 1)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def sample_clients(rng: np.random.Generator, n_clients: int, m: int) -> np.ndarray:
    """Server randomly selects M clients out of N (without replacement)."""
    m = min(m, n_clients)
    return rng.choice(n_clients, size=m, replace=False)


def holdout_clients(rng: np.random.Generator, n_clients: int,
                    holdout_frac: float):
    """Client-level train/holdout split for unseen-client generalization.

    Returns (train_ids, held_ids), both sorted.  held_ids clients never
    participate in training; evaluating on their windows measures transfer to
    buildings the model has NEVER seen (paper §5.4), a strictly harder test
    than held-out windows of training clients.
    """
    n_held = int(round(n_clients * holdout_frac))
    if n_held <= 0:
        return np.arange(n_clients), np.empty(0, np.int64)
    perm = rng.permutation(n_clients)
    return np.sort(perm[n_held:]), np.sort(perm[:n_held])


def cluster_partition(assignments: np.ndarray) -> Dict[int, np.ndarray]:
    """cluster id -> client indices."""
    return {int(c): np.flatnonzero(assignments == c)
            for c in np.unique(assignments)}


def sample_minibatch_indices(rng: np.random.Generator, n_windows: int,
                             batch: int, steps: int) -> np.ndarray:
    """(steps, batch) window indices for a client's local SGD schedule.

    Emulates E epochs of shuffled minibatches with a fixed step count so the
    local update runs fixed-shape steps, batched across clients.
    """
    return rng.integers(0, n_windows, size=(steps, batch))


def ragged_minibatch_indices(rng: np.random.Generator, counts: np.ndarray,
                             steps: int, batch: int) -> np.ndarray:
    """(m, steps, batch) window indices with per-client count-masking.

    Client i's indices are drawn in ``[0, counts[i])`` so zero-padded window
    rows (ragged histories, ``ClientWindowProvider``) are never sampled.  The
    equal-count fast path issues ONE ``rng.integers`` call with the same
    bounds/shape as the historical materialized pipeline, keeping its rng
    stream — and therefore trained params — bit-identical.
    """
    counts = np.asarray(counts, np.int64)
    c0 = int(counts[0])
    if (counts == c0).all():
        return rng.integers(0, c0, size=(len(counts), steps, batch))
    return np.stack([rng.integers(0, int(c), size=(steps, batch))
                     for c in counts])


def local_steps(n_windows: int, batch: int, epochs: int) -> int:
    """Number of SGD steps for E epochs of minibatch size B (Alg. 1 inner loop)."""
    return max(1, (n_windows + batch - 1) // batch) * epochs
