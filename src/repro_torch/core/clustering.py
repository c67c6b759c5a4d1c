"""K-means client clustering on privacy-coarsened summaries (paper §3.1).

Clients are clustered on their 273-dim daily-average consumption vectors
(``data.windows.daily_average_vector``).  Includes the elbow curve (inertia
vs k) and silhouette score used in §4.4 to justify k=4.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def kmeans(x: np.ndarray, k: int, *, n_iter: int = 100, seed: int = 0,
           n_init: int = 4) -> Tuple[np.ndarray, np.ndarray, float]:
    """Lloyd's K-means with k-means++ init; best of ``n_init`` restarts.

    x: (N, D). Returns (centroids (k, D), assignments (N,), inertia).
    """
    best = None
    for init in range(n_init):
        # SeedSequence([seed, init]) mixes injectively; seed + init collides
        # across (seed, init) pairs and correlates neighbouring seeds
        rng = np.random.default_rng(np.random.SeedSequence([seed, init]))
        cents = _kmeanspp(x, k, rng)
        assign = np.zeros(x.shape[0], np.int64)
        for _ in range(n_iter):
            d2 = ((x[:, None, :] - cents[None]) ** 2).sum(-1)   # (N, k)
            new_assign = d2.argmin(1)
            if (new_assign == assign).all() and _ > 0:
                break
            assign = new_assign
            for c in range(k):
                m = assign == c
                if m.any():
                    cents[c] = x[m].mean(0)
                else:                                   # re-seed empty cluster
                    cents[c] = x[rng.integers(x.shape[0])]
        inertia = float(((x - cents[assign]) ** 2).sum())
        if best is None or inertia < best[2]:
            best = (cents.copy(), assign.copy(), inertia)
    return best


def _kmeanspp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    cents = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((x[:, None, :] - np.stack(cents)[None]) ** 2).sum(-1), 1)
        p = d2 / max(d2.sum(), 1e-12)
        cents.append(x[rng.choice(n, p=p)])
    return np.stack(cents).astype(np.float64)


def assign(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid assignment for held-out clients (§5.1 large test set)."""
    d2 = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
    return d2.argmin(1)


def elbow_curve(x: np.ndarray, ks, seed: int = 0) -> np.ndarray:
    """Inertia per k — the elbow plot of §4.4."""
    return np.array([kmeans(x, k, seed=seed)[2] for k in ks])


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient (O(N²), fine for ≤ a few hundred clients)."""
    n = x.shape[0]
    d = np.sqrt(((x[:, None, :] - x[None]) ** 2).sum(-1))
    uniq = np.unique(labels)
    s = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i, same].mean() if same.any() else 0.0
        b = np.inf
        for c in uniq:
            if c == labels[i]:
                continue
            m = labels == c
            if m.any():
                b = min(b, d[i, m].mean())
        s[i] = 0.0 if max(a, b) == 0 or not np.isfinite(b) else (b - a) / max(a, b)
    return float(s.mean())
