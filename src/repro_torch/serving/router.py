"""Serve-time cluster routing for unseen consumers (paper §5.4 + §3.1).

Training clusters clients by k-means on their privacy-coarsened daily-mean
consumption vectors (``core/clustering.py``, Briggs et al. — clustering
BEFORE federation handles non-IID load).  At serve time an unseen consumer
has no cluster label, so the router assigns one by **nearest centroid on the
same coarsened summary** — the consumer's raw history is reduced to daily
means (never the raw 15-min trace) before any comparison, matching the
privacy posture of training-side clustering.

With clustering off (no centroids) the router is disabled and everything
maps to ``GLOBAL_SLOT`` — the single-global deployment of the base paper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import clustering
from repro_torch.data.synthetic import STEPS_PER_DAY
from repro_torch.serving.registry import GLOBAL_SLOT

__all__ = ["ClusterRouter", "daily_summary_of"]


def daily_summary_of(series: np.ndarray, days: int) -> np.ndarray:
    """One consumer's raw history -> fixed-width (days,) daily-mean summary.

    Mirrors ``ClientWindowProvider.daily_summary`` padding semantics:
    shorter histories contribute the days they have and are right-padded
    with their own mean; a sub-day history degenerates to a flat summary.
    At serve time the WHOLE provided history is observation (there is no
    train/test split to protect), so no cut is applied.
    """
    s = np.asarray(series, np.float64).reshape(-1)
    out = np.empty(days, np.float64)
    d = min(days, len(s) // STEPS_PER_DAY)
    if d == 0:
        out[:] = s.mean() if len(s) else 0.0
        return out
    z = s[:d * STEPS_PER_DAY].reshape(d, STEPS_PER_DAY).mean(-1)
    out[:d] = z
    out[d:] = z.mean()
    return out


class ClusterRouter:
    """Nearest-centroid slot assignment on coarsened daily summaries.

    ``centroids``: the (k, days) k-means centroids a clustered FL run
    reports on every ``FLResult.cluster_centroids``; ``None`` disables
    routing (every consumer -> ``GLOBAL_SLOT``).
    """

    def __init__(self, centroids: Optional[np.ndarray] = None):
        self.centroids = (None if centroids is None
                          else np.asarray(centroids, np.float64))
        if self.centroids is not None and self.centroids.ndim != 2:
            raise ValueError(
                f"centroids must be (k, days), got {self.centroids.shape}")

    @classmethod
    def from_result(cls, result) -> "ClusterRouter":
        """Router for an ``FLResult`` (clustered or not)."""
        return cls(getattr(result, "cluster_centroids", None))

    @property
    def enabled(self) -> bool:
        return self.centroids is not None

    @property
    def days(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[1]

    def route(self, history: np.ndarray) -> int:
        """One consumer's raw watt-hour history -> model slot."""
        if not self.enabled:
            return GLOBAL_SLOT
        z = daily_summary_of(history, self.days)
        return int(clustering.assign(z[None, :], self.centroids)[0])

    def route_summaries(self, z: np.ndarray) -> np.ndarray:
        """Batch assignment for already-coarsened (n, days) summaries."""
        if not self.enabled:
            return np.full(len(z), GLOBAL_SLOT, np.int64)
        return clustering.assign(np.asarray(z, np.float64), self.centroids)
