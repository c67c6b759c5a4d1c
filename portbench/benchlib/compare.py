"""The numbers that decide ``correct``, each a gap between the program's
reading and the plain reference's (float64 on the host)."""
from __future__ import annotations

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone and is left out of the leaf comparisons
STILL_LEAF = 1e-3


def loss_gap(prog, ref) -> float:
    """Largest relative gap of the per-round losses."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r) / np.abs(r)))


def leaf_norms(tree_a, tree_b):
    """Per-leaf L2 norms of a - b, for two trees given as lists of arrays."""
    return np.array([np.linalg.norm(np.asarray(a, np.float64)
                                    - np.asarray(b, np.float64))
                     for a, b in zip(tree_a, tree_b)])


def moving_leaves(ref_grad_norms) -> np.ndarray:
    """Mask of the leaves the reference moves by more than round-off."""
    g = np.asarray(ref_grad_norms)
    return g >= STILL_LEAF * np.median(g)


def norm_gap(prog_norms, ref_norms, keep) -> float:
    """Worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference leaf's norm and the median
    leaf's."""
    p = np.asarray(prog_norms)[keep]
    r = np.asarray(ref_norms)[keep]
    return float(np.max(np.abs(p - r) / np.maximum(r, np.median(r))))


def forecast_gap(prog, ref, lo, hi) -> float:
    """Largest gap of a forecast in model space: |kWh gap| over the
    consumer's range (hi - lo)."""
    scale = np.maximum(np.asarray(hi, np.float64) - lo, 1e-9)[:, None]
    d = np.abs(np.asarray(prog, np.float64) - np.asarray(ref, np.float64))
    return float(np.max(d / scale)) if d.size else float("inf")
