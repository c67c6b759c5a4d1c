"""Inputs made from the seed, and the host-side arithmetic the reference
needs to follow the program: the demand corpus, min-max windows, the
round's selection and minibatch draws, daily summaries and k-means.

Frozen copies, with their provenance:

* :func:`generate_buildings`: the calibration of
  ``src/repro_torch/data/synthetic.py`` (log-normal mean kWh, median 12.7,
  Q3 28.4, floor 0.16; the five commercial archetypes; weekly and annual
  seasonality; AR(1) multiplicative noise, rho 0.9, sigma 0.08), drawn in
  bulk from one seeded generator instead of one stream per building id, and
  with the AR(1) recursion exact instead of truncated at 128 taps.
* :func:`train_cut`, :func:`train_windows`, :func:`local_steps`: the
  75:25 chronological split and the look-back / horizon framing of
  ``data/windows.py``, ``partition.local_steps``.
* :func:`round_draws`: the draws of ``run_federated_training`` on one
  cluster of every client under uniform sampling
  (``core/fedavg.py::_seed_rngs``, ``sampling.uniform_sampler``,
  ``partition.ragged_minibatch_indices``' equal-count path).
* :func:`daily_summary`: ``serving/router.py::daily_summary_of`` on a
  history of at least ``days`` days.
"""
from __future__ import annotations

import numpy as np

STEPS_PER_DAY = 96
TRAIN_FRAC = 0.75

# CA: annual-seasonality amplitude and summer-peak phase; scale 1.0
ANNUAL_AMP, PHASE = 0.15, 0.55
# open, close (h), weekday, weekend factor, base-load share, evening bump:
# office, retail, industrial, school, restaurant
ARCHETYPES = np.array([
    (8.0, 18.0, 1.00, 0.25, 0.25, 0.0),
    (10.0, 21.0, 1.00, 0.95, 0.30, 0.0),
    (0.0, 24.0, 1.00, 0.80, 0.85, 0.0),
    (7.0, 16.0, 1.00, 0.10, 0.20, 0.0),
    (11.0, 23.0, 1.00, 1.10, 0.25, 0.6),
])
LOGNORM_MU = float(np.log(12.7))
LOGNORM_SIGMA = float(np.log(28.4 / 12.7) / 0.6745)
MIN_KWH = 0.16
AR_RHO, AR_SIGMA = 0.9, 0.08


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent numpy generator for one purpose of one run."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def sub_seed(seed: int, *tags: int) -> int:
    """A 31-bit seed derived from the run's seed (for APIs that want an
    int of that size)."""
    ss = np.random.SeedSequence([int(seed), *tags])
    return int(ss.generate_state(1)[0] & 0x7FFFFFFF)


def generate_buildings(rng: np.random.Generator, n: int, days: int
                       ) -> np.ndarray:
    """(n, days * 96) float32 kWh series of n CA commercial buildings."""
    T = days * STEPS_PER_DAY
    means = np.maximum(MIN_KWH, np.exp(
        LOGNORM_MU + LOGNORM_SIGMA * rng.standard_normal(n)))
    arch = ARCHETYPES[rng.integers(len(ARCHETYPES), size=n)]
    jitter = 1.0 + 0.15 * rng.standard_normal(arch.shape)
    arch = np.where(arch != 0.0, arch * jitter, arch)
    op, cl, wkday, wkend, base, evening = (arch[:, j:j + 1] for j in range(6))
    hours = (np.arange(STEPS_PER_DAY) + 0.5) * 24.0 / STEPS_PER_DAY
    occ = 1.0 / (1.0 + np.exp(-(hours - op) * 1.5)) \
        * 1.0 / (1.0 + np.exp((hours - cl) * 1.5))
    occ = occ + evening * np.exp(-0.5 * ((hours - 19.5) / 1.5) ** 2)
    shape = base + (1.0 - base) * occ / np.maximum(occ.max(1, keepdims=True),
                                                   1e-9)
    day_idx = np.arange(days)
    wk = np.where(day_idx % 7 < 5, wkday, wkend)                 # (n, days)
    annual = 1.0 + ANNUAL_AMP * np.cos(2 * np.pi * (day_idx / 365.0 - PHASE))
    grid = (shape[:, None, :] * (wk * annual)[:, :, None]).reshape(n, T)
    noise = rng.standard_normal((T, n), dtype=np.float32) * AR_SIGMA
    for t in range(1, T):                  # AR(1), time-major rows
        noise[t] += np.float32(AR_RHO) * noise[t - 1]
    series = grid.astype(np.float32) * np.exp(noise.T)
    series *= (means / np.maximum(series.mean(1), 1e-9))[:, None].astype(
        np.float32)
    return np.maximum(series, 0.01).astype(np.float32)


def minmax(series: np.ndarray):
    """Per-row min-max normalisation over the whole series: (normed, lo,
    hi), all float32, lo / hi of shape (n,)."""
    lo = series.min(-1)
    hi = series.max(-1)
    scale = np.maximum(hi - lo, np.float32(1e-9))
    return (series - lo[:, None]) / scale[:, None], lo, hi


def train_cut(T: int) -> int:
    return int(T * TRAIN_FRAC)


def train_windows(T: int, lookback: int, horizon: int) -> int:
    """Train windows of one client of T readings."""
    return train_cut(T) - (lookback + horizon - 1)


def local_steps(n_windows: int, batch: int, epochs: int) -> int:
    return max(1, (n_windows + batch - 1) // batch) * epochs


def round_draws(seed: int, n_clients: int, m: int, rounds: int,
                n_windows: int, steps: int, batch: int):
    """Each round's (selected client ids (m,), window indices (m, steps,
    batch)), as ``run_federated_training`` draws them for ``seed``."""
    _, round_ss = np.random.SeedSequence(seed).spawn(2)
    rng = np.random.default_rng(round_ss)
    members = np.arange(n_clients)
    out = []
    for _ in range(rounds):
        sel = rng.choice(members, size=min(m, n_clients), replace=False)
        bidx = rng.integers(0, n_windows, size=(len(sel), steps, batch))
        out.append((sel, bidx))
    return out


def daily_summary(history: np.ndarray, days: int) -> np.ndarray:
    """(n, T) raw histories with T >= days * 96 -> (n, days) daily means
    (float64)."""
    h = np.asarray(history, np.float64)[:, :days * STEPS_PER_DAY]
    return h.reshape(h.shape[0], days, STEPS_PER_DAY).mean(-1)


def kmeans(z: np.ndarray, k: int, rng: np.random.Generator,
           iters: int = 50) -> np.ndarray:
    """Lloyd's k-means from a k-means++ start: (k, D) centroids."""
    n = z.shape[0]
    cents = [z[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((z[:, None] - np.stack(cents)[None]) ** 2).sum(-1), 1)
        cents.append(z[rng.choice(n, p=d2 / max(d2.sum(), 1e-12))])
    cents = np.stack(cents).astype(np.float64)
    for _ in range(iters):
        a = nearest(z, cents)
        for c in range(k):
            if (a == c).any():
                cents[c] = z[a == c].mean(0)
    return cents


def nearest(z: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """Index of the nearest centroid of each row (squared distance)."""
    return ((z[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
