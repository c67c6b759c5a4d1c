"""OpenEIA-calibrated synthetic commercial-building demand corpus.

The real OpenEIA comstock release is not available offline, so this module
generates a corpus whose *marginal statistics match what the paper reports*
(§4.1, Fig. 2): 15-min kWh readings, 35,040 samples/building-year, and a
long-tailed mean-consumption distribution with min 0.16, Q1 4.7, median 12.7,
Q3 28.4 kWh and a tail beyond 63.8 kWh.

Mean consumption is drawn log-normally: median 12.7 ⇒ μ = ln 12.7; the paper's
Q3/median ratio 28.4/12.7 = 2.236 ⇒ σ = ln(2.236)/0.6745 ≈ 1.19.  Per-building
series mix commercial archetypes (office / retail / industrial / school /
restaurant) with daily + weekly + annual seasonality and AR(1) noise — the
heterogeneity the paper's clustering exploits.

Everything is deterministic in (state, building_id): building i of a state is
always the same series, so train/held-out splits are reproducible and the
39k-building evaluations stream without holding the corpus in memory.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

STEPS_PER_DAY = 96            # 15-min sampling
DAYS_PER_YEAR = 365

# state -> (seed offset, scale, annual-seasonality amplitude, summer-peak phase)
STATES = {
    "CA": dict(seed=1_000_003, scale=1.00, annual_amp=0.15, phase=0.55),
    "FLO": dict(seed=2_000_003, scale=1.05, annual_amp=0.30, phase=0.52),
    "RI": dict(seed=3_000_003, scale=0.90, annual_amp=0.22, phase=0.02),
}

# archetype -> (daytime window, weekday factor, weekend factor, base load frac)
_ARCHETYPES = (
    # name        open  close  wkday wkend  base  evening_bump
    ("office",     8.0, 18.0,  1.00, 0.25, 0.25, 0.0),
    ("retail",    10.0, 21.0,  1.00, 0.95, 0.30, 0.0),
    ("industrial", 0.0, 24.0,  1.00, 0.80, 0.85, 0.0),
    ("school",     7.0, 16.0,  1.00, 0.10, 0.20, 0.0),
    ("restaurant", 11.0, 23.0, 1.00, 1.10, 0.25, 0.6),
)

LOGNORM_MU = float(np.log(12.7))
LOGNORM_SIGMA = float(np.log(28.4 / 12.7) / 0.6745)
MIN_KWH = 0.16


def _rng(state: str, building_id: int) -> np.random.Generator:
    cfg = STATES[state]
    return np.random.default_rng(np.random.SeedSequence([cfg["seed"], building_id]))


def mean_consumption(state: str, building_ids: Sequence[int]) -> np.ndarray:
    """Target mean kWh per building (the Fig. 2 marginal), deterministic."""
    out = np.empty(len(building_ids), np.float64)
    for j, b in enumerate(building_ids):
        g = _rng(state, b)
        out[j] = max(MIN_KWH, np.exp(LOGNORM_MU + LOGNORM_SIGMA * g.standard_normal())
                     * STATES[state]["scale"])
    return out


def _daily_shape(arch_row, hours: np.ndarray) -> np.ndarray:
    """Smooth occupancy curve over one day (96 steps), peak 1.0."""
    _, op, cl, _, _, base, evening = arch_row
    occ = 1.0 / (1.0 + np.exp(-(hours - op) * 1.5)) * \
          1.0 / (1.0 + np.exp((hours - cl) * 1.5))
    if evening:
        occ = occ + evening * np.exp(-0.5 * ((hours - 19.5) / 1.5) ** 2)
    shape = base + (1.0 - base) * occ / max(occ.max(), 1e-9)
    return shape


def generate_buildings(state: str, building_ids: Sequence[int],
                       days: int = DAYS_PER_YEAR) -> np.ndarray:
    """Generate (n_buildings, days*96) float32 kWh series, deterministic."""
    n_steps = days * STEPS_PER_DAY
    hours = (np.arange(STEPS_PER_DAY) + 0.5) * 24.0 / STEPS_PER_DAY
    day_idx = np.arange(days)
    scfg = STATES[state]
    means = mean_consumption(state, building_ids)
    out = np.empty((len(building_ids), n_steps), np.float32)
    for j, b in enumerate(building_ids):
        g = _rng(state, b)
        g.standard_normal()                              # consumed by mean draw
        arch = _ARCHETYPES[int(g.integers(len(_ARCHETYPES)))]
        arch = (arch[0],) + tuple(
            v * (1.0 + 0.15 * g.standard_normal()) if isinstance(v, float) and v
            else v for v in arch[1:])
        daily = _daily_shape(arch, hours)                # (96,)
        wk = np.where((day_idx % 7) < 5, arch[3], arch[4])   # (days,)
        annual = 1.0 + scfg["annual_amp"] * np.cos(
            2 * np.pi * (day_idx / 365.0 - scfg["phase"]))
        grid = (daily[None, :] * wk[:, None] * annual[:, None]).reshape(-1)
        # AR(1) multiplicative noise — exact via truncated impulse response
        # (ρ=0.9 ⇒ ρ^128 ≈ 1e-6, negligible), vectorized as a convolution.
        rho = 0.9
        eps = g.standard_normal(n_steps) * 0.08
        kern = rho ** np.arange(128)
        noise = np.convolve(eps, kern)[:n_steps]
        series = grid * np.exp(noise)
        series *= means[j] / max(series.mean(), 1e-9)     # hit the target mean
        out[j] = np.maximum(series, 0.01).astype(np.float32)
    return out


def state_population(state: str) -> int:
    """Paper Table 1 building counts."""
    return {"CA": 39391, "FLO": 24444, "RI": 1376}[state]
