"""Simulated client-latency model for semi-synchronous rounds
(``LatencyConfig``; consumed by ``core/async_engine.py``).

The paper's deployment trains on a Raspberry-Pi edge cluster where a round
is gated by its slowest client (70-100 s/round on Pi 4Bs, §5.5).  Edge-FL
work on load forecasting (arXiv:2201.11248) and lightweight FL
(arXiv:2404.03320) both argue that *wall-clock*-to-accuracy — not
rounds-to-accuracy — is the metric that matters there, so the engine drives
a simulated event clock from a per-client latency model:

    t_i = mult_i * (compute_s_per_window_epoch * n_windows_i * E
                    + payload_bytes / uplink_bytes_per_s)

Compute scales with the client's local work (windows x epochs — ragged
histories make slow clients for free), uplink with the post-quantize
payload size (``payload_bytes``), and ``mult_i`` is the pluggable straggler
draw (deterministic / lognormal / heavy-tail).  Draws are a pure function
of ``(seed, round, slot)`` — no shared rng state — so a simulated schedule
replays bit-exactly under a fixed seed.

**Calibration of the default constants** (``LatencyConfig``), anchored to
the paper's measured 70-100 s Pi-4B rounds (§5.5):

``compute_s_per_window_epoch = 3.2e-3``
    The paper's clients hold one year of 15-min smart-meter readings:
    365 x 96 = 35,040 samples.  After the 75:25 chronological train split
    and lookback-8/horizon-4 windowing, that is ~26,270 training windows
    per client-epoch.  A measured round (local training dominates on the
    Pi 4B) of 70-100 s therefore brackets the per-window-epoch cost at
    70/26,270 .. 100/26,270 = 2.7 .. 3.8 ms; the default 3.2 ms puts a
    jitter-free E=1 full-year round at 26,270 x 3.2e-3 ~= 84 s — the
    middle of the measured band.
``uplink_bytes_per_s = 1e6``
    The ~140k-param LSTM upload is 561 KB in fp32 (140 KB int8-quantized).
    At 1 MB/s — a deliberately conservative shared-WiFi/constrained edge
    uplink, NOT the Pi 4B's gigabit NIC — upload adds ~0.6 s, consistent
    with the paper's compute-dominated rounds while still letting the
    quantize transform show a visible wire win at scale.
``jitter = 0.5``
    A moderate default spread; §5.5's own 70-100 s spread across identical
    Pi 4Bs corresponds to a lognormal sigma of roughly
    ln(100/84) ~= 0.17-0.5 depending on how much of the spread is per-round
    vs per-device — benchmarks that study stragglers pass their own value
    explicitly.

``link_budget`` models the hierarchical per-level wire cost (region fan-in
vs cloud ingress) for ``bench_edge`` — the follow-up to the
edge->region->cloud aggregation.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    STRAGGLER_DISTRIBUTIONS, ChurnConfig, LatencyConfig)

# domain-separation tags for the event-clock rng streams: decorrelate
# latency/churn draws from every other consumer of FLConfig.seed (sampler,
# holdout, transform keys) and from each other
_LATENCY_STREAM = 0x1A7E               # straggler multipliers
_DROPOUT_STREAM = 0xD209               # mid-upload failure draws
_AVAIL_STREAM = 0xA7A1                 # per-round membership availability
_REUPLOAD_STREAM = 0x2E71              # retry / re-key re-upload latency


def payload_bytes(n_params: int, quantize_bits: int = 0,
                  audited_bytes: Optional[float] = None) -> float:
    """Uplink payload of one client update.

    ``audited_bytes`` — a statically audited byte count from the level-3
    flcheck cost auditor (``analysis/costs.py``: exact per-leaf wire
    encoding read off the traced round's boundary crossings) — is the
    source of truth when given; the closed-form below is the FALLBACK
    model: fp32, or ``quantize_bits``-bit ints when the quantize transform
    is on (per-leaf scale overhead is a few floats on a ~140k-param model —
    ignored; the auditor counts it and reports the delta as a tracked
    divergence).  The quantized wire SURVIVES secure-agg masking: ring
    masks live in the quantizer's integer ring mod 2^b
    (``core/secure_agg.py``), so masked uploads are charged the same
    ``quantize_bits``-bit payload as clear ones — the uplink the paper's
    scalability pitch needs (``RoundEngine`` passes ``quantize_bits``
    unchanged with masking on, and the auditor proves the format)."""
    if audited_bytes is not None:
        return float(audited_bytes)
    if quantize_bits:
        return math.ceil(n_params * quantize_bits / 8)
    return n_params * 4.0


def _slot_rngs(stream: int, seed: int, round_idx: int, slots, *extra):
    """One decorrelated ``np.random.Generator`` per slot, seeded by the full
    ``(stream, seed, round, slot, *extra)`` tuple — a draw is a pure function
    of the slot VALUE, never of its position in the dispatch ordering."""
    return [np.random.default_rng(np.random.SeedSequence(
        [int(stream), int(seed), int(round_idx), int(s),
         *(int(e) for e in extra)])) for s in np.asarray(slots, np.int64)]


class LatencyModel:
    """Per-round client finish-time + failure sampler (all host-side numpy).

    ``churn`` adds the failure-injection draws (mid-upload dropout,
    per-round membership availability) on their own rng streams; the
    default ``ChurnConfig()`` injects nothing.
    """

    def __init__(self, cfg: LatencyConfig, seed: int, payload: float,
                 churn: ChurnConfig = ChurnConfig()) -> None:
        self.cfg = cfg
        self.churn = churn
        self.seed = int(seed)
        self.uplink_s = float(payload) / cfg.uplink_bytes_per_s

    def _multipliers(self, round_idx: int, slots,
                     stream: int = _LATENCY_STREAM,
                     attempt: int = 0) -> np.ndarray:
        cfg = self.cfg
        slots = np.asarray(slots, np.int64)
        if cfg.distribution == "deterministic" or cfg.jitter == 0.0:
            return np.ones(len(slots))
        rngs = _slot_rngs(stream, self.seed, round_idx, slots, attempt)
        if cfg.distribution == "lognormal":
            return np.exp(cfg.jitter
                          * np.asarray([r.standard_normal() for r in rngs]))
        # heavy_tail: occasional extreme stalls (Pareto shape 1.5 has
        # infinite variance — exactly the regime where waiting for the max
        # is catastrophic but the k-th order statistic is tame)
        return 1.0 + cfg.jitter * np.asarray([r.pareto(1.5) for r in rngs])

    def times(self, round_idx: int, n_windows: np.ndarray, epochs: int,
              slots=None) -> np.ndarray:
        """Simulated seconds from dispatch to server arrival, one per slot.

        ``n_windows``: per-client local window counts (the same per-client
        sample counts that drive weighted aggregation).  ``slots``: the
        clients' GLOBAL dispatch slots — the straggler draw is seeded per
        ``(seed, round, slot)``, so it follows the client wherever it lands
        in the dispatch ordering (defaults to ``arange``: positional).
        """
        n_windows = np.asarray(n_windows, np.float64)
        if slots is None:
            slots = np.arange(len(n_windows))
        base = (self.cfg.compute_s_per_window_epoch * n_windows * epochs
                + self.uplink_s)
        return base * self._multipliers(round_idx, slots)

    def dropouts(self, round_idx: int, slots, attempt: int = 0) -> np.ndarray:
        """Mid-upload failure draws: True where the dispatched upload never
        arrives.  Pure function of ``(seed, round, slot, attempt)`` —
        ``attempt`` decorrelates a retry's fate from the original's."""
        slots = np.asarray(slots, np.int64)
        p = self.churn.dropout_prob
        if p <= 0.0 or len(slots) == 0:
            return np.zeros(len(slots), bool)
        rngs = _slot_rngs(_DROPOUT_STREAM, self.seed, round_idx, slots,
                          attempt)
        return np.asarray([r.uniform() < p for r in rngs])

    def available(self, round_idx: int, client_ids) -> np.ndarray:
        """Membership availability mask for one round: False where the
        member has (temporarily) left the fleet.  Pure function of
        ``(seed, round, client id)``, so a client's join/leave schedule is
        independent of who else is enrolled."""
        client_ids = np.asarray(client_ids, np.int64)
        p = self.churn.absent_prob
        if p <= 0.0 or len(client_ids) == 0:
            return np.ones(len(client_ids), bool)
        rngs = _slot_rngs(_AVAIL_STREAM, self.seed, round_idx, client_ids)
        return np.asarray([r.uniform() >= p for r in rngs])

    def reupload_times(self, round_idx: int, slots,
                       attempt: int = 1) -> np.ndarray:
        """Simulated seconds for a RE-upload (retry of an abandoned update,
        or a survivor's re-masked upload after a cohort re-key): the client
        already holds its transformed delta, so the cost is uplink only,
        times a fresh straggler draw on the re-upload stream."""
        slots = np.asarray(slots, np.int64)
        return self.uplink_s * self._multipliers(
            round_idx, slots, stream=_REUPLOAD_STREAM, attempt=attempt)


def link_budget(n_params: int, m_clients: int, n_regions: int,
                quantize_bits: int = 0,
                audited_up: Optional[float] = None) -> Dict[str, float]:
    """Per-level wire cost of one round's uploads, in bytes.

    ``flat``: all m client payloads land on the cloud link.  Hierarchical:
    each region's edge aggregator absorbs ~m/R client uploads (the regional
    fan-in) and forwards ONE fp32 partial upstream, so cloud ingress drops
    from m payloads to R — client quantization compresses the fan-in links,
    the region->cloud partials are already-aggregated floats.

    ``audited_up`` overrides the per-client UPLOAD payload with a
    statically audited byte count (see :func:`payload_bytes`); the
    region->cloud partials stay modeled fp32 — they are post-aggregation
    floats regardless of the client wire format.
    """
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, got {n_regions}")
    up = payload_bytes(n_params, quantize_bits, audited_bytes=audited_up)
    region_fanin = math.ceil(m_clients / n_regions) * up
    flat_ingress = m_clients * up
    cloud_ingress = (flat_ingress if n_regions == 1
                     else n_regions * payload_bytes(n_params, 0))
    return {"region_fanin_bytes": float(region_fanin),
            "cloud_ingress_bytes": float(cloud_ingress),
            "flat_cloud_ingress_bytes": float(flat_ingress)}
