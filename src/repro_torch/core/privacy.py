"""(epsilon, delta) accounting for the federated DP pipeline
(``PrivacyConfig``; see docs/privacy.md).

Each federated round with the DP transform stack on releases, for every
selected client, a clipped delta (L2 sensitivity ``C = clip_norm``) plus
per-coordinate Gaussian noise ``N(0, (z*C)^2)`` (``z = noise_multiplier``).
From the honest-but-curious server's point of view this is one invocation
of the **subsampled Gaussian mechanism**: a client participates in a round
with probability ``q ~= m/N`` (the dispatch fraction) and, when selected,
its contribution is released through a Gaussian mechanism with noise
multiplier ``z``.  Composing ``T`` rounds is done in Renyi-DP space
(Mironov 2017; Mironov/Talwar/Zhang 2019 for the sampled Gaussian):

* per-round RDP at integer order ``a``:

      q = 1:  RDP(a) = a / (2 z^2)
      q < 1:  RDP(a) = (1/(a-1)) * log( sum_{k=0}^{a}
                  C(a,k) (1-q)^(a-k) q^k exp(k(k-1) / (2 z^2)) )

  (the exact binomial expansion for integer orders, evaluated in log space
  with ``lgamma`` so large orders cannot overflow);
* RDP composes ADDITIVELY across rounds — ``T`` rounds cost ``T * RDP(a)``;
* conversion to ``(epsilon, delta)`` uses the improved bound
  (Canonne-Kamath-Steinke 2020, as in Opacus/TF-Privacy):

      eps(a) = T*RDP(a) + log1p(-1/a) - (log(delta) + log(a)) / (a - 1)

  minimized over the order grid.

Honesty notes (also in docs/privacy.md):

* Accounting needs a bounded sensitivity AND noise: with ``clip_norm == 0``
  or ``noise_multiplier == 0`` the accountant is *disabled* and reports
  ``epsilon = inf`` rather than a vacuous number.
* Two accounting MODES.  ``per-client`` (the default) accounts the
  server's per-client view with multiplier ``z`` — each client's delta is
  individually noised, so the release of the whole round is a Gaussian
  mechanism of multiplier ``z`` per contribution.  ``central:secure-agg``
  (``secure_agg_accountant``) accounts the only value the masked protocol
  reveals — the SUM — on which the ``m`` independent per-client noises add
  in variance to an aggregate Gaussian of std ``z*C*sqrt(m)`` on
  sensitivity ``C``, i.e. an effective multiplier ``z_eff = z*sqrt(m)``: a
  strictly tighter epsilon at the same per-client noise.
* The central mode is only sound when the protocol really reduces the
  server's view to the UNIFORM cohort sum (``central_gate_reason``):
  (a) RING masking — uniform integer masks over the full ring are
  information-theoretically hiding; float Gaussian masks of finite
  ``mask_std`` are not, so the float path keeps per-client accounting;
  (b) UNIFORM aggregation — under weighted aggregation client ``i``'s
  sensitivity scales with its weight share ``frac_i`` while the aggregate
  noise std is ``z*C*sqrt(sum frac^2)``, so a heavy client's effective
  multiplier approaches ``z``, not ``z*sqrt(m)`` (the exact weighted
  formula ``z_eff = z*sqrt(sum frac^2)/max frac`` is available via
  ``secure_agg_accountant(..., weights=...)`` for a FIXED weight vector);
  (c) the released sum must carry ALL ``m`` noise draws — under churn a
  Bonawitz re-key folds a survivor-only sum, so the engine reports every
  fold's surviving cohort (``observe_cohort``) and the accountant
  retroactively re-prices the whole run at the MINIMUM cohort observed
  (conservative: every released sum carried at least that much noise).
  When a gate fails the engine falls back to per-client accounting — a
  sound certificate, surfaced with ``central_fallback_reason`` — and the
  central accountant itself is DISABLED (with the reason) when secure
  aggregation is off.
* Selection is fixed-size sampling without replacement; the bound assumes
  Poisson sampling at the same expected rate, the standard approximation in
  DP-FedAvg implementations.

The accountant is stepped once per FLUSH by the round engine (one dispatch
= one mechanism invocation; in semi-sync pacing each ``RoundEngine.step``
call dispatches one cohort and flushes once, so the composition count is
the number of dispatched rounds either way) and surfaced as
``FLResult.eps_history`` / ``FLResult.privacy``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import PrivacyConfig, TransformConfig

# Integer RDP orders: dense where the subsampled-Gaussian optimum usually
# lands, sparse tail for tiny q / huge T.
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 65)) + (96, 128, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_sampled_gaussian(q: float, noise_multiplier: float,
                         order: int) -> float:
    """Renyi DP of ONE subsampled Gaussian release at an integer order.

    ``q``: sampling rate in (0, 1]; ``noise_multiplier``: z = sigma / C;
    ``order``: integer Renyi order >= 2.  Evaluated with the exact integer-
    order binomial expansion in log space.
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling rate q must be in (0, 1], got {q}")
    if noise_multiplier <= 0.0:
        return math.inf
    if order < 2 or order != int(order):
        raise ValueError(f"order must be an integer >= 2, got {order}")
    a, z = int(order), float(noise_multiplier)
    if q == 1.0:
        return a / (2.0 * z * z)
    log_terms = [
        _log_comb(a, k)
        + (a - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + k * (k - 1) / (2.0 * z * z)
        for k in range(a + 1)
    ]
    m = max(log_terms)
    log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return log_sum / (a - 1)


def eps_from_rdp(rdp: Sequence[float], orders: Sequence[int],
                 delta: float) -> float:
    """Best (smallest) epsilon over the order grid at target ``delta``,
    via the improved RDP -> (eps, delta) conversion (CKS 2020)."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    best = math.inf
    for r, a in zip(rdp, orders):
        if not math.isfinite(r):
            continue
        eps = (r + math.log1p(-1.0 / a)
               - (math.log(delta) + math.log(a)) / (a - 1))
        best = min(best, eps)
    return max(best, 0.0)


class PrivacyAccountant:
    """Running (epsilon, delta) over composed rounds of the subsampled
    Gaussian mechanism.

    Per-order per-round RDP is precomputed once; ``step`` is O(1) and
    ``epsilon`` is O(|orders|), so per-round surfacing costs nothing.
    ``active`` is False when the mechanism certifies nothing (no noise, or
    unbounded sensitivity) — then ``epsilon`` is ``inf``, ``step`` still
    counts rounds, and ``report`` says why.
    """

    def __init__(self, noise_multiplier: float, sample_rate: float,
                 delta: float = 1e-5,
                 orders: Sequence[int] = DEFAULT_ORDERS,
                 disabled_reason: Optional[str] = None,
                 mode: str = "per-client",
                 base_noise_multiplier: Optional[float] = None,
                 cohort: Optional[int] = None):
        self.noise_multiplier = float(noise_multiplier)
        self.sample_rate = float(sample_rate)
        self.mode = mode
        self.delta = float(delta)
        self.orders = tuple(int(o) for o in orders)
        self.rounds = 0
        # central-mode cohort tracking: z_eff = base * sqrt(cohort), shrunk
        # by observe_cohort to the smallest cohort whose noise a released
        # sum actually carried (churn re-keys fold survivor-only sums)
        self.base_noise_multiplier = (None if base_noise_multiplier is None
                                      else float(base_noise_multiplier))
        self.cohort = None if cohort is None else int(cohort)
        self.central_fallback_reason: Optional[str] = None
        self.active = (disabled_reason is None and noise_multiplier > 0.0)
        self.disabled_reason = disabled_reason if not self.active else None
        if self.active:
            self._recompute()
        else:
            if self.disabled_reason is None:
                self.disabled_reason = "noise_multiplier is 0"
            self._rdp_per_round = np.full(len(self.orders), math.inf)

    def _recompute(self) -> None:
        self._rdp_per_round = np.asarray(
            [rdp_sampled_gaussian(self.sample_rate, self.noise_multiplier, a)
             for a in self.orders])

    def step(self, n: int = 1) -> None:
        """Compose ``n`` further rounds (one per dispatch/flush)."""
        self.rounds += int(n)

    def observe_cohort(self, survivors: int) -> None:
        """Central mode only: a released (or about-to-fold) sum carries the
        noise draws of only ``survivors`` cohort members — a short dispatch,
        or a churn re-key that subtracted dropped uploads.  The accountant
        keeps the MINIMUM cohort observed and re-prices EVERY composed
        round at ``z_eff = z * sqrt(min cohort)``: retroactively
        conservative, since each released sum carried at least that many
        draws.  No-op for per-client accountants (their multiplier never
        depended on the cohort) and for non-shrinking observations."""
        if self.base_noise_multiplier is None or self.cohort is None:
            return
        c = max(1, int(survivors))
        if c >= self.cohort or not self.active:
            return
        self.cohort = c
        self.noise_multiplier = self.base_noise_multiplier * math.sqrt(c)
        self._recompute()

    def state_dict(self) -> Dict[str, int]:
        """The accountant's mutable state (JSON-serializable) — the
        composition count, plus the min observed cohort in central mode;
        everything else is rebuilt from the configs on resume
        (``checkpoint``/``fedavg.run_federated_training``)."""
        state = {"rounds": int(self.rounds)}
        if self.cohort is not None:
            state["cohort"] = int(self.cohort)
        return state

    def load_state(self, state: Dict[str, int]) -> None:
        self.rounds = int(state["rounds"])
        if self.cohort is not None and "cohort" in state:
            c = int(state["cohort"])
            if c != self.cohort and self.active:
                self.cohort = c
                self.noise_multiplier = (self.base_noise_multiplier
                                         * math.sqrt(c))
                self._recompute()
            else:
                self.cohort = c

    @property
    def total_rdp(self) -> np.ndarray:
        """Composed RDP per order after ``rounds`` rounds."""
        return self.rounds * self._rdp_per_round

    def epsilon(self) -> float:
        """Current epsilon at the target delta: 0 before any round has
        composed, ``inf`` when the accountant is disabled."""
        if not self.active:
            return math.inf
        if self.rounds == 0:
            return 0.0
        return eps_from_rdp(self.total_rdp, self.orders, self.delta)

    def report(self) -> Dict[str, float]:
        """One-line-able summary for drivers / FLResult.privacy."""
        return {
            "enabled": self.active,
            "epsilon": self.epsilon(),
            "delta": self.delta,
            "rounds": self.rounds,
            "noise_multiplier": self.noise_multiplier,
            "sample_rate": self.sample_rate,
            "mode": self.mode,
            **({"cohort": self.cohort} if self.cohort is not None else {}),
            **({"central_fallback_reason": self.central_fallback_reason}
               if self.central_fallback_reason else {}),
            **({"disabled_reason": self.disabled_reason}
               if not self.active else {}),
        }


def make_accountant(tcfg: TransformConfig, pcfg: PrivacyConfig,
                    sample_rate: float) -> PrivacyAccountant:
    """Accountant for one training run: the clip + noise knobs define
    the per-round mechanism, ``sample_rate ~= dispatch_m / n_members`` its
    subsampling.  Noise without a clip bound (or no noise at all) yields a
    DISABLED accountant that reports ``epsilon = inf`` with the reason,
    instead of certifying something the mechanism does not provide.
    """
    q = min(max(float(sample_rate), 0.0), 1.0)
    orders = pcfg.orders or DEFAULT_ORDERS
    if tcfg.noise_multiplier <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders,
                                 disabled_reason="dp_noise is 0 (no "
                                                 "Gaussian mechanism)")
    if tcfg.clip_norm <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders,
                                 disabled_reason="dp_clip is 0 (unbounded "
                                                 "sensitivity)")
    if q <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders,
                                 disabled_reason="sampling rate is 0")
    return PrivacyAccountant(tcfg.noise_multiplier, q, pcfg.delta, orders)


def central_gate_reason(ring: bool, weighted: bool) -> Optional[str]:
    """Why ``central:secure-agg`` accounting may NOT price the masked sum.

    The aggregate-Gaussian argument (``z_eff = z*sqrt(m)``) needs BOTH:
    (a) the server's view to be ONLY the cohort sum — true for RING
    masking (uniform integer masks over the full ring are information-
    theoretically hiding), NOT for float masking, whose finite-sigma
    Gaussian masks leak beyond the sum; and (b) UNIFORM aggregation — a
    weighted sum scales client ``i``'s sensitivity by ``frac_i`` while the
    aggregate noise std is ``z*C*sqrt(sum frac^2)``, so a heavy client's
    effective multiplier approaches the per-client ``z``, not
    ``z*sqrt(m)``.  Returns the blocking reason (the engine then falls
    back to sound per-client accounting), or None when central mode
    applies.
    """
    if not ring:
        return ("float masking (finite mask_std) is not information-"
                "theoretically hiding, so the server's view is more than "
                "the cohort sum; per-client accounting applies instead")
    if weighted:
        return ("weighted aggregation: a heavy client's effective noise "
                "multiplier approaches z, not z*sqrt(m); per-client "
                "accounting applies instead")
    return None


def secure_agg_accountant(tcfg: TransformConfig, pcfg: PrivacyConfig,
                          sample_rate: float, secure_enabled: bool,
                          cohort: int, *, ring: bool = True,
                          weighted: bool = False,
                          weights=None) -> PrivacyAccountant:
    """Central-DP accountant for the MASKED SUM (mode ``central:secure-agg``).

    With RING masking on and UNIFORM aggregation, the server never observes
    an individual upload — only the aggregate, carrying the sum of
    ``cohort`` independent per-client Gaussian draws: noise std
    ``z*C*sqrt(cohort)`` against the one-client sensitivity ``C``, so the
    composed mechanism is a subsampled Gaussian with the effective
    multiplier ``z_eff = z*sqrt(cohort)`` — strictly tighter than the
    per-client ``z`` for any cohort > 1.  The returned accountant tracks
    the cohort (``observe_cohort``): under churn the engine shrinks it to
    the smallest surviving fold, retroactively re-pricing the run.

    When the premise fails the accountant is DISABLED with the reason
    instead of certifying a guarantee the protocol does not provide:
    masking off (no masked sum exists), ``ring=False`` (float Gaussian
    masks are not information-theoretically hiding), or ``weighted=True``
    without a concrete weight vector.  For a FIXED, known weight vector
    pass ``weights``: the exact weighted-sum multiplier
    ``z_eff = z * sqrt(sum frac_i^2) / max_i frac_i`` applies (equal to
    ``z*sqrt(m)`` for uniform weights, approaching ``z`` as one client
    dominates) — with no cohort shrink tracking, since the formula is tied
    to that exact vector.
    """
    q = min(max(float(sample_rate), 0.0), 1.0)
    orders = pcfg.orders or DEFAULT_ORDERS
    mode = "central:secure-agg"
    if not secure_enabled:
        return PrivacyAccountant(
            0.0, q, pcfg.delta, orders, mode=mode,
            disabled_reason="secure aggregation is off (no masked sum to "
                            "account centrally; per-client accounting "
                            "applies instead)")
    gate = central_gate_reason(ring, weighted and weights is None)
    if gate is not None:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                 disabled_reason=gate)
    if tcfg.noise_multiplier <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                 disabled_reason="dp_noise is 0 (no "
                                                 "Gaussian mechanism)")
    if tcfg.clip_norm <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                 disabled_reason="dp_clip is 0 (unbounded "
                                                 "sensitivity)")
    if q <= 0.0:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                 disabled_reason="sampling rate is 0")
    if weights is not None:
        w = np.asarray(weights, np.float64)
        w = w[w > 0]
        if w.size == 0:
            return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                     disabled_reason="empty dispatch cohort")
        frac = w / w.sum()
        z_eff = (tcfg.noise_multiplier
                 * math.sqrt(float(np.sum(frac * frac)))
                 / float(frac.max()))
        return PrivacyAccountant(z_eff, q, pcfg.delta, orders, mode=mode)
    if cohort < 1:
        return PrivacyAccountant(0.0, q, pcfg.delta, orders, mode=mode,
                                 disabled_reason="empty dispatch cohort")
    z_eff = tcfg.noise_multiplier * math.sqrt(cohort)
    return PrivacyAccountant(z_eff, q, pcfg.delta, orders, mode=mode,
                             base_noise_multiplier=tcfg.noise_multiplier,
                             cohort=cohort)


def format_report(report: Dict[str, float]) -> str:
    """Human-readable accountant line for the drivers/bench."""
    mode = report.get("mode", "per-client")
    if not report["enabled"]:
        return (f"privacy [{mode}]: accounting disabled — "
                f"{report['disabled_reason']}"
                " (set --dp-clip and --dp-noise to certify a guarantee)")
    cohort = (f", cohort={report['cohort']}" if "cohort" in report else "")
    return (f"privacy [{mode}]: (eps={report['epsilon']:.2f}, "
            f"delta={report['delta']:.0e}) after {report['rounds']} rounds "
            f"(z_eff={report['noise_multiplier']:.3g}, "
            f"q={report['sample_rate']:.3g}{cohort})")
