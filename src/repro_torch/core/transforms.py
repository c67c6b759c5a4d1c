"""Delta-transform stage of the federated pipeline (select -> local-update ->
**transform(deltas)** -> aggregate -> server-update): the counterpart of
``src/repro/core/transforms.py``.

Each transform takes a CLIENT-STACKED delta tree (a leading client axis M
on every leaf: ``w_i - w_global`` of each selected client) and one PRNG
key per client (``core/prng.py``, an ``int64`` tensor ``(M, 2)``), and
transforms all M clients at once; the JAX package vmaps the same math over
one client at a time.  Keys, sub-keys and draws are the JAX package's bit
for bit (``core/prng.py``), so the same seed gives the same DP noise and
the same stochastic rounding.

Knobs (``TransformConfig``): ``clip_norm`` C, the per-client L2 clip
``delta * min(1, C / ||delta||_2)``; ``noise_multiplier`` z, Gaussian noise
``N(0, (z*C)^2)`` per coordinate (C falls back to 1 without clipping);
``quantize_bits`` b, unbiased stochastic b-bit quantization with a per-leaf
max-abs scale (adaptive), or onto one public grid shared by the cohort
(``quantize_ring``, forced on by secure aggregation): the ring quantizer
grids each client's weighted share ``(w_i / W) * delta_i`` onto
``s = sensitivity / levels`` with ``levels = floor((2^(b-1) - 1 - M) /
(1 + 4z))`` and returns the integers themselves, which the aggregator sums
unweighted, wraps into the ring and rescales (``fedavg``).  Pairwise
masking (``core/secure_agg.py``) comes last.

The stack runs clip -> noise -> quantize -> mask; each stage draws from
``fold_in(fold_in(key, tag), occurrence)`` with its stable ``tag``, so
turning one stage off never shifts another stage's stream.

Operations keep the reference's order (``floor(frac * x / scale + u)``,
``max|x| / levels``, ``finfo(float32).tiny``), as the JAX package runs them
op by op.  Under ``jax.jit`` XLA turns a division by a constant into a
product with its float32 reciprocal; the port keeps the division.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Protocol, Tuple

import torch

from repro_torch.analysis import taint
from repro_torch.configs.base import SecureAggConfig, TransformConfig
from repro_torch.core import prng
from repro_torch.models.layers import sorted_leaves, unflatten_sorted

_TINY = torch.finfo(torch.float32).tiny


class DeltaTransform(Protocol):
    """One delta transform: ``(client-stacked delta tree, (M, 2) keys) ->
    delta tree`` (cohort-aware stages also take the ``CohortContext``).
    ``tag`` is the transform's STABLE key-derivation id (see
    :class:`TransformStack`): unique per transform kind, never reused."""

    tag: ClassVar[int]

    def __call__(self, delta, keys): ...


def _per_client(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (M,) vector shaped to broadcast over the leaf ``x`` (M, ...)."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device (CUDA turns a division
    by a Python scalar into a product with its reciprocal)."""
    return x / x.new_full((), c)


def global_l2_norm(tree) -> torch.Tensor:
    """L2 norm over ALL leaves of each client's delta: (M,)."""
    return torch.sqrt(sum(torch.square(x.float()).flatten(1).sum(1)
                          for x in sorted_leaves(tree)))


# ------------------------------------------------------------ ring helpers
# Noise-tail margin of the shared ring grid, in per-coordinate noise
# standard deviations: a noised contribution is kept un-truncated out to
# this many sigma (residual clipped mass 2*Phi(-4) ~ 6e-5 per coordinate).
RING_NOISE_TAIL_SIGMAS: float = 4.0


def ring_levels(bits: int, cohort: int, noise_headroom: float = 0.0) -> int:
    """Grid levels of the shared ring quantizer:
    ``floor((2^(bits-1) - 1 - M) / (1 + noise_headroom))``.  The ``M``
    reserved steps are stochastic-rounding headroom (each member can
    overshoot its share by one step); ``noise_headroom`` reserves the
    noise tail, so the cohort's integer sum stays inside the ring and the
    decode never aliases."""
    levels = int((2 ** (bits - 1) - 1 - int(cohort))
                 / (1.0 + float(noise_headroom)))
    if levels < 1:
        raise ValueError(
            f"dispatch cohort of {cohort} does not fit the int{bits} ring "
            f"with noise headroom {float(noise_headroom):.3g}: need "
            f"(2^{bits - 1} - 1 - cohort) / (1 + headroom) >= 1 — widen "
            "the quantize bits or lower dp_noise")
    return levels


def ring_scale(bits: int, sensitivity: float, cohort: int,
               noise_headroom: float = 0.0) -> float:
    """Public grid step of the shared ring quantizer (one float for the
    whole cohort)."""
    return float(sensitivity) / ring_levels(bits, cohort, noise_headroom)


def ring_wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Reduce integer-valued ``x`` into the centered ring
    ``[-2^(bits-1), 2^(bits-1) - 1]`` (mod ``2^bits``; the remainder takes
    the divisor's sign, as ``jnp.mod`` does).  Exact for float32-encoded
    integers below 2^24."""
    half = float(2 ** (bits - 1))
    return torch.remainder(x + half, float(2 ** bits)) - half


@dataclasses.dataclass(frozen=True)
class L2Clip:
    """Scale each client's whole delta so its global L2 norm is at most
    ``clip_norm``."""
    clip_norm: float
    tag: ClassVar[int] = 0             # stable PRNG stream id (no randomness)

    def __call__(self, delta, keys):
        norm = global_l2_norm(delta)
        c = torch.full_like(norm, self.clip_norm)
        factor = torch.clamp_max(c / torch.clamp_min(norm, 1e-12), 1.0)
        # taint marker (production no-op): this stage's flcheck label
        return taint.declassify(unflatten_sorted(
            delta, [x * _per_client(factor, x)
                    for x in sorted_leaves(delta)]), "clip")


@dataclasses.dataclass(frozen=True)
class GaussianNoise:
    """Add per-coordinate ``N(0, sigma^2)`` noise (Gaussian mechanism)."""
    sigma: float
    tag: ClassVar[int] = 1             # stable PRNG stream id

    def __call__(self, delta, keys):
        leaves = sorted_leaves(delta)
        ks = prng.split(keys, len(leaves))      # (M, n_leaves, 2)
        return taint.declassify(unflatten_sorted(delta, [
            x + self.sigma * prng.normal(ks[:, i], x.shape[1:])
            for i, x in enumerate(leaves)]), "noise")


@dataclasses.dataclass(frozen=True)
class StochasticQuantize:
    """Unbiased ``bits``-bit integer quantization, two grids.

    *Adaptive* (``ring=False``): each client's leaf is scaled by
    ``max|x| / (2^(bits-1) - 1)``, stochastically rounded
    (``floor(x/s + u)``), clipped to the signed grid and dequantized.

    *Ring* (``ring=True``, cohort-aware): each client grids its weighted
    share ``(w_i / W) * x`` onto the public step ``sensitivity / levels``
    and returns the integers, clipped to ``floor((w_i/W) * levels * (1 +
    noise_headroom)) + 1``.
    """
    bits: int = 8
    ring: bool = False
    sensitivity: float = 1.0           # ring grid bound (clip norm, or 1)
    noise_headroom: float = 0.0        # ring noise-tail margin (k * z)
    tag: ClassVar[int] = 2             # stable PRNG stream id

    @property
    def needs_cohort(self) -> bool:
        return self.ring               # ring grid needs (slot, weights)

    def __call__(self, delta, keys, ctx=None):
        leaves = sorted_leaves(delta)
        ks = prng.split(keys, len(leaves))      # (M, n_leaves, 2)
        out = []
        if self.ring:
            w = ctx.weights
            levels = ring_levels(self.bits, w.shape[0], self.noise_headroom)
            scale = self.sensitivity / levels
            frac = w[ctx.slot] / torch.clamp_min(w.sum(), 1e-30)
            cap = float(levels) * (1.0 + self.noise_headroom)
            qmax = torch.floor(frac * cap) + 1.0
            for i, x in enumerate(leaves):
                u = prng.uniform(ks[:, i], x.shape[1:])
                f, qm = _per_client(frac, x), _per_client(qmax, x)
                q = torch.floor(_div(f * x, scale) + u)
                out.append(torch.minimum(torch.maximum(q, -qm), qm)
                           .to(x.dtype))
        else:
            levels = float(2 ** (self.bits - 1) - 1)   # int8 -> 127
            for i, x in enumerate(leaves):
                sc = _div(x.abs().flatten(1).amax(1), levels)
                safe = _per_client(torch.clamp_min(sc, _TINY), x)
                u = prng.uniform(ks[:, i], x.shape[1:])
                q = torch.clamp(torch.floor(x / safe + u), -levels, levels)
                out.append((q * safe).to(x.dtype))
        # taint marker (production no-op).  The wire declaration is what
        # the level-3 cost auditor reads off the boundary: these values
        # STAND FOR an int<bits> grid plus one fp32 scale a leaf on the
        # real uplink (adaptive: dequantized floats; ring: the integers)
        return taint.declassify(unflatten_sorted(delta, out), "quantize",
                                wire=f"int{self.bits}+scale")


@dataclasses.dataclass(frozen=True)
class TransformStack:
    """Ordered composition of delta transforms.

    Each stage draws from ``fold_in(fold_in(key, t.tag), occurrence)`` of
    every client's key, by the stage's STABLE tag, not its position, so a
    DP-noise draw is the same bits with or without the stages around it.
    Cohort-aware stages (the ring quantizer, the masker) also take the
    :class:`~repro_torch.core.secure_agg.CohortContext`; calling a stack
    that holds one without it raises, so a secure-agg stack can never
    silently run unmasked.
    """
    transforms: Tuple = ()

    @property
    def is_identity(self) -> bool:
        return not self.transforms

    @property
    def needs_cohort(self) -> bool:
        """True when any stage needs the dispatch-cohort context."""
        return any(getattr(t, "needs_cohort", False) for t in self.transforms)

    @property
    def ring_spec(self):
        """``(bits, sensitivity, noise_headroom)`` of the ring quantizer when
        the stack carries one, else None: the aggregator's signal to decode
        with ``ring_wrap`` / ``ring_scale``."""
        for t in self.transforms:
            if isinstance(t, StochasticQuantize) and t.ring:
                return (t.bits, t.sensitivity, t.noise_headroom)
        return None

    @property
    def pre_weighted(self) -> bool:
        """True when uploads already carry their aggregation weight (the
        ring quantizer folds in ``w_i / W``, the masker ``w_i``), so the
        aggregator sums them UNWEIGHTED."""
        return self.ring_spec is not None or any(
            getattr(t, "is_masker", False) for t in self.transforms)

    def __call__(self, delta, keys, ctx=None):
        """``delta``: client-stacked tree; ``keys``: (M, 2) per-client
        keys."""
        seen: dict = {}
        for t in self.transforms:
            occ = seen.get(t.tag, 0)   # same-kind repeats get fresh streams
            seen[t.tag] = occ + 1
            sub = prng.fold_in(prng.fold_in(keys, t.tag), occ)
            if getattr(t, "needs_cohort", False):
                if ctx is None:
                    raise ValueError(
                        f"{type(t).__name__} needs the dispatch-cohort "
                        "context (slot/weights/round key); call the stack "
                        "with ctx=CohortContext(...)")
                delta = t(delta, sub, ctx)
            else:
                delta = t(delta, sub)
        return delta


def make_stack(cfg: TransformConfig,
               secure: Optional[SecureAggConfig] = None) -> TransformStack:
    """Build the clip -> noise -> quantize -> mask stack selected by a
    ``TransformConfig`` (+ optional ``SecureAggConfig``)."""
    ts = []
    secure_on = secure is not None and secure.enabled
    sensitivity = cfg.clip_norm if cfg.clip_norm > 0.0 else 1.0
    # masking + quantization compose in the quantizer's integer ring: the
    # ring quantizer is forced on so the masks have a grid to be uniform on
    ring = bool(cfg.quantize_bits) and (cfg.quantize_ring or secure_on)
    if cfg.clip_norm > 0.0:
        ts.append(L2Clip(cfg.clip_norm))
    if cfg.noise_multiplier > 0.0:
        ts.append(GaussianNoise(cfg.noise_multiplier * sensitivity))
    if cfg.quantize_bits:
        ts.append(StochasticQuantize(
            cfg.quantize_bits, ring=ring,
            sensitivity=sensitivity if ring else 1.0,
            noise_headroom=(RING_NOISE_TAIL_SIGMAS * cfg.noise_multiplier
                            if ring else 0.0)))
    if secure_on:
        from repro_torch.core import secure_agg
        ts.append(secure_agg.make_masker(
            secure, ring_bits=cfg.quantize_bits if ring else 0))
    return TransformStack(tuple(ts))
