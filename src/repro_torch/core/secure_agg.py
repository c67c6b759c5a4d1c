"""Secure aggregation by pairwise masking (``SecureAggConfig``): the
counterpart of ``src/repro/core/secure_agg.py``.

Every pair of clients ``(i, j)`` of a dispatch cohort derives a SHARED mask
from the cohort's round key; ``min(i, j)`` adds it and ``max(i, j)``
subtracts it, so each upload is individually noise while the masks cancel
in the aggregator's sum (Bonawitz et al., "Practical Secure Aggregation").

    float path:  y_i = w_i * T(delta_i) + sum_{j != i} sign(i,j) N(key_ij)
    ring path:   y_i = wrap_b( q_i      + sum_{j != i} sign(i,j) U(key_ij) )

On the ring path (the stack carries the ring quantizer, forced on whenever
masking and quantization are both on) ``q_i`` is the client's integer
grid value, the pair masks are uniform over ``[0, 2^b)`` and every masked
coordinate is reduced into the centered ring, so a single upload is
uniform over the ring and the unmasked sum comes back bit for bit.  Without
a quantizer the masks are Gaussian with scale ``mask_std`` on the weighted
float upload, and cancel up to float rounding.

Pairs are gated on both ends having ``w > 0`` and weight-0 slots (padding
duplicates) upload zero.  The pair key is ``fold_in(fold_in(fold_in(
round_key, _PAIR_DOMAIN), lo), hi)`` and the per-leaf draws come from
``split(pair_key, n_leaves)``, the JAX package's keys bit for bit
(``core/prng.py``), so the port's masks are the reference's.

The JAX package scans all M slots for every client (each pair drawn
twice, once at each end).  Here a draw depends only on ``(lo, hi)``, so
each real pair is drawn once, in chunks that bound the temporaries, and
lands with ``+1`` at ``lo`` and ``-1`` at ``hi`` through one product with
a (pairs, M) sign matrix.  On the ring path the masks are integers whose
sums stay below 2^24, so the order of the sum does not change a bit; on
the float path it does (``tests/test_torch_privacy.py`` states the bound).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch

from repro_torch.configs.base import SecureAggConfig
from repro_torch.core import prng
from repro_torch.core import transforms as transforms_mod
from repro_torch.models.layers import sorted_leaves, unflatten_sorted

# domain-separation tag folded into the shared round key before the pair
# indices: pair keys never collide with the per-client transform keys
_PAIR_DOMAIN = 0x5EC0A6
# domain-separation tag for cohort RE-KEYS (dropout recovery): generation
# g > 0 of a cohort's shared key is fold_in(fold_in(base, _REKEY_DOMAIN), g)
_REKEY_DOMAIN = 0x2EC0DE
# pair draws per chunk (pairs x coordinates of one leaf): bounds the
# int64 temporaries of the PRNG to a few hundred MB
_CHUNK_DRAWS = 1 << 23


class CohortContext(NamedTuple):
    """The dispatch cohort as the stacked clients see it.

    ``slot``: (M,) long tensor, each stacked client's dispatch slot in the
    cohort.  ``weights``: the cohort's (Mc,) aggregation weights (public).
    ``round_key``: the cohort's shared key (``RoundEngine.base_round_key``),
    a Python key or a (2,) tensor.
    """
    slot: torch.Tensor
    weights: torch.Tensor
    round_key: prng.Key


@dataclasses.dataclass(frozen=True)
class PairwiseMasker:
    """Cohort-aware transform: add the antisymmetric pairwise masks.

    ``bits = 0`` is the float path (Gaussian draws scaled ``mask_std``,
    added to the weighted contribution ``w_i * delta_i``); ``bits = b > 0``
    the ring path (draws uniform over ``[0, 2^b)``, added to the ring
    quantizer's integers and wrapped into the centered ring).
    """
    mask_std: float = 1.0
    bits: int = 0                      # 0 = float masks; b = ring mod 2^b
    tag: ClassVar[int] = 3             # stable PRNG stream id (stack slot)
    needs_cohort: ClassVar[bool] = True
    is_masker: ClassVar[bool] = True   # stack predicate (pre-weighted sums)

    def cohort_masks(self, like, weights: torch.Tensor, round_key):
        """The total mask of every cohort slot: a list of (Mc, *leaf)
        tensors in ``sorted_leaves`` order, ``like`` a client-stacked tree
        giving the leaf shapes."""
        leaves = sorted_leaves(like)
        dev = weights.device
        mc = weights.shape[0]
        real = torch.nonzero(weights > 0).flatten()
        lo, hi = torch.triu_indices(real.numel(), real.numel(), 1,
                                    device=dev)
        lo, hi = real[lo], real[hi]
        base = prng.fold_in(round_key, _PAIR_DOMAIN)
        masks = [torch.zeros((mc,) + x.shape[1:], dtype=x.dtype, device=dev)
                 for x in leaves]
        if lo.numel() == 0:
            return masks
        ring = self.bits > 0
        width = max(x[0].numel() for x in leaves)
        step = max(1, _CHUNK_DRAWS // width)
        for s in range(0, lo.numel(), step):
            plo, phi = lo[s:s + step], hi[s:s + step]
            pair_keys = prng.fold_in(prng.fold_in(base, plo), phi)
            ks = prng.split(pair_keys, len(leaves))
            # (pairs, Mc): +1 at the low slot, -1 at the high one
            sign = torch.zeros((plo.numel(), mc), dtype=torch.float32,
                               device=dev)
            rows = torch.arange(plo.numel(), device=dev)
            sign[rows, plo] = 1.0
            sign[rows, phi] = -1.0
            for i, x in enumerate(leaves):
                shape = x.shape[1:]
                if ring:
                    d = prng.randint(ks[:, i], shape, 0, 2 ** self.bits)
                    d = d.to(x.dtype)
                else:
                    d = self.mask_std * prng.normal(ks[:, i], shape)
                masks[i] += (sign.T @ d.reshape(d.shape[0], -1)
                             ).reshape(masks[i].shape)
        return masks

    def __call__(self, delta, keys, ctx: CohortContext):
        del keys                       # masks come from the SHARED round key
        w = ctx.weights
        masks = self.cohort_masks(delta, w, ctx.round_key)
        real = (w[ctx.slot] > 0).to(torch.float32)
        wi = w[ctx.slot]
        out = []
        for x, mk in zip(sorted_leaves(delta), masks):
            mk = mk[ctx.slot]
            r = transforms_mod._per_client(real, x)
            if self.bits > 0:
                # integer grid (already carries w_i / W): uniform masks and
                # the wrap make each coordinate uniform over the ring
                out.append(r * transforms_mod.ring_wrap(x + mk, self.bits))
            else:
                # weighted-contribution masking: mask w_i * delta_i
                out.append(r * (transforms_mod._per_client(wi, x) * x + mk))
        return unflatten_sorted(delta, out)


def mask_contribution(masker: PairwiseMasker, like, slot, weights,
                      round_key):
    """The mask-ONLY term of slot ``slot``'s masked upload: the masker on a
    zero delta, ``real_i * sum_j sign * draw(key_ij)`` (ring-wrapped on the
    ring path), for cohort weights ``weights`` under ``round_key``.  The
    algebraic basis of Bonawitz-style re-keying: subtracting it replays the
    original masking's draws exactly.  ``like``: ONE client's tree (shapes
    and dtypes); returns a tree of that shape.  ``slot`` may also be a 1-D
    sequence of slots: their trees come back stacked (leading axis = the
    slots), each equal to its own call, from one draw of the cohort's
    masks."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    dev = weights.device
    slots = torch.as_tensor(slot, device=dev).reshape(-1).long()
    zeros = {"t": [torch.zeros((slots.numel(),) + tuple(x.shape),
                               dtype=x.dtype, device=dev)
                   for x in sorted_leaves(like)]}
    out = masker(zeros, None, CohortContext(slots, weights, round_key))
    if torch.as_tensor(slot).dim():
        return unflatten_sorted(like, out["t"])
    return unflatten_sorted(like, [x[0] for x in out["t"]])


def make_masker(cfg: SecureAggConfig, ring_bits: int = 0) -> PairwiseMasker:
    """The pairwise-masking stage a ``SecureAggConfig`` asks for;
    ``ring_bits`` (set by ``transforms.make_stack`` when the stack carries
    the ring quantizer) selects ring masking mod ``2^ring_bits``."""
    if not cfg.enabled:
        raise ValueError("make_masker called with secure aggregation "
                         "disabled (SecureAggConfig.enabled=False)")
    return PairwiseMasker(mask_std=cfg.mask_std, bits=int(ring_bits))
