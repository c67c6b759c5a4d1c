"""Shared building blocks: dense init, RMS and layer norm, RoPE, the SwiGLU
MLP (its hidden constrained to ``act_ff``) and token embeddings; the
counterpart of
``src/repro/models/layers.py``.  Also the numpy -> tensor conversion of
parameter trees made by the JAX package, ``tree_map`` / ``tree_leaves``
over such trees, and ``seeded_generator``, the port's counterpart of a
``jax.random`` key split by stream.

Init draws from an explicit ``torch.Generator`` on the generator's own
device: a CPU generator gives the same weights whichever device they are
later moved to, a CUDA generator draws full-width models on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.sharding import constrain
from repro_torch.sharding.rules import (all_reduce, last_dim_split,
                                        matmul, replicated)


def seeded_generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded injectively from (seed, *stream)."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(2)
    # flcheck: disable=FLC003 (packs SeedSequence's two 32-bit output words into one 64-bit seed; the mixing of seed and stream ids is SeedSequence's, injective)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def dense_init(generator: torch.Generator, in_dim, out_dim, scale=None,
               dtype=torch.float32):
    """(in_dim, out_dim) normal weights times ``scale`` (default
    ``in_dim ** -0.5``), drawn in fp32 on ``generator``'s device."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(dtype)


def rms_norm(x, scale, eps=1e-5):
    """RMS norm over the last axis, computed in fp32, cast back to x's
    dtype.  On a DTensor whose last dim is split, each rank normalizes its
    block (:class:`_SplitNorm`)."""
    dt = x.dtype
    x, groups = last_dim_split(x.float())
    if groups:
        x = _split_norm(x, groups, eps, centre=False)
    else:
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x, scale, bias, eps=1e-5):
    """Layer norm over the last axis (biased variance), computed in fp32,
    cast back to x's dtype; a split last dim as :func:`rms_norm`."""
    dt = x.dtype
    x, groups = last_dim_split(x.float())
    if groups:
        y = _split_norm(x, groups, eps, centre=True)
    else:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def _split_norm(x, groups, eps, centre):
    """``x`` (a DTensor split over its last dim by ``groups``) normalized
    over the whole of that dim, laid out as it came."""
    y = _SplitNorm.apply(x.to_local(), x.shape[-1], eps, centre, groups)
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class _SplitNorm(torch.autograd.Function):
    """A block (..., d_local) of a last dim d split over ``groups``,
    normalized with the statistics of the whole of d: each statistic is
    the block's mean scaled by its share d_local / d and summed over the
    ranks by one all-reduce of a (..., 1) tensor ("norm_stats"); the
    backward's two means of d likewise.  With one rank the share is 1.0
    and the all-reduce the identity, so the arithmetic is the plain
    norm's.  ``centre``: layer norm (the mean taken out first), else RMS
    norm."""

    @staticmethod
    def forward(ctx, x, d, eps, centre, groups):
        share = x.shape[-1] / d

        def mean(t):
            return all_reduce(torch.mean(t, dim=-1, keepdim=True) * share,
                              "sum", groups, "norm_stats")
        if centre:
            x = x - mean(x)
            r = torch.rsqrt(mean(x ** 2) + eps)
        else:
            r = torch.rsqrt(mean(x * x) + eps)
        y = x * r
        ctx.save_for_backward(y, r)
        ctx.share, ctx.centre, ctx.groups = share, centre, groups
        return y

    @staticmethod
    def backward(ctx, g):
        # y = x_c r:  dx = r (g - [mean(g)] - y mean(g y)), means over d
        y, r = ctx.saved_tensors
        terms = [g, g * y] if ctx.centre else [g * y]
        means = all_reduce(torch.cat(
            [torch.mean(t, dim=-1, keepdim=True) for t in terms], dim=-1)
            * ctx.share, "sum", ctx.groups, "norm_stats")
        dx = g - y * means[..., -1:]
        if ctx.centre:
            dx = dx - means[..., :1]
        return dx * r, None, None, None, None


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers.  Half-split
    layout: ``concat[x1 cos - x2 sin, x1 sin + x2 cos]``, in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP
def init_mlp(generator: torch.Generator, d_model, d_ff,
             dtype=torch.float32):
    return {
        "w_in": dense_init(generator, d_model, d_ff, dtype=dtype),
        "w_gate": dense_init(generator, d_model, d_ff, dtype=dtype),
        "w_out": dense_init(generator, d_ff, d_model, scale=d_ff ** -0.5,
                            dtype=dtype),
    }


def mlp(params, x):
    """SwiGLU MLP, silu on the gate. x: (..., d)."""
    h = matmul(x, params["w_in"].to(x.dtype))
    g = matmul(x, params["w_gate"].to(x.dtype))
    h = constrain(h * F.silu(g), "batch", None, "act_ff")
    return matmul(h, params["w_out"].to(x.dtype))


# ------------------------------------------------------------------ embeddings
def init_embedding(generator: torch.Generator, vocab, d_model,
                   dtype=torch.float32):
    return (torch.randn((vocab, d_model), generator=generator,
                        dtype=torch.float32, device=generator.device)
            * 0.02).to(dtype)


def embed(embed_tokens, tokens, dtype):
    """Rows ``tokens`` of the table cast to ``dtype`` (cast, then gather;
    the cast is free when the table is already in ``dtype``).  A sharded
    table is gathered whole first, as FSDP gathers a weight before its
    use (DTensor's vocab-sharded lookup cannot be redistributed to the
    batch-sharded residual stream)."""
    return F.embedding(tokens, replicated(embed_tokens).to(dtype))


# --------------------------------------------------- numpy -> port trees
def tree_from_numpy(tree, device="cpu"):
    """A tree of dicts and lists of numpy arrays (e.g. ``jax.tree.map(
    np.asarray, params)``) -> the same tree of tensors on ``device``,
    layouts and dtypes unchanged (tensor leaves are moved there).  bfloat16 arrays (numpy has no native
    bfloat16) cross as a 16-bit view."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists (and of ``rest``,
    trees of the same structure), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a tree of dicts and lists, in :func:`tree_map`'s
    order."""
    out = []
    tree_map(out.append, tree)
    return out


def sorted_leaves(tree):
    """The leaves of a tree of dicts and lists in ``jax.tree.flatten``'s
    order (dict keys sorted), the order the JAX package hands per-leaf
    PRNG keys out in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def unflatten_sorted(like, leaves):
    """Inverse of :func:`sorted_leaves`: ``leaves`` placed into the
    structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)

