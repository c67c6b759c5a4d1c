"""Mixture-of-Experts FFN, GShard-style capacity dispatch and combine; the
counterpart of ``src/repro/models/moe.py``.

Tokens are flattened into (G, S_g, d) routing groups; each group sends its
tokens to E experts with per-expert capacity C = max(ceil(cf · S_g · k / E),
k).  Top-k routing on an fp32 router with renormalised gates, the GShard
auxiliary load-balance loss, dispatch and combine as one-hot products built
one k-slot at a time (the largest intermediate is (G, S, E, C)), SwiGLU
experts, optional always-on shared experts.  The products are plain torch
``einsum`` / ``matmul``, as the JAX package computes them outside any
Pallas kernel.  The sharding constraints sit at the reference's sites:
groups over the batch axes, the (G, E, C, d) expert buffers with E over the
tensor axis, the shared experts' hidden on ``act_ff``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import local_region, matmul, reshape


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32):
    e = cfg.moe
    d = cfg.d_model
    p = {
        "router": dense_init(generator, d, e.n_experts, scale=d ** -0.5,
                             dtype=torch.float32),       # router in fp32
        "moe_w_in": _expert_init(generator, e.n_experts, d, e.d_ff_expert,
                                 dtype),
        "moe_w_gate": _expert_init(generator, e.n_experts, d, e.d_ff_expert,
                                   dtype),
        "moe_w_out": _expert_init(generator, e.n_experts, e.d_ff_expert, d,
                                  dtype, scale=e.d_ff_expert ** -0.5),
    }
    if e.n_shared_experts:
        ff_sh = e.n_shared_experts * e.d_ff_expert
        p["shared_w_in"] = dense_init(generator, d, ff_sh, dtype=dtype)
        p["shared_w_gate"] = dense_init(generator, d, ff_sh, dtype=dtype)
        p["shared_w_out"] = dense_init(generator, ff_sh, d,
                                       scale=ff_sh ** -0.5, dtype=dtype)
    return p


def _expert_init(generator: torch.Generator, E, d_in, d_out, dtype,
                 scale=None):
    """(E, d_in, d_out) normal weights times ``scale`` (default
    ``d_in ** -0.5``), drawn in fp32 one expert at a time, so the fp32
    transient is one expert's matrix and not the whole stack."""
    scale = scale if scale is not None else d_in ** -0.5
    out = torch.empty((E, d_in, d_out), dtype=dtype, device=generator.device)
    for i in range(E):
        out[i] = torch.randn((d_in, d_out), generator=generator,
                             dtype=torch.float32,
                             device=generator.device) * scale
    return out


def _choose_group(tokens: int, target: int) -> int:
    """Largest divisor of ``tokens`` that is <= target (routing group
    size)."""
    for g in range(target, 0, -1):
        if tokens % g == 0:
            return g
    return 1


def capacity(cfg: MoEConfig, group_size: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * group_size * cfg.top_k
                      / cfg.n_experts))
    return max(c, cfg.top_k)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties in
    index order, as ``jax.lax.top_k`` orders them (``torch.topk`` leaves
    the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w, x32, cfg: MoEConfig) -> Tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """x32: (G, S, d) fp32 -> (gates (G,S,k), experts (G,S,k), aux loss)."""
    logits = local_region(torch.matmul, (x32, router_w),
                          (("moe_group", None, None), (None, None)),
                          ("moe_group", None, None))
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, cfg.top_k)            # (G,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # GShard aux loss: E * sum_e (frac tokens to e) * (mean router prob e)
    E = cfg.n_experts
    top1 = F.one_hot(experts[..., 0], E).float()
    frac = top1.mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return gates, experts, aux


def _positions(experts, E: int, C: int):
    """experts (G,S,k) -> (pos, keep): the place of each (token, k) in its
    expert's buffer, counted over the flattened (s, k) order, and whether
    it is inside the capacity C."""
    G, S, k = experts.shape
    flat = F.one_hot(experts, E).to(torch.int32).reshape(G, S * k, E)
    pos_in_e = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    pos = torch.sum(flat * pos_in_e, dim=-1).reshape(G, S, k)
    return pos, pos < C


def _experts(disp, weights, xg, w_in, w_gate, w_out):
    """Dispatch (G, S, E, C) masks' tokens into expert buffers, the SwiGLU
    experts, and the gate-weighted combine back to (G, S, d)."""
    xe = constrain(torch.einsum("gsec,gsd->gecd", disp, xg),  # (G,E,C,d)
                   "moe_batch", "act_experts", None, None)
    h = torch.einsum("gecd,edf->gecf", xe, w_in)
    g = torch.einsum("gecd,edf->gecf", xe, w_gate)
    h = h * F.silu(g)
    ye = constrain(torch.einsum("gecf,efd->gecd", h, w_out),  # (G,E,C,d)
                   "moe_batch", "act_experts", None, None)
    # combine: gate-weighted scatter back to token order
    return torch.einsum("gsec,gecd->gsd", weights, ye)


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Tokens dropped for capacity get nothing from the routed experts (the
    residual stream and the shared experts still carry them), GShard's
    semantics.
    """
    e = cfg.moe
    B, S, d = x.shape
    tokens = B * S
    gsz = _choose_group(tokens, min(e.group_size, tokens))
    G = tokens // gsz
    xg = constrain(reshape(x, G, gsz, d), "moe_group", None, None)

    gates, experts, aux = _route(params["router"], xg.float(), e)
    C = capacity(e, gsz)
    E = e.n_experts
    pos, keep = _positions(experts, E, C)
    gates_k = gates * keep.to(gates.dtype)

    # dispatch / combine masks, one k-slot at a time; a slot past the
    # capacity has an all-zero row, as jax.nn.one_hot gives out of range
    disp = torch.zeros((G, gsz, E, C), dtype=x.dtype, device=x.device)
    weights = torch.zeros_like(disp)
    for kk in range(e.top_k):
        oh = (F.one_hot(experts[..., kk], E).to(x.dtype)[..., None]
              * F.one_hot(pos[..., kk].clamp(max=C - 1), C
                          ).to(x.dtype)[..., None, :]
              * keep[..., kk, None, None].to(x.dtype))   # (G,S,E,C)
        disp = disp + oh
        weights = weights + oh * gates_k[..., kk, None, None].to(x.dtype)

    # on a mesh each rank runs its groups' tokens through its experts
    # (expert parallel over the tensor axis), the combine summed across
    # ranks
    mask = ("moe_batch", None, "act_experts", None)
    w = ("act_experts", None, None)
    out = local_region(
        _experts, (disp, weights, xg, params["moe_w_in"].to(x.dtype),
                   params["moe_w_gate"].to(x.dtype),
                   params["moe_w_out"].to(x.dtype)),
        (mask, mask, ("moe_batch", None, None), w, w, w),
        ("moe_batch", None, None), partial=("act_experts",))
    out = reshape(out, B, S, d)

    if e.n_shared_experts:
        h = matmul(x, params["shared_w_in"].to(x.dtype))
        g = matmul(x, params["shared_w_gate"].to(x.dtype))
        h = constrain(h * F.silu(g), "batch", None, "act_ff")
        out = out + matmul(h, params["shared_w_out"].to(x.dtype))
    return out, aux * e.router_aux_weight
