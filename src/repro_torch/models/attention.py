"""Attention: GQA (QKV bias, qk-norm, RoPE, sliding window) and MLA; the
counterpart of ``src/repro/models/attention.py``.

Three entry points per variant:
  * ``init_attention`` / ``init_mla``       parameter init
  * ``attention_forward`` / ``mla_forward``  full sequence (prefill);
    optionally fills a cache
  * ``attention_decode`` / ``mla_decode``    one token against a cache

GQA cache layout: ``{"k": (B, W, Hkv, hd), "v": ..., "pos_ids": (W,)}``
where ``W`` is the cache capacity (the sequence length, or the sliding
window); ``pos_ids`` holds absolute positions (-1 = empty) so
sliding-window decode masks correctly after wraparound.  MLA (DeepSeek-V3)
caches the compressed latent instead, ``{"c_kv": (B, W, kv_lora_rank),
"k_rope": (B, W, qk_rope_dim), "pos_ids": (W,)}``, and decodes in the
absorbed form (q through W_uk, the output through W_uv).  Unlike the JAX
package, which returns new arrays, every entry point writes into the cache
tensors it is given and returns the same dict: a copy of the whole cache
per layer and step is saved.

Full-sequence GQA attention goes through ``attn_impl``: ``"kernel"`` (the
default) is the hand-written CUDA flash-attention kernel
(``kernels/flash_attention.py``; its plain version on the CPU) for any S;
``"torch"`` is the plain path of the JAX package, q-chunked at
``S >= CHUNK_THRESHOLD``, and the route of training: the kernel is
forward only (so is the reference's, which trains on its plain path), and
on a CUDA tensor that autograd would record it raises.  A shape the
kernel cannot take raises; it never falls back to the plain path.  MLA's
q and v head dims differ, so the JAX package never sends it to its
kernel; ``mla_forward`` takes the plain path on either route.

The sharding constraints sit at the reference's sites (projections on
``act_ff``, (B, S, H, hd) activations through ``constrain_heads``, decode
caches on ``cache_seq``); without rules they return their input.  On
``DTensor`` activations the kernel route runs the flash kernel on each
rank's local block of batch and heads (:func:`on_local_heads`), since a
kernel takes plain device pointers.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.sharding import constrain, constrain_heads
from repro_torch.sharding.rules import (local_region, matmul, reshape,
                                        split_last, write_slice)

NEG_INF = -1e9
Q_CHUNK = 512           # q-block size of the chunked (memory-bounded) path
CHUNK_THRESHOLD = 4096  # chunk the plain path for sequences >= this
ATTN_IMPLS = ("kernel", "torch")


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device
    p = {
        "wq": dense_init(generator, d, H * hd, dtype=dtype),
        "wk": dense_init(generator, d, Hkv * hd, dtype=dtype),
        "wv": dense_init(generator, d, Hkv * hd, dtype=dtype),
        "wo": dense_init(generator, H * hd, d, scale=(H * hd) ** -0.5,
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = constrain(matmul(x, params["wq"].to(x.dtype)),
                  "batch", None, "act_ff")
    k = constrain(matmul(x, params["wk"].to(x.dtype)),
                  "batch", None, "act_ff")
    v = constrain(matmul(x, params["wv"].to(x.dtype)),
                  "batch", None, "act_ff")
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = split_last(q, B, S, cfg.n_heads, hd)
    k = split_last(k, B, S, cfg.n_kv_heads, hd)
    v = split_last(v, B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _promoted(a, b):
    """a, b in their promoted dtype, as ``jnp.einsum`` promotes them."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,W,Hkv,hd) -> (B,S,H,W) with KV-head grouping."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    q, k = _promoted(q, k)
    s = torch.einsum("bskgh,bwkh->bskgw", q.reshape(B, S, Hkv, H // Hkv, hd),
                     k)
    return s.reshape(B, S, H, k.shape[1])


def _gqa_out(w, v):
    """w: (B,S,H,W), v: (B,W,Hkv,hd) -> (B,S,H,hd)."""
    B, S, H, W = w.shape
    Hkv = v.shape[2]
    w, v = _promoted(w, v)
    o = torch.einsum("bskgw,bwkh->bskgh", w.reshape(B, S, Hkv, H // Hkv, W),
                     v)
    return o.reshape(B, S, H, v.shape[-1])


def _causal_attend(q, k, v, scale, window: int, dtype,
                   attn_impl: str = "kernel"):
    """Causal attention over the full sequence; (B,S,H,hd) in and out."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}; pick from {ATTN_IMPLS}")
    if isinstance(q, DTensor):
        return on_local_heads(
            lambda *qkv: _causal_attend(*qkv, scale, window, dtype,
                                        attn_impl), q, k, v)
    if attn_impl == "kernel":
        if v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"attn_impl='kernel' needs one head dim for q and v, got "
                f"{q.shape[-1]} and {v.shape[-1]}")
        return ops.flash_attention(q, k, v, window=window, scale=scale)
    return _causal_attend_plain(q, k, v, scale, window, dtype)


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (causal attention, (B, S, H, hd) in and out) on
    each rank's local block of DTensor q, k, v: batch and heads stay split
    as q has them, the sequence and head dim are gathered whole.  The GQA
    fold of a local head onto its local KV head holds when k is split over
    heads as q is, so otherwise the heads are gathered too.  Rows and
    heads are independent, so the blocks compute the whole result; the
    flash kernel, which takes plain device pointers, runs this way."""
    def keep(t, dims):
        return [p if type(p) is Shard and p.dim in dims else Replicate()
                for p in t.placements]
    want = keep(q, (0, 2))
    if keep(k, (0, 2)) != want:
        want = keep(q, (0,))
    mesh = q.device_mesh
    out = fn(*(t.redistribute(mesh, want).to_local() for t in (q, k, v)))
    return DTensor.from_local(out, mesh, want, run_check=False)


def _causal_attend_plain(q, k, v, scale, window: int, dtype):
    """The plain path: scores materialised, q-chunked at
    ``S >= CHUNK_THRESHOLD`` to bound them at (B, Q_CHUNK, H, S).  With
    grad enabled each chunk runs under ``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint`` block: the backward recomputes a
    chunk's fp32 scores instead of keeping one copy per chunk (5.4 GB a
    layer at 2 x 4096 x 40 heads)."""
    B, S = q.shape[:2]

    def block(qb, off):
        qc = qb.shape[1]
        s = _gqa_scores(qb, k) * scale                    # (B,qc,H,S)
        i = off + torch.arange(qc, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = j <= i
        if window:
            mask &= j > i - window
        s = torch.where(mask[None, :, None, :], s.float(), NEG_INF)
        w = torch.softmax(s, dim=-1).to(dtype)
        return constrain_heads(_gqa_out(w, v))            # (B,qc,H,hd)

    if S < CHUNK_THRESHOLD or S % Q_CHUNK:
        return block(q, 0)
    def run(qb, off):
        if torch.is_grad_enabled():
            return checkpoint(block, qb, off, use_reentrant=False)
        return block(qb, off)
    return torch.cat([run(q[:, off:off + Q_CHUNK], off)
                      for off in range(0, S, Q_CHUNK)], dim=1)


def attention_forward(params, x, cfg: ModelConfig, *, cache=None,
                      window: int = 0, attn_impl: str = "kernel"):
    """Full-sequence causal attention.  Writes the post-RoPE k/v into
    ``cache`` (in place) when one is given.  Returns (out, cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    q, k, v = constrain_heads(q), constrain_heads(k), constrain_heads(v)
    o = constrain_heads(_causal_attend(q, k, v, hd ** -0.5, window, x.dtype,
                                       attn_impl))
    out = matmul(reshape(o, B, S, cfg.n_heads * hd),
                 params["wo"].to(x.dtype))
    if cache is not None:
        W = cache["k"].shape[1]
        if S > W:
            raise ValueError(f"prefill of {S} tokens into a cache of {W}")
        write_slice(cache["k"], 1, 0, k.to(cache["k"].dtype))
        write_slice(cache["v"], 1, 0, v.to(cache["v"].dtype))
        cache["pos_ids"][:S] = torch.arange(S, device=x.device)
    return out, cache


def attention_decode(params, x, cache, pos, cfg: ModelConfig, *,
                     window: int = 0):
    """One-token decode.  x: (B,1,d); pos: tokens already cached.  Writes
    slot ``pos % W`` (with a window) or ``min(pos, W-1)`` of ``cache`` in
    place.  Returns (out, cache)."""
    B = x.shape[0]
    pos = int(pos)
    hd = cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)  # q:(B,1,H,hd)

    W = cache["k"].shape[1]
    slot = (pos % W) if window else min(pos, W - 1)
    write_slice(cache["k"], 1, slot, k.to(cache["k"].dtype))
    write_slice(cache["v"], 1, slot, v.to(cache["v"].dtype))
    cache["pos_ids"][slot] = pos
    kc = constrain(cache["k"], "batch", "cache_seq", None, None)
    vc = constrain(cache["v"], "batch", "cache_seq", None, None)
    pos_ids = cache["pos_ids"]

    # on a mesh each rank scores and sums its slots of the sequence-split
    # cache; the softmax gathers the (small) scores, the output is summed
    heads = ("batch", None, None, None)                  # (B, 1, H, hd)
    kv = ("batch", "cache_seq", None, None)              # (B, W, Hkv, hd)
    slots = ("batch", None, None, "cache_seq")           # (B, 1, H, W)
    scores = local_region(_gqa_scores, (q, kc), (heads, kv),
                          slots) * (hd ** -0.5)
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window:
        valid &= pos_ids > pos - window
    scores = torch.where(valid[None, None, None, :], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = reshape(local_region(_gqa_out, (w, vc), (slots, kv), heads,
                             partial=("cache_seq",)),
                B, 1, cfg.n_heads * hd)
    out = matmul(*_promoted(o, params["wo"].to(x.dtype)))
    return out, cache


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  dtype=torch.bfloat16, device=None):
    hd = cfg.resolved_head_dim
    shape = (batch, capacity, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos_ids": torch.full((capacity,), -1, dtype=torch.int32,
                              device=device),
    }


# ===================================================================== MLA
def init_mla(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dev = generator.device
    return {
        "wq_down": dense_init(generator, d, m.q_lora_rank, dtype=dtype),
        "wq_up": dense_init(generator, m.q_lora_rank,
                            H * (m.qk_nope_dim + m.qk_rope_dim), dtype=dtype),
        "wkv_down": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_dim,
                               dtype=dtype),
        "wk_up": dense_init(generator, m.kv_lora_rank, H * m.qk_nope_dim,
                            dtype=dtype),
        "wv_up": dense_init(generator, m.kv_lora_rank, H * m.v_head_dim,
                            dtype=dtype),
        "wo": dense_init(generator, H * m.v_head_dim, d,
                         scale=(H * m.v_head_dim) ** -0.5, dtype=dtype),
        "q_ln": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
        "kv_ln": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
    }


def _mla_q(params, x, m: MLAConfig, H, positions, eps):
    B, S, _ = x.shape
    cq = rms_norm(matmul(x, params["wq_down"].to(x.dtype)),
                  params["q_ln"], eps)
    q = matmul(cq, params["wq_up"].to(x.dtype))
    q = split_last(q, B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, 10000.0)


def _mla_ckv(params, x, m: MLAConfig, positions, eps):
    ckv = matmul(x, params["wkv_down"].to(x.dtype))
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, params["kv_ln"], eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, 10000.0)[:, :, 0]
    return c_kv, k_rope


def mla_forward(params, x, cfg: ModelConfig, *, cache=None, window: int = 0):
    """Full-sequence MLA, non-absorbed: k and v expanded from the latent,
    then standard attention.  Writes the latent and the shared k_rope into
    ``cache`` (in place) when one is given.  Returns (out, cache)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(params, x, m, H, positions, cfg.norm_eps)
    c_kv, k_rope = _mla_ckv(params, x, m, positions, cfg.norm_eps)

    k_nope = matmul(c_kv, params["wk_up"].to(x.dtype))
    k_nope = split_last(k_nope, B, S, H, m.qk_nope_dim)
    v = matmul(c_kv, params["wv_up"].to(x.dtype))
    v = split_last(v, B, S, H, m.v_head_dim)
    q_nope = constrain(q_nope, "batch", None, "act_heads", None)

    # fold q_rope / k_rope into the head dim so the chunked path applies
    q_all = torch.cat([q_nope, q_rope], dim=-1)          # (B,S,H,nope+rope)
    k_all = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # q's head dim (nope + rope) is not v's, so the reference's condition
    # for its flash kernel (src/repro/models/attention.py:112) never holds
    # here: the plain path on either attn_impl
    if isinstance(q_all, DTensor):
        o = on_local_heads(lambda *qkv: _causal_attend_plain(
            *qkv, scale, window, x.dtype), q_all, k_all, v)
    else:
        o = _causal_attend_plain(q_all, k_all, v, scale, window, x.dtype)
    out = matmul(reshape(o, B, S, H * m.v_head_dim),
                 params["wo"].to(x.dtype))

    if cache is not None:
        W = cache["c_kv"].shape[1]
        if S > W:
            raise ValueError(f"prefill of {S} tokens into a cache of {W}")
        write_slice(cache["c_kv"], 1, 0, c_kv.to(cache["c_kv"].dtype))
        write_slice(cache["k_rope"], 1, 0, k_rope.to(cache["k_rope"].dtype))
        cache["pos_ids"][:S] = torch.arange(S, device=x.device)
    return out, cache


def mla_decode(params, x, cache, pos, cfg: ModelConfig, *, window: int = 0):
    """Absorbed one-token MLA decode against the latent cache, written in
    place at slot ``pos % W`` (with a window) or ``min(pos, W-1)``."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(params, x, m, H, positions, cfg.norm_eps)
    c_kv_new, k_rope_new = _mla_ckv(params, x, m, positions, cfg.norm_eps)

    W = cache["c_kv"].shape[1]
    slot = (pos % W) if window else min(pos, W - 1)
    write_slice(cache["c_kv"], 1, slot, c_kv_new.to(cache["c_kv"].dtype))
    write_slice(cache["k_rope"], 1, slot,
                k_rope_new.to(cache["k_rope"].dtype))
    cache["pos_ids"][slot] = pos
    c_kv = constrain(cache["c_kv"], "batch", "cache_seq", None)
    k_rope = constrain(cache["k_rope"], "batch", "cache_seq", None)
    pos_ids = cache["pos_ids"]

    # absorb q through W_uk: q_abs[b,h,r] = sum_c q_nope[b,h,c] Wk_up[r,h,c]
    wk_up = params["wk_up"].to(x.dtype).reshape(m.kv_lora_rank, H,
                                                m.qk_nope_dim)
    q_abs = torch.einsum("bhc,rhc->bhr", q_nope[:, 0], wk_up)   # (B,H,r)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # on a mesh each rank scores and sums its slots of the sequence-split
    # latent cache, as in attention_decode
    row, lat = ("batch", None, None), ("batch", "cache_seq", None)
    slots = ("batch", None, "cache_seq")                 # (B, H, W)
    scores = local_region(
        lambda qa, ckv, qr, kr: (
            torch.einsum("bhr,bwr->bhw", *_promoted(qa, ckv))
            + torch.einsum("bhc,bwc->bhw", *_promoted(qr, kr))),
        (q_abs, c_kv, q_rope[:, 0], k_rope), (row, lat, row, lat),
        slots) * scale
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window:
        valid &= pos_ids > pos - window
    scores = torch.where(valid[None, None, :], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = local_region(                                # (B,H,r)
        lambda w, ckv: torch.einsum("bhw,bwr->bhr", *_promoted(w, ckv)),
        (w, c_kv), (slots, lat), row, partial=("cache_seq",))
    # absorb the output through W_uv
    wv_up = params["wv_up"].to(x.dtype).reshape(m.kv_lora_rank, H,
                                                m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", *_promoted(o_lat, wv_up))
    o = reshape(o, B, 1, H * m.v_head_dim)
    out = matmul(*_promoted(o, params["wo"].to(x.dtype)))
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int,
                   dtype=torch.bfloat16, device=None):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_dim), dtype=dtype,
                              device=device),
        "pos_ids": torch.full((capacity,), -1, dtype=torch.int32,
                              device=device),
    }
