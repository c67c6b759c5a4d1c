"""GQA attention (QKV bias, qk-norm, RoPE, sliding window): the GQA half of
``src/repro/models/attention.py``.  MLA is not ported yet (ROADMAP A13).

Three entry points:
  * ``init_attention``     parameter init
  * ``attention_forward``  full sequence (prefill); optionally fills a cache
  * ``attention_decode``   one token against a cache

Cache layout: ``{"k": (B, W, Hkv, hd), "v": ..., "pos_ids": (W,)}`` where
``W`` is the cache capacity (the sequence length, or the sliding window);
``pos_ids`` holds absolute positions (-1 = empty) so sliding-window decode
masks correctly after wraparound.  Unlike the JAX package, which returns
new arrays, both entry points write into the cache tensors they are given
and return the same dict: a copy of the whole cache per layer and step is
saved.

Full-sequence attention goes through ``attn_impl``: ``"kernel"`` (the
default) is the hand-written CUDA flash-attention kernel
(``kernels/flash_attention.py``; its plain version on the CPU) for any S;
``"torch"`` is the plain path of the JAX package, q-chunked at
``S >= CHUNK_THRESHOLD``.  A shape the kernel cannot take raises; it never
falls back to the plain path.  Sharding constraints of the JAX package
have no counterpart on one card and are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

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
    q = torch.matmul(x, params["wq"].to(x.dtype))
    k = torch.matmul(x, params["wk"].to(x.dtype))
    v = torch.matmul(x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
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
    B, S = q.shape[:2]
    if attn_impl == "kernel":
        if v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"attn_impl='kernel' needs one head dim for q and v, got "
                f"{q.shape[-1]} and {v.shape[-1]}")
        return ops.flash_attention(q, k, v, window=window, scale=scale)

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
        return _gqa_out(w, v)                             # (B,qc,H,hd)

    if S < CHUNK_THRESHOLD or S % Q_CHUNK:
        return block(q, 0)
    return torch.cat([block(q[:, off:off + Q_CHUNK], off)
                      for off in range(0, S, Q_CHUNK)], dim=1)


def attention_forward(params, x, cfg: ModelConfig, *, cache=None,
                      window: int = 0, attn_impl: str = "kernel"):
    """Full-sequence causal attention.  Writes the post-RoPE k/v into
    ``cache`` (in place) when one is given.  Returns (out, cache)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = _causal_attend(q, k, v, hd ** -0.5, window, x.dtype, attn_impl)
    out = torch.matmul(o.reshape(B, S, cfg.n_heads * hd),
                       params["wo"].to(x.dtype))
    if cache is not None:
        W = cache["k"].shape[1]
        if S > W:
            raise ValueError(f"prefill of {S} tokens into a cache of {W}")
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
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
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos_ids"][slot] = pos
    kc, vc, pos_ids = cache["k"], cache["v"], cache["pos_ids"]

    scores = _gqa_scores(q, kc) * (hd ** -0.5)           # (B,1,H,W)
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window:
        valid &= pos_ids > pos - window
    scores = torch.where(valid[None, None, None, :], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_out(w, vc).reshape(B, 1, cfg.n_heads * hd)
    out = torch.matmul(*_promoted(o, params["wo"].to(x.dtype)))
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
