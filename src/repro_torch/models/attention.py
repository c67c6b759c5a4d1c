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
``S >= CHUNK_THRESHOLD``.  A shape the kernel cannot take raises; it never
falls back to the plain path.  MLA's q and v head dims differ, so the JAX
package never sends it to its kernel; ``mla_forward`` takes the plain path
on either route.  Sharding constraints of the JAX package have no
counterpart on one card and are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
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
    if attn_impl == "kernel":
        if v.shape[-1] != q.shape[-1]:
            raise ValueError(
                f"attn_impl='kernel' needs one head dim for q and v, got "
                f"{q.shape[-1]} and {v.shape[-1]}")
        return ops.flash_attention(q, k, v, window=window, scale=scale)
    return _causal_attend_plain(q, k, v, scale, window, dtype)


def _causal_attend_plain(q, k, v, scale, window: int, dtype):
    """The plain path: scores materialised, q-chunked at
    ``S >= CHUNK_THRESHOLD`` to bound them at (B, Q_CHUNK, H, S)."""
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
    cq = rms_norm(torch.matmul(x, params["wq_down"].to(x.dtype)),
                  params["q_ln"], eps)
    q = torch.matmul(cq, params["wq_up"].to(x.dtype))
    q = q.reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, 10000.0)


def _mla_ckv(params, x, m: MLAConfig, positions, eps):
    ckv = torch.matmul(x, params["wkv_down"].to(x.dtype))
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

    k_nope = torch.matmul(c_kv, params["wk_up"].to(x.dtype))
    k_nope = k_nope.reshape(B, S, H, m.qk_nope_dim)
    v = torch.matmul(c_kv, params["wv_up"].to(x.dtype))
    v = v.reshape(B, S, H, m.v_head_dim)

    # fold q_rope / k_rope into the head dim so the chunked path applies
    q_all = torch.cat([q_nope, q_rope], dim=-1)          # (B,S,H,nope+rope)
    k_all = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    # q's head dim (nope + rope) is not v's, so the reference's condition
    # for its flash kernel (src/repro/models/attention.py:112) never holds
    # here: the plain path on either attn_impl
    o = _causal_attend_plain(q_all, k_all, v, scale, window, x.dtype)
    out = torch.matmul(o.reshape(B, S, H * m.v_head_dim),
                       params["wo"].to(x.dtype))

    if cache is not None:
        W = cache["c_kv"].shape[1]
        if S > W:
            raise ValueError(f"prefill of {S} tokens into a cache of {W}")
        cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
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
    cache["c_kv"][:, slot] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    cache["pos_ids"][slot] = pos
    c_kv, k_rope, pos_ids = cache["c_kv"], cache["k_rope"], cache["pos_ids"]

    # absorb q through W_uk: q_abs[b,h,r] = sum_c q_nope[b,h,c] Wk_up[r,h,c]
    wk_up = params["wk_up"].to(x.dtype).reshape(m.kv_lora_rank, H,
                                                m.qk_nope_dim)
    q_abs = torch.einsum("bhc,rhc->bhr", q_nope[:, 0], wk_up)   # (B,H,r)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bhr,bwr->bhw", *_promoted(q_abs, c_kv))
              + torch.einsum("bhc,bwc->bhw", *_promoted(q_rope[:, 0],
                                                        k_rope))) * scale
    valid = (pos_ids >= 0) & (pos_ids <= pos)
    if window:
        valid &= pos_ids > pos - window
    scores = torch.where(valid[None, None, :], scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhw,bwr->bhr", *_promoted(w, c_kv))  # (B,H,r)
    # absorb the output through W_uv
    wv_up = params["wv_up"].to(x.dtype).reshape(m.kv_lora_rank, H,
                                                m.v_head_dim)
    o = torch.einsum("bhr,rhv->bhv", *_promoted(o_lat, wv_up))
    o = o.reshape(B, 1, H * m.v_head_dim)
    out = torch.matmul(*_promoted(o, params["wo"].to(x.dtype)))
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
