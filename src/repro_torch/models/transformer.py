"""The dense decoder: the dense branch of ``src/repro/models/transformer.py``.

One parameter tree + three entry points:

  * ``forward``      full sequence (prefill); optionally fills the caches
  * ``decode_step``  one token against the per-layer caches
  * ``init_cache``   the stacked per-layer KV caches

The tree has the JAX package's keys and layouts, so a JAX-made tree crosses
as it is (:func:`params_from_numpy`): ``embed_tokens (V, d)``,
``final_norm (d,)``, ``lm_head (d, V)`` unless the embeddings are tied, and
``blocks``, one dict whose leaves carry a leading layer axis
(``blocks/attn/wq (L, d, Hq*hd)``, ``blocks/mlp/w_in (L, d, d_ff)``, ...).
The JAX package scans the layers; here a Python loop walks views of the
stack.  Caches are stacked the same way and filled in place.

Only ``arch_type == "dense"`` without MLA is ported; the MoE, hybrid
(Mamba2), xLSTM, VLM and audio branches raise ``NotImplementedError``
(ROADMAP A13).  Full-sequence attention takes ``attn_impl`` (see
:mod:`repro_torch.models.attention`); ``remat`` is accepted and ignored,
since there is no backward pass here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, mlp, rms_norm,
                                       tree_from_numpy)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.mla is not None:
        kind = cfg.arch_type + (" with MLA" if cfg.mla is not None else "")
        raise NotImplementedError(
            f"{cfg.name}: arch {kind!r} is not ported yet; the port runs "
            "the dense GQA decoder, ROADMAP A13 ports the rest")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked tree, as views."""
    return _map(lambda t: t[l], tree)


# ===================================================================== init
def _init_dense_block(generator: torch.Generator, cfg: ModelConfig, dtype,
                      d_ff=None):
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=generator.device)
    return {"ln1": ones, "ln2": ones.clone(),
            "attn": attn.init_attention(generator, cfg, dtype),
            "mlp": init_mlp(generator, cfg.d_model, d_ff or cfg.d_ff, dtype)}


def _stack_init(fn, n: int):
    """``fn()`` drawn ``n`` times into one tree with a leading layer axis,
    filled layer by layer (no second copy of the stack)."""
    first = fn()
    out = _map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                     device=t.device), first)

    def fill(dst, src, l):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], l)
        else:
            dst[l] = src
    fill(out, first, 0)
    for l in range(1, n):
        fill(out, fn(), l)
    return out


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    """Random weights drawn on ``generator``'s device (same scale rules as
    the JAX package; the draws differ, torch cannot replay
    ``jax.random``)."""
    _check_dense(cfg)
    p: Dict = {"embed_tokens": init_embedding(generator, cfg.vocab_size,
                                              cfg.d_model, dtype)}
    p["blocks"] = _stack_init(
        lambda: _init_dense_block(generator, cfg, dtype), cfg.n_layers)
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                 device=generator.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  scale=cfg.d_model ** -0.5, dtype=dtype)
    return p


def params_from_numpy(tree, device="cpu") -> Dict:
    """A transformer tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``, layouts and
    dtypes unchanged (bfloat16 included)."""
    return tree_from_numpy(tree, device)


# ===================================================================== blocks
def _dense_block_fwd(p, x, cfg: ModelConfig, *, cache=None, window=0,
                     attn_impl="kernel"):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn.attention_forward(p["attn"], h, cfg, cache=cache,
                                      window=window, attn_impl=attn_impl)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


def _dense_block_dec(p, x, cache, pos, cfg: ModelConfig, *, window=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn.attention_decode(p["attn"], h, cache, pos, cfg,
                                     window=window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


# ===================================================================== embed
def _embed_input(params, batch, cfg: ModelConfig, dtype):
    """Returns (x (B,S,d), label_mask); tokens only, so the mask is None."""
    return embed(params["embed_tokens"], batch["tokens"], dtype), None


def _lm_logits(params, h, cfg: ModelConfig):
    w = (params["embed_tokens"].T if cfg.tie_embeddings
         else params["lm_head"]).to(h.dtype)
    return torch.matmul(h, w)


# ===================================================================== forward
def forward(params, batch, cfg: ModelConfig, *, dtype=torch.bfloat16,
            window: Optional[int] = None, caches=None, remat: bool = True,
            attn_impl: str = "kernel"):
    """Full-sequence pass.  Returns (logits, aux_loss, (caches, h, None)).

    ``caches`` (optional) are ``init_cache`` trees, filled in place (prefill
    mode).  ``window`` overrides ``cfg.sliding_window``.
    """
    _check_dense(cfg)
    window = cfg.sliding_window if window is None else window
    x, media_mask = _embed_input(params, batch, cfg, dtype)
    for l in range(params["blocks"]["ln1"].shape[0]):
        x, _ = _dense_block_fwd(
            _layer(params["blocks"], l), x, cfg,
            cache=None if caches is None else _layer(caches, l),
            window=window, attn_impl=attn_impl)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(params, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, (caches, h, media_mask)


# ===================================================================== decode
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device=None):
    """Per-layer KV caches, stacked to match the layer stack:
    ``k``/``v`` (L, B, W, Hkv, hd), ``pos_ids`` (L, W) at -1."""
    _check_dense(cfg)
    one = attn.init_kv_cache(cfg, batch, capacity, dtype, device)
    return {k: t.expand((cfg.n_layers,) + tuple(t.shape)).clone()
            for k, t in one.items()}


def decode_step(params, caches, batch, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16, window: Optional[int] = None):
    """One-token decode.  batch["tokens"]: (B, 1); ``pos``: tokens already
    in the cache.  Returns (logits (B, 1, V), caches), the caches updated
    in place."""
    _check_dense(cfg)
    window = cfg.sliding_window if window is None else window
    x, _ = _embed_input(params, batch, cfg, dtype)
    for l in range(params["blocks"]["ln1"].shape[0]):
        x, _ = _dense_block_dec(_layer(params["blocks"], l), x,
                                _layer(caches, l), pos, cfg, window=window)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, h, cfg), caches


# ===================================================================== module
class _Tree(nn.Module):
    """A nested dict of tensors as registered, frozen parameters."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict:
        return {k: (getattr(self, k).tree() if isinstance(getattr(self, k),
                                                          _Tree)
                    else getattr(self, k)) for k in self._keys}


class Transformer(nn.Module):
    """The dense decoder as an ``nn.Module``: the parameter tree registered
    under its keys (frozen: the flash kernel is forward only),
    :meth:`params` the plain tree that :func:`forward` and
    :func:`decode_step` take."""

    def __init__(self, cfg: ModelConfig, params: Dict, *,
                 attn_impl: str = "kernel"):
        super().__init__()
        _check_dense(cfg)
        self.cfg, self.attn_impl = cfg, attn_impl
        self.tree = _Tree(params)

    def params(self) -> Dict:
        return self.tree.tree()

    def forward(self, batch, *, caches=None, dtype=torch.bfloat16,
                window: Optional[int] = None):
        return forward(self.params(), batch, self.cfg, dtype=dtype,
                       window=window, caches=caches,
                       attn_impl=self.attn_impl)

    def decode_step(self, caches, batch, pos, *, dtype=torch.bfloat16,
                    window: Optional[int] = None):
        return decode_step(self.params(), caches, batch, pos, self.cfg,
                           dtype=dtype, window=window)
