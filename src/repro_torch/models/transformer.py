"""The unified decoder over every architecture family: the counterpart of
``src/repro/models/transformer.py``.

One parameter tree + three entry points:

  * ``forward``      full sequence (prefill); optionally fills the caches
  * ``decode_step``  one token against the per-layer caches and states
  * ``init_cache``   the stacked per-layer caches (KV, MLA latent, SSM,
    xLSTM)

The tree has the JAX package's keys and layouts, so a JAX-made tree crosses
as it is (:func:`params_from_numpy`).  Homogeneous layer stacks carry a
leading layer axis; heterogeneous stacks are split into the JAX package's
groups:

  dense / vlm / audio : ``blocks``, one stack of [attention + MLP] blocks
  moe                 : ``dense_blocks`` (the first ``dense_layers``) and
                        ``moe_blocks``; ``mtp_proj`` / ``mtp_block`` /
                        ``mtp_ln`` when ``cfg.mtp`` (made, unused here)
  hybrid (zamba2)     : ``mamba_groups`` (groups x attn_every) with ONE
                        ``shared_attn`` block applied after each group, and
                        ``mamba_tail`` for the remainder
  ssm (xlstm)         : ``mlstm_groups`` (groups x (slstm_every - 1)) and
                        ``slstm_blocks``, one sLSTM closing each group

plus ``embed_tokens`` (audio: ``cb_embed`` / ``cb_heads``), ``projector``
(vlm), ``final_norm`` and ``lm_head`` unless the embeddings are tied.  The
JAX package scans the stacks; here Python loops walk views of them.
Caches are stacked the same way and filled in place: the KV and latent
caches slot by slot, the SSM and xLSTM states by copying each layer's new
state into its slice.  Full-sequence attention takes ``attn_impl`` (see
:mod:`repro_torch.models.attention`); ``remat`` is accepted and ignored,
since there is no backward pass here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import frontends
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, mlp, rms_norm,
                                       tree_from_numpy)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked tree, as views."""
    return _map(lambda t: t[l], tree)


def _assign(dst, src) -> None:
    """Copy a tree of new states into a tree of cache views, in place."""
    for k, t in dst.items():
        t.copy_(src[k])


# ===================================================================== init
def _ones(cfg: ModelConfig, dtype, generator):
    return torch.ones((cfg.d_model,), dtype=dtype, device=generator.device)


def _init_dense_block(generator: torch.Generator, cfg: ModelConfig, dtype,
                      d_ff=None):
    return {"ln1": _ones(cfg, dtype, generator),
            "ln2": _ones(cfg, dtype, generator),
            "attn": (attn.init_mla if cfg.mla is not None
                     else attn.init_attention)(generator, cfg, dtype),
            "mlp": init_mlp(generator, cfg.d_model, d_ff or cfg.d_ff, dtype)}


def _init_moe_block(generator: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": _ones(cfg, dtype, generator),
            "ln2": _ones(cfg, dtype, generator),
            "attn": (attn.init_mla if cfg.mla is not None
                     else attn.init_attention)(generator, cfg, dtype),
            "moe": moe_mod.init_moe(generator, cfg, dtype)}


def _init_mamba_block(generator: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": _ones(cfg, dtype, generator),
            "ssm": ssm_mod.init_ssm(generator, cfg, dtype)}


def _init_mlstm_block(generator: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": _ones(cfg, dtype, generator),
            "inner": xlstm_mod.init_mlstm(generator, cfg, dtype)}


def _init_slstm_block(generator: torch.Generator, cfg: ModelConfig, dtype):
    return {"ln1": _ones(cfg, dtype, generator),
            "inner": xlstm_mod.init_slstm(generator, cfg, dtype)}


def _stack_init(fn, n: int):
    """``fn()`` drawn ``n`` times into one tree with a leading layer axis,
    filled layer by layer: at most one layer beside the stack at a time."""
    layer = fn()
    out = _map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                     device=t.device), layer)

    def fill(dst, src, l):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], l)
        else:
            dst[l] = src
    for l in range(n):
        if l:
            layer = fn()
        fill(out, layer, l)
        del layer
    return out


def _zamba_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, tail) so n_layers = n_groups * attn_every + tail."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


def _xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, mlstm_per_group)."""
    per = cfg.xlstm.slstm_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of slstm_every={per}")
    return cfg.n_layers // per, per - 1


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    """Random weights drawn on ``generator``'s device (same scale rules as
    the JAX package; the draws differ, torch cannot replay
    ``jax.random``)."""
    p: Dict = {}
    if cfg.arch_type == "audio":
        p.update(frontends.init_codebook_embeddings(generator, cfg, dtype))
    else:
        p["embed_tokens"] = init_embedding(generator, cfg.vocab_size,
                                           cfg.d_model, dtype)
    if cfg.arch_type == "vlm":
        p["projector"] = frontends.init_projector(generator, cfg, dtype)

    def stack(init, n):
        return _stack_init(lambda: init(generator, cfg, dtype), n)

    if cfg.arch_type in ("dense", "vlm", "audio"):
        p["blocks"] = stack(_init_dense_block, cfg.n_layers)
    elif cfg.arch_type == "moe":
        if cfg.dense_layers:
            p["dense_blocks"] = stack(_init_dense_block, cfg.dense_layers)
        p["moe_blocks"] = stack(_init_moe_block,
                                cfg.n_layers - cfg.dense_layers)
        if cfg.mtp:
            p["mtp_proj"] = dense_init(generator, 2 * cfg.d_model,
                                       cfg.d_model, dtype=dtype)
            p["mtp_block"] = _init_dense_block(generator, cfg, dtype,
                                               d_ff=cfg.d_ff)
            p["mtp_ln"] = _ones(cfg, dtype, generator)
    elif cfg.arch_type == "hybrid":
        g, tail = _zamba_split(cfg)
        ae = cfg.attn_every
        blocks = stack(_init_mamba_block, cfg.n_layers)
        p["mamba_groups"] = _map(
            lambda t: t[:g * ae].reshape(g, ae, *t.shape[1:]), blocks)
        if tail:
            p["mamba_tail"] = _map(lambda t: t[-tail:], blocks)
        p["shared_attn"] = _init_dense_block(generator, cfg, dtype)
    elif cfg.arch_type == "ssm":                          # xlstm
        g, per = _xlstm_groups(cfg)
        p["mlstm_groups"] = _map(
            lambda t: t.reshape(g, per, *t.shape[1:]),
            stack(_init_mlstm_block, g * per))
        p["slstm_blocks"] = stack(_init_slstm_block, g)
    else:
        raise ValueError(cfg.arch_type)

    p["final_norm"] = _ones(cfg, dtype, generator)
    if cfg.arch_type != "audio" and not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  scale=cfg.d_model ** -0.5, dtype=dtype)
    return p


def params_from_numpy(tree, device="cpu") -> Dict:
    """A transformer tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``, layouts and
    dtypes unchanged (bfloat16 included)."""
    return tree_from_numpy(tree, device)


# ===================================================================== blocks
def _attend_fwd(p, h, cfg: ModelConfig, cache, window, attn_impl):
    if cfg.mla is not None:
        return attn.mla_forward(p, h, cfg, cache=cache, window=window)
    return attn.attention_forward(p, h, cfg, cache=cache, window=window,
                                  attn_impl=attn_impl)


def _attend_dec(p, h, cache, pos, cfg: ModelConfig, window):
    if cfg.mla is not None:
        return attn.mla_decode(p, h, cache, pos, cfg, window=window)
    return attn.attention_decode(p, h, cache, pos, cfg, window=window)


def _dense_block_fwd(p, x, cfg: ModelConfig, *, cache=None, window=0,
                     attn_impl="kernel"):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = _attend_fwd(p["attn"], h, cfg, cache, window, attn_impl)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


def _dense_block_dec(p, x, cache, pos, cfg: ModelConfig, *, window=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = _attend_dec(p["attn"], h, cache, pos, cfg, window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


def _moe_block_fwd(p, x, cfg: ModelConfig, *, cache=None, window=0,
                   attn_impl="kernel"):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = _attend_fwd(p["attn"], h, cfg, cache, window, attn_impl)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff, aux = moe_mod.moe_ffn(p["moe"], h, cfg)
    return x + ff, cache, aux


def _moe_block_dec(p, x, cache, pos, cfg: ModelConfig, *, window=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = _attend_dec(p["attn"], h, cache, pos, cfg, window)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff, _ = moe_mod.moe_ffn(p["moe"], h, cfg)
    return x + ff, cache


def _residual_fwd(forward_fn, p, x, cfg: ModelConfig):
    """A Mamba2 / mLSTM / sLSTM block over the full sequence from a zero
    state: x + inner(norm(x)), and the inner block's final state."""
    inner = p["ssm"] if "ssm" in p else p["inner"]
    o, st = forward_fn(inner, rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    return x + o, st


def _residual_dec(decode_fn, p, x, st, cfg: ModelConfig):
    """One token of such a block against its state."""
    inner = p["ssm"] if "ssm" in p else p["inner"]
    o, st = decode_fn(inner, rms_norm(x, p["ln1"], cfg.norm_eps), st, cfg)
    return x + o, st


# ===================================================================== embed
def _embed_input(params, batch, cfg: ModelConfig, dtype):
    """Returns (x (B,S,d), label_mask or None)."""
    if cfg.arch_type == "audio":
        return frontends.embed_codes(params, batch["tokens"], dtype), None
    x = embed(params["embed_tokens"], batch["tokens"], dtype)
    if cfg.arch_type == "vlm" and "media" in batch:
        # media patch embeddings are PREPENDED: seq = n_media + n_text, so
        # the batch carries seq_len - n_media text tokens
        m = frontends.project_media(params["projector"], batch["media"],
                                    dtype)
        B, n_media, n_text = x.shape[0], m.shape[1], x.shape[1]
        x = torch.cat([m, x], dim=1)
        mask = torch.cat([torch.zeros((B, n_media), dtype=torch.bool,
                                      device=x.device),
                          torch.ones((B, n_text), dtype=torch.bool,
                                     device=x.device)], dim=1)
        return x, mask
    return x, None


def _lm_logits(params, h, cfg: ModelConfig):
    if cfg.arch_type == "audio":
        return frontends.codebook_logits(params, h)      # (B,K,S,V)
    w = (params["embed_tokens"].T if cfg.tie_embeddings
         else params["lm_head"]).to(h.dtype)
    return torch.matmul(h, w)


# ===================================================================== forward
def forward(params, batch, cfg: ModelConfig, *, dtype=torch.bfloat16,
            window: Optional[int] = None, caches=None, remat: bool = True,
            attn_impl: str = "kernel"):
    """Full-sequence pass.  Returns (logits, aux_loss, (caches, h,
    media_mask)); ``aux_loss`` is the MoE load-balance loss summed over
    the layers (0 elsewhere), logits (B, S, V) (audio: (B, K, S, V)).

    ``caches`` (optional) are ``init_cache`` trees, filled in place
    (prefill mode).  ``window`` overrides ``cfg.sliding_window``.
    """
    window = cfg.sliding_window if window is None else window
    x, media_mask = _embed_input(params, batch, cfg, dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fill = caches is not None

    def cache_of(tree, l):
        return None if tree is None else _layer(tree, l)

    def part(key):
        return caches[key] if fill else None

    def dense_stack(blocks, cs, x):
        for l in range(blocks["ln1"].shape[0]):
            x, _ = _dense_block_fwd(_layer(blocks, l), x, cfg,
                                    cache=cache_of(cs, l), window=window,
                                    attn_impl=attn_impl)
        return x

    if cfg.arch_type in ("dense", "vlm", "audio"):
        x = dense_stack(params["blocks"], caches, x)

    elif cfg.arch_type == "moe":
        if cfg.dense_layers:
            x = dense_stack(params["dense_blocks"], part("dense"), x)
        blocks = params["moe_blocks"]
        for l in range(blocks["ln1"].shape[0]):
            x, _, a = _moe_block_fwd(_layer(blocks, l), x, cfg,
                                     cache=cache_of(part("moe"), l),
                                     window=window, attn_impl=attn_impl)
            aux_total = aux_total + a

    elif cfg.arch_type == "hybrid":
        g, tail = _zamba_split(cfg)
        for gi in range(g):
            pg = _layer(params["mamba_groups"], gi)
            for j in range(cfg.attn_every):
                x, st = _residual_fwd(ssm_mod.ssm_forward, _layer(pg, j), x,
                                      cfg)
                if fill:
                    _assign(_layer(_layer(caches["groups"], gi), j), st)
            x, _ = _dense_block_fwd(params["shared_attn"], x, cfg,
                                    cache=cache_of(part("shared"), gi),
                                    window=window, attn_impl=attn_impl)
        for j in range(tail):
            x, st = _residual_fwd(ssm_mod.ssm_forward,
                                  _layer(params["mamba_tail"], j), x, cfg)
            if fill:
                _assign(_layer(caches["tail"], j), st)

    elif cfg.arch_type == "ssm":                          # xlstm
        g, per = _xlstm_groups(cfg)
        for gi in range(g):
            pm = _layer(params["mlstm_groups"], gi)
            for j in range(per):
                x, st = _residual_fwd(xlstm_mod.mlstm_forward, _layer(pm, j),
                                      x, cfg)
                if fill:
                    _assign(_layer(_layer(caches[0], gi), j), st)
            x, st = _residual_fwd(xlstm_mod.slstm_forward,
                                  _layer(params["slstm_blocks"], gi), x, cfg)
            if fill:
                _assign(_layer(caches[1], gi), st)
    else:
        raise ValueError(cfg.arch_type)

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(params, h, cfg)
    return logits, aux_total, (caches, h, media_mask)


# ===================================================================== decode
def _stack_tree(tree, n: int):
    """``tree`` repeated ``n`` times along a new leading axis."""
    if isinstance(tree, dict):
        return {k: _stack_tree(v, n) for k, v in tree.items()}
    return tree.expand((n,) + tuple(tree.shape)).clone()


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device=None):
    """Per-layer decode caches, stacked to match the layer stacks:

    * dense / vlm / audio: KV caches ``k``/``v`` (L, B, W, Hkv, hd) and
      ``pos_ids`` (L, W) at -1, or the MLA latent caches;
    * moe: ``{"dense": ... or None, "moe": ...}`` of those;
    * hybrid: ``{"groups": SSM states (g, attn_every, ...), "tail": (tail,
      ...) or None, "shared": KV caches (g, ...)}``: the shared block runs
      g times a token on different inputs, so it has a cache per
      invocation;
    * ssm (xlstm): (mLSTM states (g, per, ...), sLSTM states (g, ...)).
    """
    kv = attn.init_mla_cache if cfg.mla is not None else attn.init_kv_cache
    if cfg.arch_type in ("dense", "vlm", "audio"):
        return _stack_tree(kv(cfg, batch, capacity, dtype, device),
                           cfg.n_layers)
    if cfg.arch_type == "moe":
        one = kv(cfg, batch, capacity, dtype, device)
        return {"moe": _stack_tree(one, cfg.n_layers - cfg.dense_layers),
                "dense": (_stack_tree(one, cfg.dense_layers)
                          if cfg.dense_layers else None)}
    if cfg.arch_type == "hybrid":
        g, tail = _zamba_split(cfg)
        st = ssm_mod.init_ssm_state(cfg, batch, dtype, device)
        return {"groups": _stack_tree(_stack_tree(st, cfg.attn_every), g),
                "tail": _stack_tree(st, tail) if tail else None,
                "shared": _stack_tree(
                    attn.init_kv_cache(cfg, batch, capacity, dtype, device),
                    g)}
    if cfg.arch_type == "ssm":
        g, per = _xlstm_groups(cfg)
        m = xlstm_mod.init_mlstm_state(cfg, batch, device)
        s = xlstm_mod.init_slstm_state(cfg, batch, device)
        return (_stack_tree(_stack_tree(m, per), g), _stack_tree(s, g))
    raise ValueError(cfg.arch_type)


def decode_step(params, caches, batch, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16, window: Optional[int] = None):
    """One-token decode.  batch["tokens"]: (B, 1) (audio: (B, K, 1));
    ``pos``: tokens already in the cache.  Returns (logits for the new
    token, caches), the caches updated in place."""
    window = cfg.sliding_window if window is None else window
    x, _ = _embed_input(params, batch, cfg, dtype)

    def dense_stack(blocks, cs, x):
        for l in range(blocks["ln1"].shape[0]):
            x, _ = _dense_block_dec(_layer(blocks, l), x, _layer(cs, l), pos,
                                    cfg, window=window)
        return x

    if cfg.arch_type in ("dense", "vlm", "audio"):
        x = dense_stack(params["blocks"], caches, x)

    elif cfg.arch_type == "moe":
        if cfg.dense_layers:
            x = dense_stack(params["dense_blocks"], caches["dense"], x)
        blocks = params["moe_blocks"]
        for l in range(blocks["ln1"].shape[0]):
            x, _ = _moe_block_dec(_layer(blocks, l), x,
                                  _layer(caches["moe"], l), pos, cfg,
                                  window=window)

    elif cfg.arch_type == "hybrid":
        g, tail = _zamba_split(cfg)
        for gi in range(g):
            pg = _layer(params["mamba_groups"], gi)
            sg = _layer(caches["groups"], gi)
            for j in range(cfg.attn_every):
                st = _layer(sg, j)
                x, new = _residual_dec(ssm_mod.ssm_decode, _layer(pg, j), x,
                                       st, cfg)
                _assign(st, new)
            x, _ = _dense_block_dec(params["shared_attn"], x,
                                    _layer(caches["shared"], gi), pos, cfg,
                                    window=window)
        for j in range(tail):
            st = _layer(caches["tail"], j)
            x, new = _residual_dec(ssm_mod.ssm_decode,
                                   _layer(params["mamba_tail"], j), x, st,
                                   cfg)
            _assign(st, new)

    elif cfg.arch_type == "ssm":
        g, per = _xlstm_groups(cfg)
        for gi in range(g):
            pm, sm = _layer(params["mlstm_groups"], gi), _layer(caches[0], gi)
            for j in range(per):
                st = _layer(sm, j)
                x, new = _residual_dec(xlstm_mod.mlstm_decode,
                                       _layer(pm, j), x, st, cfg)
                _assign(st, new)
            st = _layer(caches[1], gi)
            x, new = _residual_dec(xlstm_mod.slstm_decode,
                                   _layer(params["slstm_blocks"], gi), x, st,
                                   cfg)
            _assign(st, new)
    else:
        raise ValueError(cfg.arch_type)

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
    """The decoder as an ``nn.Module``: the parameter tree registered under
    its keys (frozen: the flash kernel is forward only), :meth:`params` the
    plain tree that :func:`forward` and :func:`decode_step` take."""

    def __init__(self, cfg: ModelConfig, params: Dict, *,
                 attn_impl: str = "kernel"):
        super().__init__()
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
