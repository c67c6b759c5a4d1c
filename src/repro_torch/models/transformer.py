"""The unified decoder over every architecture family: the counterpart of
``src/repro/models/transformer.py``.

One parameter tree + four entry points:

  * ``forward``          full sequence (train / prefill); optionally fills
    the caches, optionally stops before the LM head (``head=False``)
  * ``make_train_step``  loss, gradients (microbatch accumulation) and the
    optimizer update: ``train_step(params, opt_state, batch, lr)``
  * ``decode_step``      one token against the per-layer caches and states
  * ``init_cache``       the stacked per-layer caches (KV, MLA latent, SSM,
    xLSTM)

The tree has the JAX package's keys and layouts, so a JAX-made tree crosses
as it is (:func:`params_from_numpy`).  Homogeneous layer stacks carry a
leading layer axis; heterogeneous stacks are split into the JAX package's
groups:

  dense / vlm / audio : ``blocks``, one stack of [attention + MLP] blocks
  moe                 : ``dense_blocks`` (the first ``dense_layers``) and
                        ``moe_blocks``; ``mtp_proj`` / ``mtp_block`` /
                        ``mtp_ln`` when ``cfg.mtp`` (DeepSeek's
                        multi-token prediction, a loss term in training)
  hybrid (zamba2)     : ``mamba_groups`` (groups x attn_every) with ONE
                        ``shared_attn`` block applied after each group, and
                        ``mamba_tail`` for the remainder
  ssm (xlstm)         : ``mlstm_groups`` (groups x (slstm_every - 1)) and
                        ``slstm_blocks``, one sLSTM closing each group

plus ``embed_tokens`` (audio: ``cb_embed`` / ``cb_heads``), ``projector``
(vlm), ``final_norm`` and ``lm_head`` unless the embeddings are tied.  The
JAX package scans the stacks; here ``models.scan.loop`` walks views
of them (a leaf under autograd through :class:`_Unstack`), and walks the
microbatches, so that the dry run can count a stack as the reference's
cost model counts a scan.
Caches are stacked the same way and filled in place: the KV and latent
caches slot by slot, the SSM and xLSTM states by copying each layer's new
state into its slice.  Full-sequence attention takes ``attn_impl`` (see
:mod:`repro_torch.models.attention`); training takes the plain route
(``"torch"``), as the reference does.  ``remat`` runs each block under
``torch.utils.checkpoint`` where autograd records the pass, at the
reference's ``jax.checkpoint`` granularity: a dense or MoE block, each
Mamba2 block, each call of the shared attention block, each mLSTM and
sLSTM block.

On DTensor params under ``sharding.use_rules`` each block first gathers
its params' FSDP split (``gather_fsdp``: the per-layer all-gather of
FSDP, inside the checkpointed block so the recompute gathers again), and
the residual stream, logits and microbatches are constrained at the
reference's sites; without rules all of these return their input.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import optim
from repro_torch.configs.base import ModelConfig
from repro_torch.core.losses import chunked_weighted_ce
from repro_torch.models import attention as attn
from repro_torch.models import frontends
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, embed, init_embedding,
                                       init_mlp, mlp, rms_norm,
                                       tree_from_numpy, tree_leaves, tree_map)
from repro_torch.models.scan import loop
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import (gather_fsdp, matmul, reshape,
                                        whole_last)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked tree, as views."""
    return _map(lambda t: t[l], tree)


class _Unstack(torch.autograd.Function):
    """(L, ...) -> its L rows, as views; the backward stacks the rows'
    gradients once (zeros for a row that had none), as the VJP of a scan
    over stacked params gives them.  Indexed row by row, autograd would
    give each row's gradient as a zero-padded (L, ...) copy and sum the L
    copies."""

    @staticmethod
    def forward(ctx, t):
        ctx.set_materialize_grads(False)
        return tuple(t[l] for l in range(t.shape[0]))

    @staticmethod
    def backward(ctx, *grads):
        like = next((g for g in grads if g is not None), None)
        if like is None:
            return None
        return torch.stack([torch.zeros_like(like) if g is None else g
                            for g in grads])


def _layers(tree, n: int):
    """The ``n`` layers of a stacked tree, as views: a leaf that
    autograd records goes through :class:`_Unstack`."""
    def rows(t):
        if torch.is_grad_enabled() and t.requires_grad:
            return _Unstack.apply(t)
        return tuple(t[l] for l in range(n))
    cols = _map(rows, tree)
    return [_map(lambda r: r[l], cols) for l in range(n)]


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
def _pre_norm(x, scale, cfg: ModelConfig):
    """A block's input norm; on a mesh its output is gathered whole over
    d once for the block's products (the norm itself splits d)."""
    return whole_last(rms_norm(x, scale, cfg.norm_eps))


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
    p = gather_fsdp(p)
    h = _pre_norm(x, p["ln1"], cfg)
    a, cache = _attend_fwd(p["attn"], h, cfg, cache, window, attn_impl)
    x = x + a
    h = _pre_norm(x, p["ln2"], cfg)
    return constrain(x + mlp(p["mlp"], h), "batch", None, "embed"), cache


def _dense_block_dec(p, x, cache, pos, cfg: ModelConfig, *, window=0):
    p = gather_fsdp(p)
    h = _pre_norm(x, p["ln1"], cfg)
    a, cache = _attend_dec(p["attn"], h, cache, pos, cfg, window)
    x = x + a
    h = _pre_norm(x, p["ln2"], cfg)
    return x + mlp(p["mlp"], h), cache


def _moe_block_fwd(p, x, cfg: ModelConfig, *, cache=None, window=0,
                   attn_impl="kernel"):
    p = gather_fsdp(p)
    h = _pre_norm(x, p["ln1"], cfg)
    a, cache = _attend_fwd(p["attn"], h, cfg, cache, window, attn_impl)
    x = x + a
    h = _pre_norm(x, p["ln2"], cfg)
    ff, aux = moe_mod.moe_ffn(p["moe"], h, cfg)
    return constrain(x + ff, "batch", None, "embed"), cache, aux


def _moe_block_dec(p, x, cache, pos, cfg: ModelConfig, *, window=0):
    p = gather_fsdp(p)
    h = _pre_norm(x, p["ln1"], cfg)
    a, cache = _attend_dec(p["attn"], h, cache, pos, cfg, window)
    x = x + a
    h = _pre_norm(x, p["ln2"], cfg)
    ff, _ = moe_mod.moe_ffn(p["moe"], h, cfg)
    return x + ff, cache


def _residual_fwd(forward_fn, p, x, cfg: ModelConfig):
    """A Mamba2 / mLSTM / sLSTM block over the full sequence from a zero
    state: x + inner(norm(x)), and the inner block's final state."""
    p = gather_fsdp(p)
    inner = p["ssm"] if "ssm" in p else p["inner"]
    o, st = forward_fn(inner, _pre_norm(x, p["ln1"], cfg), cfg)
    return constrain(x + o, "batch", None, "embed"), st


def _residual_dec(decode_fn, p, x, st, cfg: ModelConfig):
    """One token of such a block against its state."""
    p = gather_fsdp(p)
    inner = p["ssm"] if "ssm" in p else p["inner"]
    o, st = decode_fn(inner, _pre_norm(x, p["ln1"], cfg), st, cfg)
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


def _head_weights(params, cfg: ModelConfig):
    return (params["embed_tokens"].T if cfg.tie_embeddings
            else params["lm_head"])


def _lm_logits(params, h, cfg: ModelConfig):
    if cfg.arch_type == "audio":
        return frontends.codebook_logits(params, h)      # (B,K,S,V)
    return constrain(matmul(h, _head_weights(params, cfg).to(h.dtype)),
                     "batch", None, "act_vocab")


# ===================================================================== forward
def forward(params, batch, cfg: ModelConfig, *, dtype=torch.bfloat16,
            window: Optional[int] = None, caches=None, remat: bool = True,
            attn_impl: str = "kernel", head: bool = True):
    """Full-sequence pass.  Returns (logits, aux_loss, (caches, h,
    media_mask)); ``aux_loss`` is the MoE load-balance loss summed over
    the layers (0 elsewhere), logits (B, S, V) (audio: (B, K, S, V)), or
    None with ``head=False``: the train step's chunked CE computes its own
    logits from ``h``, and eager torch would compute the unused full head
    (the reference leaves it to XLA's dead-code elimination).

    ``caches`` (optional) are ``init_cache`` trees, filled in place
    (prefill mode).  ``window`` overrides ``cfg.sliding_window``.
    ``remat`` checkpoints each block when autograd records the pass and no
    cache is being filled.
    """
    window = cfg.sliding_window if window is None else window
    x, media_mask = _embed_input(params, batch, cfg, dtype)
    x = constrain(x, "batch", None, "embed")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fill = caches is not None
    ck = remat and torch.is_grad_enabled() and not fill

    def run(fn, *args):
        if ck:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def cache_of(tree, l):
        return None if tree is None else _layer(tree, l)

    def part(key):
        return caches[key] if fill else None

    def dense(x, p, c):
        return _dense_block_fwd(p, x, cfg, cache=c, window=window,
                                attn_impl=attn_impl)[0]

    def moe(x, p, c):
        x, _, a = _moe_block_fwd(p, x, cfg, cache=c, window=window,
                                 attn_impl=attn_impl)
        return x, a

    def residual(fn, p, x, dst):
        """A Mamba2 / mLSTM / sLSTM block; its final state is copied into
        the cache slice ``dst`` when filling."""
        if dst is None:
            return run(lambda x, p: _residual_fwd(fn, p, x, cfg)[0], x, p)
        x, st = _residual_fwd(fn, p, x, cfg)
        _assign(dst, st)
        return x

    def stack(n, trip, x):
        """``trip(l, x) -> x`` over ``n`` identical layers (a scan)."""
        return loop(n, lambda l, x: (trip(l, x), None), x)[0]

    def dense_stack(blocks, cs, x):
        n = blocks["ln1"].shape[0]
        ps = _layers(blocks, n)
        return stack(n, lambda l, x: run(dense, x, ps[l], cache_of(cs, l)),
                     x)

    if cfg.arch_type in ("dense", "vlm", "audio"):
        x = dense_stack(params["blocks"], caches, x)

    elif cfg.arch_type == "moe":
        if cfg.dense_layers:
            x = dense_stack(params["dense_blocks"], part("dense"), x)
        n = params["moe_blocks"]["ln1"].shape[0]
        ps = _layers(params["moe_blocks"], n)

        def moe_layer(l, carry):
            x, a = run(moe, carry[0], ps[l], cache_of(part("moe"), l))
            return (x, carry[1] + a), None
        (x, aux_total), _ = loop(n, moe_layer, (x, aux_total))

    elif cfg.arch_type == "hybrid":
        g, tail = _zamba_split(cfg)
        groups = _layers(params["mamba_groups"], g)

        def mamba_group(gi, x):
            pg = _layers(groups[gi], cfg.attn_every)
            sg = cache_of(part("groups"), gi)
            x = stack(cfg.attn_every, lambda j, x: residual(
                ssm_mod.ssm_forward, pg[j], x, cache_of(sg, j)), x)
            return run(dense, x, params["shared_attn"],
                       cache_of(part("shared"), gi))
        x = stack(g, mamba_group, x)
        if tail:
            pt = _layers(params["mamba_tail"], tail)
            x = stack(tail, lambda j, x: residual(
                ssm_mod.ssm_forward, pt[j], x, cache_of(part("tail"), j)), x)

    elif cfg.arch_type == "ssm":                          # xlstm
        g, per = _xlstm_groups(cfg)
        m_caches, s_caches = caches if fill else (None, None)
        mgroups = _layers(params["mlstm_groups"], g)
        sblocks = _layers(params["slstm_blocks"], g)

        def xlstm_group(gi, x):
            pm = _layers(mgroups[gi], per)
            sm = cache_of(m_caches, gi)
            x = stack(per, lambda j, x: residual(
                xlstm_mod.mlstm_forward, pm[j], x, cache_of(sm, j)), x)
            return residual(xlstm_mod.slstm_forward, sblocks[gi], x,
                            cache_of(s_caches, gi))
        x = stack(g, xlstm_group, x)
    else:
        raise ValueError(cfg.arch_type)

    h = constrain(rms_norm(x, params["final_norm"], cfg.norm_eps),
                  "batch", None, "embed")
    logits = _lm_logits(params, h, cfg) if head else None
    return logits, aux_total, (caches, h, media_mask)


# ===================================================================== train
def loss_fn(params, batch, cfg: ModelConfig, *, beta: float = 1.0,
            dtype=torch.bfloat16, remat: bool = True,
            attn_impl: str = "torch"):
    """(loss, {"ce", "aux"}) of one batch: the position-weighted CE
    (``beta``; 1 is plain CE) from ``h`` through the chunked head (audio:
    the mean over codebooks of each codebook head's CE; VLM: text
    positions only), plus the MoE aux loss, plus 0.3 x the MTP loss where
    ``cfg.mtp``.  Batch: ``tokens`` / ``labels`` (B, S) (audio (B, K, S);
    VLM tokens (B, S - n_media) and ``media``)."""
    _, aux, (_, h, media_mask) = forward(params, batch, cfg, dtype=dtype,
                                         remat=remat, attn_impl=attn_impl,
                                         head=False)
    if cfg.arch_type == "audio":
        K = cfg.frontend.n_codebooks
        lbl = batch["labels"]                            # (B,K,S)
        ce = sum(chunked_weighted_ce(h, params["cb_heads"][:, k, :],
                                     lbl[:, k], beta)
                 for k in range(K)) / K
    else:
        ce = chunked_weighted_ce(h, _head_weights(params, cfg),
                                 batch["labels"], beta, media_mask)
    loss = ce + aux
    if cfg.mtp:
        loss = loss + 0.3 * _mtp_loss(params, h, batch, cfg, beta,
                                      attn_impl=attn_impl)
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params, batch, cfg: ModelConfig, **kw):
    """(loss, parts, grads) of :func:`loss_fn` (keyword arguments passed
    on) with respect to every leaf of ``params``: grads is a tree like
    ``params``, in each leaf's dtype, zeros where a leaf is unused.  The
    leaves themselves are left as they are (grads flow through detached
    aliases of them)."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = loss_fn(tree, batch, cfg, **kw)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for g, t in zip(grads, leaves)])
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_map(lambda _: next(it), params))


def accumulate_grads(params, batch, cfg: ModelConfig, *,
                     microbatches: int = 1, accum_dtype=torch.float32, **kw):
    """:func:`value_and_grad` over ``microbatches`` slices of the batch's
    leading axis: the gradients summed in ``accum_dtype`` (in place, one
    microbatch's grads beside the sum), then divided by the count; loss
    and parts averaged.  One microbatch is :func:`value_and_grad` itself,
    grads in the params' dtype, as the reference skips its scan."""
    if microbatches == 1:
        return value_and_grad(params, batch, cfg, **kw)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into {microbatches} "
                         "microbatches")
    bs = n // microbatches
    # keep each microbatch batch-sharded: (mb, bs, ...) with bs on the
    # batch axes, as the reference splits it
    split = {k: constrain(reshape(v, microbatches, bs, *v.shape[1:]), None,
                          "batch", *((None,) * (v.ndim - 1)))
             for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype), params)

    def microbatch(i, _):
        mb = {k: v[i] for k, v in split.items()}
        loss, parts, g = value_and_grad(params, mb, cfg, **kw)
        tree_map(lambda a, b: a.add_(b.to(accum_dtype)), gsum, g)
        return None, (loss, parts)
    _, outs = loop(microbatches, microbatch, None)
    losses = [loss for loss, _ in outs]
    partss = [parts for _, parts in outs]
    tree_map(lambda a: a.div_(microbatches), gsum)
    parts = {k: torch.mean(torch.stack([p[k] for p in partss]))
             for k in partss[0]}
    return torch.mean(torch.stack(losses)), parts, gsum


def make_train_step(cfg: ModelConfig, optimizer, *, beta: float = 1.0,
                    dtype=torch.bfloat16, remat: bool = True,
                    microbatches: int = 1, accum_dtype=torch.float32,
                    attn_impl: str = "torch"):
    """Returns train_step(params, opt_state, batch, lr) -> (params,
    opt_state, metrics).  ``beta`` is the EW loss exponent (paper's EW-MSE
    transferred to position-weighted CE; beta=1 == plain CE).

    ``microbatches`` > 1 accumulates gradients over slices of the batch's
    leading axis (peak activation memory scales with the microbatch) into
    an ``accum_dtype`` sum: fp32 by default, bf16 for the 671B fit.  The
    update is the reference's ``p + u`` applied leaf by leaf into the given
    params and state tensors (:func:`repro_torch.optim.update_in_place`):
    at full width there is no room for a second copy of either, so the
    step returns the same params, updated.
    """
    def train_step(params, opt_state, batch, lr):
        loss, parts, grads = accumulate_grads(
            params, batch, cfg, microbatches=microbatches,
            accum_dtype=accum_dtype, beta=beta, dtype=dtype, remat=remat,
            attn_impl=attn_impl)
        opt_state = optim.update_in_place(optimizer, grads, opt_state, params,
                                          lr)
        return params, opt_state, {"loss": loss, **parts}

    return train_step


def _mtp_loss(params, h, batch, cfg: ModelConfig, beta: float, *,
              attn_impl: str = "torch"):
    """DeepSeek-V3 multi-token prediction: one extra block predicts t+2.

    h'_t = W_proj [RMSNorm(h_t); RMSNorm(Emb(label_t))] -> block -> head.
    """
    lbl = batch["labels"]
    emb = constrain(embed(params["embed_tokens"], lbl, h.dtype),  # token t+1
                    "batch", None, "embed")
    cat = torch.cat([rms_norm(h, params["mtp_ln"], cfg.norm_eps),
                     rms_norm(emb, params["mtp_ln"], cfg.norm_eps)], dim=-1)
    x = constrain(matmul(cat, params["mtp_proj"].to(h.dtype)),
                  "batch", None, "embed")
    x, _ = _dense_block_fwd(params["mtp_block"], x, cfg, attn_impl=attn_impl)
    h2 = constrain(rms_norm(x, params["final_norm"], cfg.norm_eps),
                   "batch", None, "embed")
    # labels for t+2: shift labels left by one; mask the last position
    lbl2 = torch.cat([lbl[:, 1:], lbl[:, -1:]], dim=1)
    mask = torch.cat([torch.ones_like(lbl[:, 1:], dtype=torch.bool),
                      torch.zeros_like(lbl[:, -1:], dtype=torch.bool)], dim=1)
    return chunked_weighted_ce(h2, _head_weights(params, cfg), lbl2, beta,
                               mask)


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
