"""Dense-LM prefill and decode steps, run on the card.

The counterparts of ``decode_window`` / ``cache_capacity`` and of the
prefill and decode step bodies that ``src/repro/launch/dryrun.py`` lowers
(``build_lowerable``): here the steps run instead of being lowered, with no
mesh and no memory analysis.

* prefill: ``init_cache`` -> ``forward(..., caches=..., dtype=bf16,
  remat=False)`` -> the last position's logits and the filled caches;
* decode: one ``decode_step`` against the caches.

As a command it seeds a model on the device, prefills random prompt tokens,
takes greedy decode steps and prints one JSON line with the prefill time,
the decode tokens/s and the flash-attention launches::

    python -m repro_torch.launch.lm_steps --arch qwen3-14b --layers 8 \\
        --batch 2 --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.lm_steps --device cpu --reduced \\
        --prompt-len 64 --new-tokens 4

The device defaults to the CUDA card and raises without one; ``--device
cpu`` runs the plain versions, and its times are host times on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.serving.registry import resolve_device

LONG_WINDOW = 8192
PARAM_DTYPE = torch.bfloat16


def decode_window(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.name == "long_500k" and cfg.arch_type in (
            "dense", "vlm", "audio", "moe", "hybrid"):
        return LONG_WINDOW
    return cfg.sliding_window


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    w = decode_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def prefill_step(params, tokens, cfg: ModelConfig, *, capacity: int,
                 window: Optional[int] = None, attn_impl: str = "kernel"):
    """tokens (B, S) -> (last position's logits (B, 1, V), filled caches)."""
    caches = tf.init_cache(cfg, tokens.shape[0], capacity,
                           device=tokens.device)
    logits, _, (caches, _, _) = tf.forward(
        params, {"tokens": tokens}, cfg, dtype=torch.bfloat16, window=window,
        caches=caches, remat=False, attn_impl=attn_impl)
    return logits[:, -1:].clone(), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B, 1) at position ``pos`` -> (logits (B, 1, V), caches)."""
    return tf.decode_step(params, caches, {"tokens": token}, pos, cfg,
                          dtype=torch.bfloat16, window=window)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prompt, cfg: ModelConfig, new_tokens: int, *,
             attn_impl: str = "kernel", window: Optional[int] = None,
             feed=None) -> Dict:
    """Prefill ``prompt`` (B, S), then ``new_tokens`` decode steps.

    Each step feeds the greedy pick of the previous logits, or column t of
    ``feed`` (B, new_tokens) when given, so two routes can be held against
    each other on the same tokens.  Returns the prefill's last logits, each
    step's logits, the tokens fed, and host wall times that end in a
    synchronise.
    """
    B, S = prompt.shape
    shape = InputShape("generate", S + new_tokens, B, "prefill")
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    last, caches = prefill_step(params, prompt, cfg,
                                capacity=cache_capacity(cfg, shape),
                                window=window, attn_impl=attn_impl)
    _sync(dev)
    t1 = time.perf_counter()
    logits, fed = [], []
    prev = last
    for t in range(new_tokens):
        tok = (prev[:, -1].argmax(-1, keepdim=True) if feed is None
               else feed[:, t:t + 1])
        prev, caches = decode_step(params, caches, tok, S + t, cfg,
                                   window=window)
        logits.append(prev)
        fed.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return {"prefill_logits": last, "logits": logits,
            "tokens": torch.cat(fed, dim=1) if fed else None,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut n_layers to this (0: the config's)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() smoke variant (for the CPU)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--attn-impl", default="kernel", choices=ATTN_IMPLS)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = tf.init_model(gen, cfg, dtype=PARAM_DTYPE)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = generate(params, prompt, cfg, args.new_tokens,
                       attn_impl=args.attn_impl)
    launches = ops.launch_counts()["flash_attention"]
    print(json.dumps({
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "attn_impl": args.attn_impl,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "prefill_s": out["prefill_s"],
        "decode_tokens_per_s": (args.batch * args.new_tokens
                                / out["decode_s"] if args.new_tokens else None),
        "flash_launches": launches,
        "tokens": out["tokens"][0].tolist() if args.new_tokens else []}))


if __name__ == "__main__":
    main()
