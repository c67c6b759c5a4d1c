"""LM prefill and decode steps of every architecture family, run on the
card: dense (codeqwen1.5-7b, qwen1.5-0.5b, qwen2-72b, qwen3-14b), MoE
(dbrx-132b; deepseek-v3-671b with MLA), the Mamba2 hybrid (zamba2-7b),
xLSTM (xlstm-1.3b), VLM (llava-next-34b) and audio (musicgen-medium).

The counterparts of ``decode_window`` / ``cache_capacity`` and of the
prefill and decode step bodies that ``src/repro/launch/dryrun.py`` lowers
(``build_lowerable``): here the steps run instead of being lowered, with no
mesh and no memory analysis.

* prefill: ``init_cache`` -> ``forward(..., caches=..., dtype=bf16,
  remat=False)`` -> the last position's logits and the filled caches;
* decode: one ``decode_step`` against the caches.

A batch is a dict: ``tokens`` (B, S), or (B, K, S) for audio, whose last
logits are ``logits[:, :, -1:]`` and whose greedy pick is an argmax per
codebook; a VLM batch also carries ``media`` (B, n_media, embed_dim), the
pre-projector patch embeddings, prepended, so a prompt of S positions
holds S - n_media text tokens.

As a command it seeds a model on the device, prefills random prompt tokens
(and seeded media embeddings for the VLM), takes greedy decode steps and
prints one JSON line with the prefill time, the decode tokens/s and the
flash-attention launches::

    python -m repro_torch.launch.lm_steps --arch qwen3-14b --layers 8 \\
        --batch 2 --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.lm_steps --arch zamba2-7b --device cpu \\
        --reduced --prompt-len 64 --new-tokens 4

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

from repro_torch.configs import ARCH_IDS, get_config
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


def seq_len(batch, cfg: ModelConfig) -> int:
    """Positions a prefill of ``batch`` fills: the text tokens, plus the
    media tokens prepended in a VLM batch."""
    n = batch["tokens"].shape[-1]
    if cfg.arch_type == "vlm" and "media" in batch:
        n += batch["media"].shape[1]
    return n


def last_logits(logits, cfg: ModelConfig):
    """The last position's logits: (B, 1, V), audio (B, K, 1, V)."""
    return logits[:, :, -1:] if cfg.arch_type == "audio" else logits[:, -1:]


def greedy(logits, cfg: ModelConfig):
    """The next tokens of one position's logits: (B, 1), audio an argmax
    per codebook, (B, K, 1)."""
    return logits.argmax(-1) if cfg.arch_type == "audio" \
        else logits[:, -1].argmax(-1, keepdim=True)


def prefill_step(params, batch: Dict, cfg: ModelConfig, *, capacity: int,
                 window: Optional[int] = None, attn_impl: str = "kernel"):
    """batch -> (last position's logits, filled caches)."""
    caches = tf.init_cache(cfg, batch["tokens"].shape[0], capacity,
                           device=batch["tokens"].device)
    logits, _, (caches, _, _) = tf.forward(
        params, batch, cfg, dtype=torch.bfloat16, window=window,
        caches=caches, remat=False, attn_impl=attn_impl)
    return last_logits(logits, cfg).clone(), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B, 1) (audio: (B, K, 1)) at position ``pos`` -> (logits,
    caches)."""
    return tf.decode_step(params, caches, {"tokens": token}, pos, cfg,
                          dtype=torch.bfloat16, window=window)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, batch: Dict, cfg: ModelConfig, new_tokens: int, *,
             attn_impl: str = "kernel", window: Optional[int] = None,
             feed=None) -> Dict:
    """Prefill ``batch``, then ``new_tokens`` decode steps.

    Each step feeds the greedy pick of the previous logits, or column t of
    ``feed`` (B, new_tokens), audio (B, K, new_tokens), when given, so two
    routes can be held against each other on the same tokens.  Returns
    the prefill's last logits, each step's logits, the tokens fed, and
    host wall times that end in a synchronise.
    """
    B, S = batch["tokens"].shape[0], seq_len(batch, cfg)
    shape = InputShape("generate", S + new_tokens, B, "prefill")
    dev = batch["tokens"].device
    _sync(dev)
    t0 = time.perf_counter()
    last, caches = prefill_step(params, batch, cfg,
                                capacity=cache_capacity(cfg, shape),
                                window=window, attn_impl=attn_impl)
    _sync(dev)
    t1 = time.perf_counter()
    logits, fed = [], []
    prev = last
    for t in range(new_tokens):
        tok = greedy(prev, cfg) if feed is None else feed[..., t:t + 1]
        prev, caches = decode_step(params, caches, tok, S + t, cfg,
                                   window=window)
        logits.append(prev)
        fed.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return {"prefill_logits": last, "logits": logits,
            "tokens": torch.cat(fed, dim=-1) if fed else None,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int,
               generator: torch.Generator) -> Dict:
    """A random prompt of ``prompt_len`` positions on ``generator``'s
    device: token ids, (B, K, S) for audio; for a VLM the config's
    n_media_tokens media embeddings (standard normal) and the rest text."""
    dev = generator.device
    if cfg.arch_type == "audio":
        shape = (batch, cfg.frontend.n_codebooks, prompt_len)
        return {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                        generator=generator, device=dev)}
    out = {}
    n_text = prompt_len
    if cfg.arch_type == "vlm":
        f = cfg.frontend
        n_text -= f.n_media_tokens
        if n_text < 1:
            raise ValueError(f"{cfg.name}: a prompt of {prompt_len} "
                             f"positions leaves no text after "
                             f"{f.n_media_tokens} media tokens")
        out["media"] = torch.randn((batch, f.n_media_tokens, f.embed_dim),
                                   generator=generator, device=dev)
    out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, n_text),
                                  generator=generator, device=dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="architectures: " + ", ".join(ARCH_IDS))
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut n_layers to this (0: the config's)")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() smoke variant (for the CPU)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4096,
                    help="positions of the prompt (VLM: media + text)")
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
    batch = make_batch(cfg, args.batch, args.prompt_len, gen)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = generate(params, batch, cfg, args.new_tokens,
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
