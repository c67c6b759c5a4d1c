"""LM train, prefill and decode steps of every architecture family, run on
the card: dense (codeqwen1.5-7b, qwen1.5-0.5b, qwen2-72b, qwen3-14b), MoE
(dbrx-132b; deepseek-v3-671b with MLA), the Mamba2 hybrid (zamba2-7b),
xLSTM (xlstm-1.3b), VLM (llava-next-34b) and audio (musicgen-medium).

The counterparts of ``decode_window`` / ``cache_capacity``, of the
optimizer and microbatch choices (``ADAFACTOR_ARCHS``, ``MICROBATCHES``,
``pick_optimizer``) and of the step bodies that
``src/repro/launch/dryrun.py`` lowers (``build_lowerable``,
``build_local_sgd``): here the steps run instead of being lowered, with no
mesh and no memory analysis.

* train: ``make_train_step`` with the arch's optimizer, microbatches and
  accumulator (bf16 for ``ADAFACTOR_ARCHS``, else fp32), bf16 params, the
  plain attention route, a batch from ``data/tokens.make_lm_batch``;
* local SGD: ``local_sgd_round``, H inner steps per pod, then one
  cross-pod mean (the paper's FedAvg across pods);
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
flash-attention launches; with ``--train`` it takes train steps on one
``make_lm_batch`` batch of ``--batch`` x ``--prompt-len`` (or local-SGD
rounds with ``--pods`` > 1) and prints each step's loss and time, the
tokens/s, the 6·N·D share of the card's bf16 peak and the peak memory::

    python -m repro_torch.launch.lm_steps --arch qwen3-14b --layers 8 \\
        --batch 2 --prompt-len 4096 --new-tokens 32
    python -m repro_torch.launch.lm_steps --arch zamba2-7b --device cpu \\
        --reduced --prompt-len 64 --new-tokens 4
    python -m repro_torch.launch.lm_steps --train --arch qwen3-14b \\
        --layers 4 --batch 8 --prompt-len 4096 --steps 4
    python -m repro_torch.launch.lm_steps --train --arch qwen1.5-0.5b \\
        --batch 4 --prompt-len 1024 --pods 2 --inner-steps 4 --steps 8 \\
        --lr 1e-4

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

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import local_sgd
from repro_torch.data import tokens
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.serving.registry import resolve_device

LONG_WINDOW = 8192
PARAM_DTYPE = torch.bfloat16

# optimizer per arch: adafactor where Adam's fp32 m+v would not fit
ADAFACTOR_ARCHS = ("deepseek-v3-671b",)

# gradient-accumulation depth for train_4k, by model size (activation
# memory scales with global_batch / microbatches)
MICROBATCHES = {
    "qwen1.5-0.5b": 1, "musicgen-medium": 2, "xlstm-1.3b": 2,
    "codeqwen1.5-7b": 2, "zamba2-7b": 2, "qwen3-14b": 4,
    "llava-next-34b": 8, "qwen2-72b": 8, "dbrx-132b": 8,
    "deepseek-v3-671b": 16,
}


def arch_id(cfg: ModelConfig) -> str:
    """The registry id of ``cfg``, also for its ``reduced()`` variant."""
    return cfg.name.removesuffix("-reduced")


def pick_optimizer(arch: str):
    if arch in ADAFACTOR_ARCHS:
        return optim.adafactor()
    return optim.adam()


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


# ------------------------------------------------------------------ train
def train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                device="cpu") -> Dict:
    """``make_lm_batch`` as tensors on ``device``: ids int64, VLM media
    fp32.  The train layout: tokens / labels (B, S), audio (B, K, S), VLM
    tokens (B, S - n_media) with labels (B, S) and media."""
    nb = tokens.make_lm_batch(cfg, batch, seq, seed)
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind == "i" else torch.float32)
        for k, v in nb.items()}


def build_train_step(cfg: ModelConfig, *, beta: float = 1.0,
                     remat: bool = True, microbatches: Optional[int] = None,
                     dtype=torch.bfloat16, attn_impl: str = "torch"):
    """(optimizer, train_step) for ``cfg`` as ``build_lowerable``'s train
    branch makes them: the arch's optimizer, its ``MICROBATCHES`` unless
    given, a bf16 accumulator for ``ADAFACTOR_ARCHS`` and fp32 otherwise.
    The step updates the params and state tensors in place."""
    arch = arch_id(cfg)
    optimizer = pick_optimizer(arch)
    mb = MICROBATCHES.get(arch, 1) if microbatches is None else microbatches
    accum = torch.bfloat16 if arch in ADAFACTOR_ARCHS else torch.float32
    step = tf.make_train_step(cfg, optimizer, beta=beta, dtype=dtype,
                              remat=remat, microbatches=mb,
                              accum_dtype=accum, attn_impl=attn_impl)
    return optimizer, step


def stack_pods(tree, n_pods: int):
    """``tree`` (params or an optimizer state) repeated on a new leading
    pod axis, one replica a pod."""
    return tree_map(lambda t: None if t is None else
                    t.expand((n_pods,) + tuple(t.shape)).clone(), tree)


def _pod(tree, i: int):
    return tree_map(lambda t: None if t is None else t[i], tree)


def _write(dst, src) -> None:
    """Copy ``src``'s leaves into the views ``dst`` where they are other
    tensors (the step writes params and moments in place; the step count
    is a new tensor)."""
    tree_map(lambda d, s: None if d is None or d is s else d.copy_(s),
             dst, src)


def pod_steps(step, params_p, opt_p, batches: Dict, lr):
    """H inner steps per pod, with no cross-pod traffic: ``params_p`` /
    ``opt_p`` are trees with a leading pod axis (:func:`stack_pods`),
    updated in place; ``batches`` (P, H, B, ...) per pod and inner step.
    Returns the losses (P, H)."""
    n_pods, H = next(iter(batches.values())).shape[:2]
    losses = []
    for i in range(n_pods):
        pv, ov = _pod(params_p, i), _pod(opt_p, i)
        p, o = pv, ov
        pod_losses = []
        for h in range(H):
            p, o, m = step(p, o, {k: v[i, h] for k, v in batches.items()},
                           lr)
            pod_losses.append(m["loss"])
        _write(pv, p)
        _write(ov, o)
        losses.append(torch.stack(pod_losses))
    return torch.stack(losses)


def sync_pods(params_p):
    """The cross-pod parameter mean (the paper's FedAvg aggregation,
    ``local_sgd.fedavg_outer``) copied into every replica.  Returns the
    drift just before it, sum_leaves |pod i - pod 0| over the pods, in
    fp32."""
    drift = sum(torch.sum(torch.abs(t[1:].float() - t[:1].float()))
                for t in tree_leaves(params_p))
    mean = local_sgd.fedavg_outer(params_p)
    tree_map(lambda t, m: t.copy_(m.expand_as(t)), params_p, mean)
    return drift


def local_sgd_round(step, params_p, opt_p, batches: Dict, lr):
    """One local-SGD round, ``build_local_sgd``'s ``round_fn``:
    :func:`pod_steps` then :func:`sync_pods`.  Returns (losses (P, H),
    drift)."""
    losses = pod_steps(step, params_p, opt_p, batches, lr)
    return losses, sync_pods(params_p)


def _share(device: torch.device, flops: float, seconds: float):
    """The share of the card's bf16 peak; None for a CPU run."""
    if device.type != "cuda":
        return None
    return roofline.peak_share(flops, seconds)


def _peak_gib(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def train(cfg: ModelConfig, device: torch.device, *, batch: int, seq: int,
          steps: int, lr: float, beta: float = 1.0,
          microbatches: Optional[int] = None, pods: int = 1,
          inner_steps: int = 4, seed: int = 0) -> Dict:
    """The ``--train`` run: bf16 params seeded on ``device``; ``steps``
    train steps on one ``make_lm_batch`` batch at a constant ``lr``, or,
    with ``pods`` > 1, ``steps // inner_steps`` local-SGD rounds on the
    pods' own batches (round r, pod i, inner step h: seed ``seed + 1 +
    (r * pods + i) * inner_steps + h``).  Times end in a synchronise; the
    share is 6·N·D over the card's bf16 peak (None on the CPU, as the peak
    memory)."""
    gen = torch.Generator(device).manual_seed(seed)
    params = tf.init_model(gen, cfg, dtype=PARAM_DTYPE)
    optimizer, step = build_train_step(cfg, beta=beta,
                                       microbatches=microbatches)
    opt_state = optimizer.init(params)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": cfg.num_params(), "batch": batch, "seq": seq,
           "optimizer": ("adafactor" if arch_id(cfg) in ADAFACTOR_ARCHS
                         else "adam"),
           "microbatches": (MICROBATCHES.get(arch_id(cfg), 1)
                            if microbatches is None else microbatches),
           "lr": lr, "beta": beta, "pods": pods}
    ops.reset_launch_counts()
    if pods == 1:
        b = train_batch(cfg, batch, seq, seed, device)
        shape = InputShape("train", seq, batch, "train")
        losses, ms = [], []
        for _ in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, b, lr)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        warm = ms[1:] or ms
        mean_s = sum(warm) / len(warm) / 1e3
        out.update(losses=losses, step_ms=ms,
                   tokens_per_s=batch * seq / mean_s,
                   peak_share=_share(device, roofline.model_flops(cfg, shape),
                                     mean_s))
    else:
        rounds = steps // inner_steps
        if rounds < 1 or steps % inner_steps:
            raise ValueError(f"--steps {steps} is not a multiple of "
                             f"--inner-steps {inner_steps}")
        params_p, opt_p = stack_pods(params, pods), stack_pods(opt_state,
                                                               pods)
        del params, opt_state
        round_ms, pod_losses, drifts = [], [], []
        for r in range(rounds):
            bs = [[train_batch(cfg, batch, seq,
                               seed + 1 + (r * pods + i) * inner_steps + h,
                               device)
                   for h in range(inner_steps)] for i in range(pods)]
            batches = {k: torch.stack([torch.stack([b[k] for b in pod])
                                       for pod in bs]) for k in bs[0][0]}
            _sync(device)
            t0 = time.perf_counter()
            losses, drift = local_sgd_round(step, params_p, opt_p, batches,
                                            lr)
            _sync(device)
            round_ms.append((time.perf_counter() - t0) * 1e3)
            pod_losses.append(losses.tolist())
            drifts.append(float(drift))
        warm = round_ms[1:] or round_ms
        mean_s = sum(warm) / len(warm) / 1e3
        n_tok = pods * inner_steps * batch * seq
        out.update(inner_steps=inner_steps, pod_losses=pod_losses,
                   drift=drifts, round_ms=round_ms,
                   tokens_per_s=n_tok / mean_s,
                   peak_share=_share(device, roofline.model_flops(
                       cfg, InputShape("train", seq, batch * pods
                                       * inner_steps, "train")), mean_s))
    out.update(peak_gib=_peak_gib(device),
               flash_launches=ops.launch_counts()["flash_attention"],
               device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"))
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
                    help="positions of the prompt (VLM: media + text); "
                    "with --train the sequence length")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--attn-impl", default="kernel", choices=ATTN_IMPLS,
                    help="prefill attention (training takes 'torch')")
    ap.add_argument("--train", action="store_true",
                    help="train steps instead of prefill and decode")
    ap.add_argument("--steps", type=int, default=4,
                    help="train steps (per pod with --pods > 1)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: the arch's MICROBATCHES")
    ap.add_argument("--lr", type=float, default=1e-5,
                    help="constant; Adam moves each weight by ~lr at first, "
                    "so full-width models need a small one")
    ap.add_argument("--beta", type=float, default=1.0,
                    help="position weight exponent of the CE (1: plain CE)")
    ap.add_argument("--pods", type=int, default=1,
                    help="local-SGD pod replicas in this process")
    ap.add_argument("--inner-steps", type=int, default=4,
                    help="H: steps per pod between cross-pod syncs")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.train:
        print(json.dumps(train(
            cfg, device, batch=args.batch, seq=args.prompt_len,
            steps=args.steps, lr=args.lr, beta=args.beta,
            microbatches=args.microbatches, pods=args.pods,
            inner_steps=args.inner_steps, seed=args.seed)))
        return
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
