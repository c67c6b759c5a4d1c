#!/usr/bin/env python3
"""How far two bf16 computations of one LM family drift apart, and how far
each is from fp32: the yardstick for phase 5b's route comparison.

For each arch given (default: every one of ``chip_smoke.FAMILIES`` but
deepseek-v3-671b, whose fp32 pass would cast 15 GB expert stacks beside
its 52 GB of weights), the
phase's model (its depth cut, its seeded bf16 weights, its 2 x 2048 batch)
runs one prefill four times: the kernel route and the plain route in bf16;
the plain route in fp32 on the same bf16 weights; and the plain route in
bf16 again with one bf16 ulp (2^-8, relative, seeded) of noise on the
input embeddings.  Prints one JSON line per arch: the last position's
logits of each pair as max |a - b| over the largest |logit| of the second
(``kernel_vs_plain``, ``kernel_vs_fp32``, ``plain_vs_fp32``,
``plain_vs_embed_ulp_noise``), and the relative rms distance of the two
bf16 routes' residual streams entering each dense-block call (for zamba2
the shared attention block's).  Phase 5b's bound is 3e-2 of that
largest logit; a model whose ``plain_vs_embed_ulp_noise`` is above it
cannot tell two bf16 routes apart at the bound when run free.

    python3 tools/lm_route_sensitivity.py [zamba2-7b musicgen-medium ...]

Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def main(archs):
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf

    if not torch.cuda.is_available():
        sys.exit("lm_route_sensitivity: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build()
    families = {a: (i, cut) for i, (a, cut, _) in
                enumerate(chip_smoke.FAMILIES)}
    for arch in archs or [a for a in families if a != "deepseek-v3-671b"]:
        i, cut = families[arch]
        cfg = dataclasses.replace(get_config(arch), **cut)
        gen = torch.Generator("cuda").manual_seed(50 + i)   # phase 5b's
        params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
        batch = lm_steps.make_batch(cfg, chip_smoke.FAM_BATCH,
                                    chip_smoke.FAM_PROMPT, gen)
        out = {"arch": arch, "n_layers": cfg.n_layers,
               "device": torch.cuda.get_device_name(0)}
        with torch.inference_mode():
            last, streams = {}, {}
            for impl in ("kernel", "torch"):
                with chip_smoke._FedBlocks() as rec:
                    logits, _, _ = tf.forward(params, batch, cfg,
                                              dtype=torch.bfloat16,
                                              remat=False, attn_impl=impl)
                last[impl] = lm_steps.last_logits(logits, cfg).float()
                streams[impl] = [x.float() for x in rec.inputs]
                del logits, rec
            logits, _, _ = tf.forward(params, batch, cfg,
                                      dtype=torch.float32, remat=False,
                                      attn_impl="torch")
            fp32 = lm_steps.last_logits(logits, cfg)
            del logits
            real_embed = tf._embed_input
            noise_gen = torch.Generator("cuda").manual_seed(1)

            def noisy(*args, **kw):
                x, mask = real_embed(*args, **kw)
                eps = torch.randn(x.shape, generator=noise_gen,
                                  device=x.device)
                return (x.float() * (1 + 2 ** -8 * eps)).to(x.dtype), mask
            tf._embed_input = noisy
            try:
                logits, _, _ = tf.forward(params, batch, cfg,
                                          dtype=torch.bfloat16, remat=False,
                                          attn_impl="torch")
            finally:
                tf._embed_input = real_embed
            noisy_last = lm_steps.last_logits(logits, cfg)
        out.update(
            max_abs_logit=float(last["torch"].abs().max()),
            kernel_vs_plain=_rel(last["kernel"], last["torch"]),
            kernel_vs_fp32=_rel(last["kernel"], fp32),
            plain_vs_fp32=_rel(last["torch"], fp32),
            plain_vs_embed_ulp_noise=_rel(noisy_last, last["torch"]),
            stream_rel_rms_by_block=[
                float((a - b).norm() / b.norm())
                for a, b in zip(streams["kernel"], streams["torch"])])
        print(json.dumps(out), flush=True)
        del params, batch, streams, last, fp32, noisy_last, logits
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
