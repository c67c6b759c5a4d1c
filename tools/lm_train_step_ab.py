#!/usr/bin/env python3
"""Compare the LM train step of two versions of the port on one card:
``chip_smoke.py``'s phase-10a step (``lm_steps.build_train_step``: the
arch's optimizer and ``MICROBATCHES``, remat, plain attention, bf16
params) for one arch at its full width with its depth and sequence cut,
1 warm-up + 3 timed steps from the same seeded weights and batch, run
against the port of each source tree given, in the order given.

    python3 tools/lm_train_step_ab.py [--arch xlstm-1.3b] [--layers 8]
        [--batch 8] [--seq 4096] build/parent . . build/parent

Each TREE is a checkout of the repository (for another commit, e.g. one
unpacked with ``git archive``); its ``src/repro_torch`` trains, each in a
process of its own.  Prints, per run, one JSON line: the tree, the arch
and its cut, the step times by CUDA events (ms), their median, the peak
of ``max_memory_allocated`` (GiB) and the losses.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import dataclasses, json, statistics, sys
sys.path[:0] = [{src!r}]
import torch
from repro_torch.configs import get_config
from repro_torch.launch import lm_steps
from repro_torch.models import transformer as tf

cfg = dataclasses.replace(get_config({arch!r}), n_layers={layers})
params = tf.init_model(torch.Generator("cuda").manual_seed(0), cfg,
                       dtype=lm_steps.PARAM_DTYPE)
optimizer, step = lm_steps.build_train_step(cfg)
opt_state = optimizer.init(params)
batch = lm_steps.train_batch(cfg, {batch}, {seq}, 0, "cuda")
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
ms, losses = [], []
for _ in range(4):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    params, opt_state, m = step(params, opt_state, batch, 1e-5)
    t1.record()
    torch.cuda.synchronize()
    ms.append(t0.elapsed_time(t1))
    losses.append(float(m["loss"]))
print(json.dumps({{"tree": {tree!r}, "arch": cfg.name,
                  "n_layers": cfg.n_layers, "batch": {batch}, "seq": {seq},
                  "microbatches": lm_steps.MICROBATCHES.get({arch!r}, 1),
                  "step_ms": ms, "median_step_ms": statistics.median(ms[1:]),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "losses": losses}}), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    for tree in args.trees:
        src = Path(tree).resolve() / "src"
        if not (src / "repro_torch" / "__init__.py").exists():
            sys.exit(f"lm_train_step_ab: {src / 'repro_torch'} not found")
        subprocess.run([sys.executable, "-c", CHILD.format(
            src=str(src), tree=tree, arch=args.arch, layers=args.layers,
            batch=args.batch, seq=args.seq)], check=True, timeout=900)


if __name__ == "__main__":
    main()
