#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch/``).

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the
forecast-serving path end to end (registry -> router -> bucketed engine ->
fused recurrent layers, one launch per layer) at the paper forecaster's
full width for the LSTM and a 2-layer GRU, checks the results against the
same engine on the CPU (the LSTM also from int8 weights, whose grids must
equal the CPU publish's bit for bit), profiles one full flush, times the
kernels at their paths' shapes beside cuDNN's sequence calls, drives the
dense-LM prefill and decode steps at qwen3-14b's full width (8 of its 40
layers) through the flash attention kernel (bf16: wgmma on the tensor
cores fed by TMA; fp32: the CUDA-core kernel; head dims 16, 32, 64, 112
and 128, each held against its plain version in phase 2b, hd 128, 112 and
64 timed in phase 4b), holds them against the plain attention route, runs
phase 5b, the LM families at full width and cut depth (codeqwen1.5-7b,
qwen2-72b, dbrx-132b, deepseek-v3-671b with MLA and MoE, zamba2-7b's
Mamba2 hybrid with its shared attention at hd 112, xlstm-1.3b, the
llava-next-34b VLM, musicgen-medium's 4 codebooks: a 2 x 2048 prefill
and 8 decode steps each, kernel route against plain route), then
trains the forecaster federatedly (the paper's Algorithm 1: 100 clients x
365 days, every local step's forward one launch of the layer kernel for
all clients, its backward the plain layer's VJP) on the kernel route
against the plain route, trains the same setting again under the privacy
pipeline (clip, DP noise, the 8-bit ring quantizer and secure aggregation:
ring-masked == clear bit for bit, epsilon, the stage's device time), runs
one round of that setting sharded over torch.distributed ranks (flat and
hierarchical: one NCCL rank, then four gloo ranks sharing the card, held
to the local round), runs semi-synchronous buffered rounds with stragglers
(500 buildings, m' = 48, flush at 32) and with dropouts, the ring and
secure aggregation (re-keyed cohorts: masked == clear bit for bit), kills
and resumes that run from its checkpoint bit for bit, trains the LM
(phase 10: qwen3-14b at full width and 4 layers through the train step of
``launch/lm_steps.py``, Adam over 4 microbatches on the plain attention
route with no flash launch, as the reference trains; bf16 against fp32;
every family's step on the card against the CPU; local SGD across two
pods of qwen1.5-0.5b), runs the paper's examples
(``examples/torch_*.py``: quickstart, the end-to-end example as it is and
under semi-sync with the privacy stack, the serving demo) on the layer
kernel (phase 11), holds the dry run's memory model against the card on
a 1 x 1 mesh (phase 12a: phase 10's train step and phase 5's prefill),
dry-runs qwen3-14b at every shape on the fake 16 x 16 production mesh and
deepseek-v3-671b's train step (cut in depth) on 2 x 16 x 16 (12b, host
processes started after phase 10), runs phase 5's prefill with DTensor
params on one NCCL rank through the flash kernel, bit-equal to phase 5
(12c), runs flcheck on the card (phase 13: the lint of the port's tree,
the round's hot-path guards at train-lstm's shape on the layer kernel,
the taint proofs of the local round and the semi-sync dispatch, the cost
audit against the committed baseline), and ends with one JSON status
line.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; without one (or outside a checkout of the repo) it
exits non-zero before printing any result.  Each phase prints one JSON
line; any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth,
# dense fp32 outside the tensor cores, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py: cells
# a recurrent layer past one step in bf16: the plain cell rounds its two
# products and their sum to bf16, the kernel sums in fp32, and the
# recurrence carries the difference (0.138 seen at H=256 with weights of
# std 0.3, T=8); against the plain cell in fp32 with the state rounded to
# bf16 every step, the kernel's own function, the step tolerance holds
LAYER_BF16_TOL = 0.2
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # and flash attention
REQUESTS_PER_CONSUMER = 8
CONSUMERS = 256
HISTORY_DAYS = 14

# the LM slice: qwen3-14b at full width, n_layers cut 40 -> 8; prefill_32k's
# batch 32 x 32768 cut to 2 x 4096; greedy decode steps after it
LM_ARCH, LM_LAYERS, LM_BATCH, LM_PROMPT, LM_NEW = "qwen3-14b", 8, 2, 4096, 32
# (B, S, Hq, Hkv, hd, window): the sweep of tests/test_kernels.py, an
# unaligned S, the LM slice's prefill shape, full and windowed; then the
# bf16 kernel's tile (128 rows / keys) and TMA box edges: S of 1, half a
# tile, a tile less and more one row, 4097; a window inside one tile and
# one across tiles; hd 16, 32, 64, 128; GQA 5:1 at hd 128; then the LM
# families' prefills (2 x 2048): musicgen at hd 64 (24 heads), zamba2's
# shared block at hd 112 (32 heads), and hd 112 with GQA 4:1, a window and
# an unaligned S
FLASH_SHAPES = [(2, 128, 4, 4, 32, 0), (2, 256, 8, 2, 64, 0),
                (1, 256, 4, 1, 64, 0), (1, 512, 2, 2, 32, 128),
                (3, 384, 6, 2, 16, 0), (2, 200, 4, 2, 64, 0),
                (1, 200, 4, 2, 128, 64), (2, 4096, 40, 8, 128, 0),
                (2, 4096, 40, 8, 128, 1024),
                (1, 1, 8, 2, 128, 0), (2, 64, 8, 2, 64, 0),
                (1, 127, 4, 2, 32, 0), (1, 129, 4, 1, 16, 0),
                (1, 4097, 8, 2, 128, 0), (1, 1000, 4, 2, 64, 48),
                (1, 3000, 4, 2, 128, 1024), (2, 300, 10, 2, 128, 0),
                (2, 2048, 24, 24, 64, 0), (2, 2048, 32, 32, 112, 0),
                (1, 1000, 32, 8, 112, 300), (1, 1, 4, 4, 112, 0)]
FLASH_SLICE = (2, 4096, 40, 8, 128)
# phase 4b also times the families' head dims at their prefill shapes
FLASH_FAMILY_SHAPES = {"zamba2_hd112": (2, 2048, 32, 32, 112),
                       "musicgen_hd64": (2, 2048, 24, 24, 64)}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def _max_err(a, b, tol):
    """Max |a-b| and whether every element is within tol + tol·|b|."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), bool((err <= tol + tol * b.abs()).all())


def _row_rel_err(a, b):
    """Max over rows (the last axis) of ||a-b|| / ||b||: an error scaled by
    each row's own magnitude, for outputs far below 1 in size."""
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
                  ).max())


# --------------------------------------------------------------- phase 2
LSTM_SHAPES = [(8, 1, 16), (64, 8, 64), (128, 4, 128), (32, 16, 256)]
GRU_SHAPES = [(8, 1, 16), (64, 8, 64), (128, 4, 128)]
# the shapes the serving path gives the kernels: every batch bucket at
# H=64, with I=1 (first layer) and I=64 (the GRU's second layer); then
# ragged shapes that no block or 16-byte copy divides
SERVING_SHAPES = [(B, I, 64) for B in (8, 16, 32, 64, 128, 256)
                  for I in (1, 64)] + [(37, 1, 50), (37, 50, 50)]


def _layer_case(name, B, I, H, T, dt, rnd):
    """One layer call on the card: (kernel outputs, plain outputs, plain
    outputs with fp32 sums)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gru_cell import gru_layer
    from repro_torch.kernels.lstm_cell import lstm_layer

    if name == "lstm_cell":
        args = (rnd(T, B, I), rnd(B, H), rnd(B, H), rnd(I, 4 * H),
                rnd(H, 4 * H), rnd(4 * H))
        return (lstm_layer(*args), ref.lstm_layer_ref(*args),
                ref.lstm_layer_ref(*args, fp32_sums=True))
    args = (rnd(T, B, I), rnd(B, H), rnd(I, 3 * H), rnd(H, 3 * H),
            rnd(3 * H))
    return ((gru_layer(*args),), (ref.gru_layer_ref(*args),),
            (ref.gru_layer_ref(*args, fp32_sums=True),))


def check_kernels(seed):
    """Each layer kernel vs its plain version (the plain cell stepped T
    times) on the same CUDA tensors, T = 1 and 8, fp32 and bf16: every
    step's h and the LSTM's last c.  fp32 and T = 1 at TOL; bf16 past one
    step at LAYER_BF16_TOL, and at TOL against the plain cell with fp32
    sums.  Returns the max abs error of each kernel at the serving shape
    (B=256, I=1, H=64, T=8) in fp32."""
    import torch

    serving_err = {}
    gen = torch.Generator().manual_seed(seed)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)

        def rnd(*shape):
            return (torch.randn(*shape, generator=gen) * 0.3).to("cuda", dt)

        rows = []
        for name, shapes in (("lstm_cell", LSTM_SHAPES + SERVING_SHAPES),
                             ("gru_cell", GRU_SHAPES + SERVING_SHAPES)):
            for B, I, H in shapes:
                for T in (1, 8):
                    outs, plain, fused = _layer_case(name, B, I, H, T, dt,
                                                     rnd)
                    torch.cuda.synchronize()
                    tol = TOL[dname] if dname == "float32" or T == 1 \
                        else LAYER_BF16_TOL
                    errs = [_max_err(o, r, tol) for o, r in zip(outs, plain)]
                    errs += [_max_err(o, r, TOL[dname])
                             for o, r in zip(outs, fused)]
                    err = max(e for e, _ in errs[:len(outs)])
                    fused_err = max(e for e, _ in errs[len(outs):])
                    ok = all(k for _, k in errs) and all(
                        o.dtype == dt and o.is_cuda and
                        bool(torch.isfinite(o).all()) for o in outs)
                    rows.append({"kernel": name, "T": T, "B": B, "I": I,
                                 "H": H, "max_abs_err": err,
                                 "max_abs_err_fp32_sums": fused_err,
                                 "ok": ok})
                    require(ok, f"{name} {dname} T={T} B={B} I={I} H={H}: "
                            f"kernel disagrees with its plain version (max "
                            f"abs err {err:.3g}, tol {tol}; against fp32 "
                            f"sums {fused_err:.3g}, tol {TOL[dname]})")
                    if dname == "float32" and (B, I, H, T) == (256, 1, 64, 8):
                        serving_err[name] = err
        emit({"phase": "kernel_vs_plain", "dtype": dname, "tol": TOL[dname],
              "layer_bf16_tol": LAYER_BF16_TOL, "cases": rows})
    return serving_err


# -------------------------------------------------------------- phase 2b
def check_flash(seed):
    """Flash kernel vs its plain version on the same CUDA tensors, fp32 and
    bf16, every FLASH_SHAPES case: each element within tol + tol·|plain|,
    and each output row within tol of the plain row relative to its norm
    (at S=4096 most rows average thousands of keys and are far below 1, so
    the element bound alone would hardly check them).  Returns the max abs
    error at the LM slice's shape in bf16, the path's dtype."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator("cuda").manual_seed(seed + 2)
    slice_err = None
    for dname in ("float32", "bfloat16"):
        dt, tol = getattr(torch, dname), FLASH_TOL[dname]
        rows = []
        for B, S, Hq, Hkv, hd, win in FLASH_SHAPES:
            q, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda"
                                   ).to(dt) for H in (Hq, Hkv, Hkv))
            out = flash_attention(q, k, v, window=win)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, window=win)
            torch.cuda.synchronize()
            err, ok = _max_err(out, want, tol)
            rel = _row_rel_err(out, want)
            ok = ok and rel <= tol and out.dtype == dt \
                and out.shape == q.shape and bool(torch.isfinite(out).all())
            rows.append({"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                         "window": win, "max_abs_err": err,
                         "max_row_rel_err": rel, "ok": ok})
            require(ok, f"flash_attention {dname} B={B} S={S} Hq={Hq} "
                    f"Hkv={Hkv} hd={hd} window={win}: kernel disagrees with "
                    f"its plain version (max abs err {err:.3g}, max row "
                    f"relative err {rel:.3g}, tol {tol})")
            if dname == "bfloat16" and (B, S, Hq, Hkv, hd, win) == \
                    FLASH_SLICE + (0,):
                slice_err = err
            del q, k, v, out, want
        emit({"phase": "flash_vs_plain", "dtype": dname, "tol": tol,
              "cases": rows})
    torch.cuda.empty_cache()
    return slice_err


# -------------------------------------------------------------- phase 2c
# the client axis (federated training: every selected client's forward in
# one launch, each client with its own weights): (M, B, I, H) at T = 8; the
# training shape M=100 x B=64 first, then a prime B, the cluster shapes and
# the GRU's second layer
CLIENT_SHAPES = [(1, 64, 1, 64), (3, 64, 1, 64), (100, 64, 1, 64),
                 (3, 61, 1, 64), (3, 64, 4, 128), (3, 32, 16, 256),
                 (100, 64, 64, 64)]
TRAIN_SHAPE = (100, 64, 1, 64)      # M, B, I, H of a local step's forward


def check_client_axis(seed):
    """Each layer kernel with a leading client axis against the plain layer
    with the same axis, on the same CUDA tensors, fp32 (TOL) and bf16 (the
    layer tolerances of phase 2); then the autograd Function's gradients at
    the training shape in fp32, within 2e-5 of each gradient's largest
    magnitude.  Returns the max abs error of each kernel at the training
    shape in fp32."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.gru_cell import gru_layer
    from repro_torch.kernels.lstm_cell import lstm_layer

    gen = torch.Generator().manual_seed(seed + 5)
    T, train_err = 8, {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)

        def rnd(*shape):
            return (torch.randn(*shape, generator=gen) * 0.3).to("cuda", dt)

        rows = []
        for name in ("lstm_cell", "gru_cell"):
            G = 4 if name == "lstm_cell" else 3
            for M, B, I, H in CLIENT_SHAPES:
                if name == "lstm_cell" and I == 64:
                    continue            # the LSTM forecaster has one layer
                x, h, c = rnd(M, T, B, I), rnd(M, B, H), rnd(M, B, H)
                w = (rnd(M, I, G * H), rnd(M, H, G * H), rnd(M, G * H))
                if G == 4:
                    outs = lstm_layer(x, h, c, *w)
                    plain = ref.lstm_layer_ref(x, h, c, *w)
                    fused = ref.lstm_layer_ref(x, h, c, *w, fp32_sums=True)
                else:
                    outs = (gru_layer(x, h, *w),)
                    plain = (ref.gru_layer_ref(x, h, *w),)
                    fused = (ref.gru_layer_ref(x, h, *w, fp32_sums=True),)
                torch.cuda.synchronize()
                tol = TOL[dname] if dname == "float32" else LAYER_BF16_TOL
                errs = [_max_err(o, r, tol) for o, r in zip(outs, plain)]
                errs += [_max_err(o, r, TOL[dname])
                         for o, r in zip(outs, fused)]
                err = max(e for e, _ in errs[:len(outs)])
                ok = all(k for _, k in errs) and all(
                    o.dtype == dt and o.shape == r.shape and
                    bool(torch.isfinite(o).all())
                    for o, r in zip(outs, plain))
                rows.append({"kernel": name, "M": M, "T": T, "B": B, "I": I,
                             "H": H, "max_abs_err": err,
                             "max_abs_err_fp32_sums": max(
                                 e for e, _ in errs[len(outs):]), "ok": ok})
                require(ok, f"{name} {dname} M={M} B={B} I={I} H={H}: "
                        f"client-axis kernel disagrees with its plain "
                        f"version (max abs err {err:.3g}, tol {tol})")
                if dname == "float32" and (M, B, I, H) == TRAIN_SHAPE:
                    train_err[name] = err
        emit({"phase": "client_axis_vs_plain", "dtype": dname,
              "tol": TOL[dname], "layer_bf16_tol": LAYER_BF16_TOL,
              "cases": rows})

    # gradients through the autograd Function (forward: the kernel;
    # backward: the VJP of the plain layer) against autograd through the
    # plain layer, at the training shape with a zero h0 that needs none
    M, B, I, H = TRAIN_SHAPE
    grads = []
    for name in ("lstm_cell", "gru_cell"):
        G = 4 if name == "lstm_cell" else 3
        x = (torch.randn(M, T, B, I, generator=gen) * 0.3).cuda()
        h0 = torch.zeros(M, B, H, device="cuda")
        c0 = (torch.randn(M, B, H, generator=gen) * 0.3).cuda()
        w = [(torch.randn(*s, generator=gen) * 0.3).cuda()
             for s in ((M, I, G * H), (M, H, G * H), (M, G * H))]
        cot = torch.randn(M, T, B, H, generator=gen).cuda()
        args = (x, h0, c0, *w) if G == 4 else (x, h0, *w)
        kernel = lstm_layer if G == 4 else gru_layer
        plain = ref.lstm_layer_ref if G == 4 else ref.gru_layer_ref

        def run(fn):
            leaves = [a.clone().requires_grad_(a is not h0) for a in args]
            out = fn(*leaves)
            out = out[0] if G == 4 else out
            return torch.autograd.grad((out * cot).sum(),
                                       [t for t in leaves if t.requires_grad])

        got, want = run(kernel), run(plain)
        torch.cuda.synchronize()
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(got, want))
        grads.append({"kernel": name, "M": M, "B": B, "T": T, "I": I,
                      "H": H, "max_err_over_grad_max": rel})
        require(rel <= 2e-5, f"{name}: the autograd Function's gradients "
                f"differ from the plain layer's by {rel:.3g} of their max "
                "(tol 2e-5)")
    emit({"phase": "layer_function_grads", "dtype": "float32",
          "tol_of_grad_max": 2e-5, "cases": grads})
    return train_err


# --------------------------------------------------------------- phase 3
def serve_slice(cfg, seed, launches_per_flush=None, int8=False):
    """Serve REQUESTS_PER_CONSUMER requests from each of CONSUMERS synthetic
    CA consumers on the card and on the CPU, then profile one more full
    (max_batch) flush on the card.  Returns the card run's launches of the
    config's cell, its flushes, the mean wall time of a full flush and the
    profile.  With ``launches_per_flush`` the run must have launched the
    config's cell exactly that many times a flush, and the other cell
    never.  With ``int8`` the same stream is served again from int8
    weights (``_serve_int8``)."""
    import numpy as np
    import torch
    from repro_torch import serving as sv
    from repro_torch.core import clustering, prng
    from repro_torch.data import synthetic, windows
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import seeded_generator
    from repro_torch.models import forecaster as fc

    L = cfg.lookback
    hist = synthetic.generate_buildings("CA", list(range(CONSUMERS)),
                                        days=HISTORY_DAYS)
    z = windows.daily_average_vector(hist, days=HISTORY_DAYS)
    cents, _, _ = clustering.kmeans(z, 2, seed=seed)
    slots = (sv.GLOBAL_SLOT, 0, 1)
    params = {s: fc.init_forecaster(seeded_generator(seed, s + 1), cfg)
              for s in slots}
    # each consumer sends windows ending at successive 4-step offsets; the
    # consumer order is shuffled in every round
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    T = hist.shape[1]
    stream = []
    for k in range(REQUESTS_PER_CONSUMER):
        end = T - 4 * (REQUESTS_PER_CONSUMER - 1 - k)
        for c in rng.permutation(CONSUMERS):
            stream.append((int(c), hist[c, end - L:end],
                           hist[c] if k == 0 else None))

    # int8: each slot rounded under fold_in(qroot, slot + 1), the root
    # folded from the seed as launch/serve.py folds it
    qroot = prng.fold_in(prng.PRNGKey(seed), 0)

    def run(device, weights="fp32"):
        reg = sv.ModelRegistry(device=device)
        for s in slots:
            reg.publish(params[s], cfg, slot=s, generation=1, weights=weights,
                        key=(None if weights == "fp32" else
                             prng.fold_in(qroot, s + 1)))
        eng = sv.ServingEngine(reg, sv.ClusterRouter(cents), max_batch=256,
                               min_bucket=8, device=device)
        eng.warmup()
        if device == "cuda" and weights == "fp32":
            h = reg.handle(0)
            leaves = [t for p in h.params["layers"] for t in p.values()] + \
                list(h.params["head"].values())
            require(all(t.is_cuda for t in leaves), "params not on the card")
            x = torch.ones((8, L), device="cuda")
            with torch.inference_mode():
                y = sv.engine.forecast_kwh(h.params, x, x[:, :1] * 0,
                                           x[:, :1] * 2, cfg)
            require(y.is_cuda and y.shape == (8, cfg.horizon),
                    "forward output not on the card")
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        tickets = [eng.submit(c, w, history=hs) for c, w, hs in stream]
        last = eng.flush()
        counts = ops.launch_counts()
        return eng, tickets, last, counts

    def worst_over_tol(card, cpu):
        """Card vs CPU tickets: the worst error over rtol 1e-4 and atol
        1e-4*(hi-lo)."""
        worst = 0.0
        for a, b in zip(card, cpu):
            err = np.abs(a.result - b.result)
            worst = max(worst, float((err / (1e-4 * np.abs(b.result)
                                             + 1e-4 * (b.hi - b.lo))).max()))
        return worst

    t0 = time.perf_counter()
    eng, tickets, last, counts = run("cuda")
    card_s = time.perf_counter() - t0
    _, cpu_tickets, _, _ = run("cpu")
    st = eng.stats
    require(all(t.done for t in tickets), "some requests were not served")
    require(all(t.result.shape == (cfg.horizon,) and np.isfinite(t.result).all()
                for t in tickets), "non-finite or misshaped forecast")
    name = f"{cfg.cell}_cell"
    other = "gru_cell" if cfg.cell == "lstm" else "lstm_cell"
    if launches_per_flush is not None:
        expect = st.flushes * launches_per_flush
        require(counts[name] == expect and counts[other] == 0,
                f"launch counts {counts}, expected {name}={expect} "
                f"(= {st.flushes} flushes x {launches_per_flush})")
    worst = worst_over_tol(tickets, cpu_tickets)
    require(worst <= 1.0, f"card vs CPU engine disagree: worst error is "
            f"{worst:.3g}x the tolerance (rtol 1e-4, atol 1e-4*(hi-lo))")
    flushes, full = st.flushes, st.flushes - len(last)
    require(full > 0, "no full flush")
    full_wall = (st.busy_s - sum(f.wall_s for f in last)) / full
    served = {"phase": "serve", "cfg": dataclasses.asdict(cfg),
              "requests": len(tickets), "consumers": CONSUMERS,
              "slots": sorted({t.slot for t in tickets}),
              "flushes": flushes, "by_bucket": dict(st.by_bucket),
              "fill": st.fill(), "launches": counts,
              "launches_per_flush": counts[name] / flushes,
              "card_vs_cpu_worst_over_tol": worst,
              "mean_full_flush_wall_ms": full_wall * 1e3,
              "busy_s": st.busy_s, "run_s": card_s}
    # one more full flush under torch.profiler: the first max_batch requests
    # of the busiest slot again, queued and then flushed at once.  The
    # profiler slows the host several times over, so the busy share that
    # counts is its device time over the unprofiled mean full-flush wall.
    busiest = max(set(t.slot for t in tickets),
                  key=lambda s: sum(t.slot == s for t in tickets))
    eng.auto_flush = False
    for t in [t for t in tickets if t.slot == busiest][:eng.max_batch]:
        eng.submit(t.consumer_id, t.window)
    profile = _device_profile(lambda: eng.flush(busiest), 1)
    if profile["device_ms_per_step"] is not None:
        profile["device_share_of_mean_full_flush_wall"] = \
            profile["device_ms_per_step"] / (full_wall * 1e3)
    emit({**served, "full_flush_profile": profile})
    out = {"launches": counts[name], "flushes": flushes,
           "full_flush_wall_s": full_wall, "profile": profile}
    if int8:
        out["int8_launches"] = _serve_int8(cfg, run, worst_over_tol, tickets,
                                           name, launches_per_flush)
    return out


def _serve_int8(cfg, run, worst_over_tol, fp32_tickets, name,
                launches_per_flush):
    """Phase 3's stream again from int8 weights, on the card and on the
    CPU: the card's int8 handles must hold only int8 grids and fp32 scales
    on the card, equal bit for bit to the CPU publish's; the forecasts must
    match the CPU int8 engine at phase 3's tolerance.  Prints the MAPE gap
    between the fp32 and int8 forecasts on the card.  Returns the card
    run's launches of the config's cell."""
    import numpy as np
    import torch
    from repro_torch.models.layers import tree_leaves

    t0 = time.perf_counter()
    eng, tickets, last, counts = run("cuda", "int8")
    card_s = time.perf_counter() - t0
    cpu_eng, cpu_tickets, _, _ = run("cpu", "int8")
    reg, cpu_reg = eng.registry, cpu_eng.registry
    n_bytes = 0
    for s in reg.slots():
        h, ch = reg.handle(s), cpu_reg.handle(s)
        require(h.weights == "int8", f"slot {s} served {h.weights}")
        for a, b in zip(tree_leaves(h.params), tree_leaves(ch.params)):
            require(a.is_cuda and (a.dtype == torch.int8 or
                                   (a.dtype == torch.float32
                                    and a.dim() == 0)),
                    f"int8 handle of slot {s} holds {a.dtype} "
                    f"{tuple(a.shape)} on {a.device}")
            require(torch.equal(a.cpu(), b),
                    f"int8 publish of slot {s}: card and CPU differ")
            n_bytes += a.numel() * a.element_size()
    require(all(t.done and np.isfinite(t.result).all() for t in tickets),
            "int8: some requests not served or not finite")
    worst = worst_over_tol(tickets, cpu_tickets)
    require(worst <= 1.0, f"int8 card vs CPU engine disagree: worst error "
            f"is {worst:.3g}x the tolerance")
    flushes = eng.stats.flushes
    if launches_per_flush is not None:
        require(counts[name] == flushes * launches_per_flush,
                f"int8 launch counts {counts}, expected {name}="
                f"{flushes * launches_per_flush}")
    f32 = np.stack([t.result for t in fp32_tickets])
    i8 = np.stack([t.result for t in tickets])
    gap = float(np.mean(np.abs(i8 - f32) / np.maximum(np.abs(f32), 1e-6)))
    require(gap < 0.02, f"int8 vs fp32 forecasts: MAPE gap {gap:.4f} "
            "exceeds the reference's 2 % bound")
    emit({"phase": "serve_int8", "cfg": dataclasses.asdict(cfg),
          "requests": len(tickets), "flushes": flushes,
          "launches": counts, "int8_handle_bytes_per_slot":
              n_bytes // len(reg.slots()),
          "q_and_scale_card_equal_cpu": True,
          "card_vs_cpu_worst_over_tol": worst,
          "fp32_vs_int8_mape_pct": 100.0 * gap,
          "mean_full_flush_wall_ms": 1e3 * (
              eng.stats.busy_s - sum(f.wall_s for f in last))
          / (flushes - len(last)),
          "busy_s": eng.stats.busy_s, "run_s": card_s})
    return counts[name]


# --------------------------------------------------------------- phase 4
def time_ms(fn, iters=300, warmup=50, chunk=20):
    """(device ms, host ms) of one call of ``fn``.

    Device: median over ``iters`` calls of CUDA events recorded around each
    call, with the host kept ahead of the card (a ``torch.cuda._sleep``
    spin, sized from the measured host cost, holds the stream while a chunk
    of calls is enqueued), so each pair times the call's kernels and not
    the host's dispatch.  Host: wall time per call of
    back-to-back calls ending in a synchronize, which is what a caller
    waits when the card is idle.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / a.elapsed_time(b)
    times = []
    # chunks of calls, so the launches a chunk queues behind its spin stay
    # well inside the card's queue of pending launches
    for _ in range(0, iters, chunk):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(chunk)]
        torch.cuda._sleep(int(cycles_per_ms * (3 * host_ms * chunk + 1)))
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        times.extend(a.elapsed_time(b) for a, b in pairs)
    return statistics.median(times), host_ms


def _timed(kernel, plain, library, iters=300, warmup=50, **counts):
    out = dict(counts)
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"], out[f"{key}host_ms"] = time_ms(fn, iters, warmup)
    return out


def _bound(t, peak_flops):
    """Add the roofline bound (larger of bytes and operations time)."""
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = t["flops"] / peak_flops * 1e3
    t["bound_ms"] = max(bytes_ms, ops_ms)
    t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def _cudnn_layer(cell, wx, wh, b):
    """cuDNN's whole-sequence call computing the repo's layer: nn.LSTM /
    nn.GRU with w_ih = wx.T, w_hh = wh.T, b_ih = b, b_hh = 0, the GRU's
    gates reordered [z|r|h~] -> [r|z|n] (its n gate scales only the hidden
    part by r, as the repo's h~ does)."""
    import torch

    I, GH = wx.shape
    H = wh.shape[0]
    if cell == "lstm":
        mod = torch.nn.LSTM(I, H)
        perm = torch.arange(GH)
    else:
        mod = torch.nn.GRU(I, H)
        perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                          torch.arange(2 * H, 3 * H)])
    mod = mod.to(wx.device)
    perm = perm.to(wx.device)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(wx[:, perm].t())
        mod.weight_hh_l0.copy_(wh[:, perm].t())
        mod.bias_ih_l0.copy_(b[perm])
        mod.bias_hh_l0.zero_()
    return mod


def _layer_bytes_flops(gates, T, B, I, H, itemsize=4):
    """Each input read once, each output written once (h_seq; the LSTM's
    c_T and c0 too), and the layer's multiply-adds."""
    n = T * B * I + B * H + I * gates * H + H * gates * H + gates * H \
        + T * B * H + (2 * B * H if gates == 4 else 0)
    return itemsize * n, 2 * T * B * (I + H) * gates * H


def time_kernels(seed):
    """At the serving shape (B=256, T=8, H=64, fp32): each layer kernel, its
    plain version and cuDNN's call for the same sequence (LSTM I=1; GRU I=1
    and I=64, the second layer), beside the bound from bytes and FLOPs; the
    kernel at the other launch plans it takes (rows per block, rows per
    thread, k-split); and at T = 1 the step wrappers beside
    torch.lstm_cell / gru_cell."""
    import torch
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels.gru_cell import gru_cell, gru_layer
    from repro_torch.kernels.lstm_cell import lstm_cell, lstm_layer

    B, T, H = 256, 8, 64
    gen = torch.Generator().manual_seed(seed + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen) * 0.3).to("cuda")

    out = {}
    for key, cell, I in (("lstm_cell", "lstm", 1), ("gru_cell", "gru", 1),
                         ("gru_cell_i64", "gru", 64)):
        name, G = f"{cell}_cell", 4 if cell == "lstm" else 3
        x, h, c = rnd(T, B, I), rnd(B, H), rnd(B, H)
        w = (rnd(I, G * H), rnd(H, G * H), rnd(G * H))
        mod = _cudnn_layer(cell, *w)
        if cell == "lstm":
            ins, outs = (x, h, c, *w), (torch.empty(T, B, H, device="cuda"),
                                        torch.empty(B, H, device="cuda"))

            def kernel():
                return lstm_layer(x, h, c, *w)

            def plain():
                return ref.lstm_layer_ref(x, h, c, *w)

            def library():
                return mod(x, (h[None], c[None]))[0]
        else:
            ins, outs = (x, h, *w), (torch.empty(T, B, H, device="cuda"),)

            def kernel():
                return gru_layer(x, h, *w)

            def plain():
                return ref.gru_layer_ref(x, h, *w)

            def library():
                return mod(x, h[None])[0]
        with torch.inference_mode():
            want = plain()
            want = want[0] if cell == "lstm" else want
            require(_max_err(library(), want, 2e-5)[1],
                    f"cuDNN's nn.{cell.upper()} yardstick does not compute "
                    "the repo's layer")
            n_bytes, flops = _layer_bytes_flops(G, T, B, I, H)
            t = _timed(kernel, plain, library, T=T, I=I, bytes=n_bytes,
                       flops=flops,
                       plan=_cuda.cell_plan(name, B, I, H, 4, sms)._asdict())
            # the kernel at every other plan it takes at this shape,
            # launched directly (these launches are not the path's)
            sweep = {}
            for rows in (1, 2, 4):
                for rpt in (1, 2):
                    for ks in (2, 4):
                        try:
                            plan = _cuda.cell_plan(name, B, I, H, 4, sms,
                                                   rows, rpt, ks)
                        except ValueError:      # not a plan the kernel takes
                            continue
                        sweep[f"rows{rows}_rpt{rpt}_ks{ks}"] = time_ms(
                            lambda: _cuda.launch(name, ins + outs,
                                                 (1, T, B, I, H, *plan)),
                            100, 20)[0]
            t["plan_sweep_ms"] = sweep
        out[key] = _bound(t, FP32_FLOPS_PER_S)

    # T = 1: the step wrappers (the layer kernels at one step) against the
    # library's one-step cells
    I = 1
    x, h, c = rnd(B, I), rnd(B, H), rnd(B, H)
    wx, wh, b = rnd(I, 4 * H), rnd(H, 4 * H), rnd(4 * H)
    w_ih, w_hh, b_hh = wx.t().contiguous(), wh.t().contiguous(), \
        torch.zeros_like(b)
    lib_h, lib_c = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)
    ref_h, ref_c = ref.lstm_cell_ref(x, h, c, wx, wh, b)
    require(_max_err(lib_h, ref_h, 2e-5)[1] and _max_err(lib_c, ref_c, 2e-5)[1],
            "torch.lstm_cell yardstick does not compute the repo's cell")
    n_bytes, flops = _layer_bytes_flops(4, 1, B, I, H)
    out["lstm_cell_step"] = _bound(_timed(
        lambda: lstm_cell(x, h, c, wx, wh, b),
        lambda: ref.lstm_cell_ref(x, h, c, wx, wh, b),
        lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh),
        T=1, I=I, bytes=n_bytes, flops=flops), FP32_FLOPS_PER_S)

    gx, gwx, gwh, gb = rnd(B, I), rnd(I, 3 * H), rnd(H, 3 * H), rnd(3 * H)
    # torch.gru_cell orders the gates [r|z|n]; the repo's are [z|r|h~]
    perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                      torch.arange(2 * H, 3 * H)]).cuda()
    g_ih, g_hh = gwx[:, perm].t().contiguous(), gwh[:, perm].t().contiguous()
    g_b, g_bhh = gb[perm].contiguous(), torch.zeros_like(gb)
    require(_max_err(torch.gru_cell(gx, h, g_ih, g_hh, g_b, g_bhh),
                     ref.gru_cell_ref(gx, h, gwx, gwh, gb), 2e-5)[1],
            "torch.gru_cell yardstick does not compute the repo's cell")
    n_bytes, flops = _layer_bytes_flops(3, 1, B, I, H)
    out["gru_cell_step"] = _bound(_timed(
        lambda: gru_cell(gx, h, gwx, gwh, gb),
        lambda: ref.gru_cell_ref(gx, h, gwx, gwh, gb),
        lambda: torch.gru_cell(gx, h, g_ih, g_hh, g_b, g_bhh),
        T=1, I=I, bytes=n_bytes, flops=flops), FP32_FLOPS_PER_S)
    emit({"phase": "timing", "shape": {"B": B, "T": T, "H": H,
                                       "dtype": "float32"},
          "median_of": 300, **out})
    return out


# -------------------------------------------------------------- phase 4b
def time_flash(seed, shape=FLASH_SLICE, label="qwen3_14b_hd128"):
    """Flash kernel, its plain version and scaled_dot_product_attention at
    a prefill shape (default the LM slice's: B=2, S=4096, Hq=40, Hkv=8,
    hd=128; bf16, causal), beside the bound: the causal FLOPs of these
    inputs (at the real hd) on the bf16 tensor cores, or q, k, v read and o
    written once; with the achieved TFLOP/s of the kernel and of the
    library call, and the kernel's share of the bound (bound_ms / ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, S, Hq, Hkv, hd = shape
    gen = torch.Generator("cuda").manual_seed(seed + 3)
    q, k, v = (torch.randn(B, S, H, hd, generator=gen, device="cuda"
                           ).to(torch.bfloat16) for H in (Hq, Hkv, Hkv))

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    want = ref.flash_attention_ref(q, k, v)
    require(_max_err(library().transpose(1, 2), want,
                     FLASH_TOL["bfloat16"])[1],
            "scaled_dot_product_attention yardstick does not compute the "
            "repo's attention")
    del want
    torch.cuda.empty_cache()
    out = _timed(lambda: flash_attention(q, k, v),
                 lambda: ref.flash_attention_ref(q, k, v), library,
                 iters=20, warmup=3,
                 bytes=2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd),
                 flops=4 * B * Hq * hd * S * (S + 1) // 2)
    _bound(out, BF16_TENSOR_FLOPS_PER_S)
    out["tflops"] = out["flops"] / (out["ms"] * 1e-3) / 1e12
    out["library_tflops"] = out["flops"] / (out["library_ms"] * 1e-3) / 1e12
    emit({"phase": "flash_timing", "label": label,
          "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                    "dtype": "bfloat16", "causal": True},
          "median_of": 20, "flash_attention": out})
    del q, k, v
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 4c
def time_training_layer(seed):
    """At the training shape (M=100 clients x B=64 rows, T=8, H=64, fp32;
    I=1, and the GRU's second layer at I=64): each layer kernel with the
    client axis, its plain version, and cuDNN's nn.LSTM / nn.GRU over the
    same 6,400 rows with ONE weight set (no library call takes per-client
    weights: a floor, not the same function), beside the bound from bytes
    and FLOPs, M times one client's."""
    import torch
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels.gru_cell import gru_layer
    from repro_torch.kernels.lstm_cell import lstm_layer

    M, B, _, H = TRAIN_SHAPE
    T = 8
    gen = torch.Generator().manual_seed(seed + 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen) * 0.3).to("cuda")

    out = {}
    for key, cell, I in (("lstm_cell", "lstm", 1), ("gru_cell", "gru", 1),
                         ("gru_cell_i64", "gru", 64)):
        name, G = f"{cell}_cell", 4 if cell == "lstm" else 3
        x, h, c = rnd(M, T, B, I), rnd(M, B, H), rnd(M, B, H)
        w = (rnd(M, I, G * H), rnd(M, H, G * H), rnd(M, G * H))
        # the library's floor: client 0's weights over all M x B rows
        mod = _cudnn_layer(cell, w[0][0], w[1][0], w[2][0])
        xs = x.transpose(0, 1).reshape(T, M * B, I).contiguous()
        hs, cs = h.reshape(1, M * B, H), c.reshape(1, M * B, H)
        if cell == "lstm":
            def kernel():
                return lstm_layer(x, h, c, *w)

            def plain():
                return ref.lstm_layer_ref(x, h, c, *w)

            def library():
                return mod(xs, (hs, cs))[0]
        else:
            def kernel():
                return gru_layer(x, h, *w)

            def plain():
                return ref.gru_layer_ref(x, h, *w)

            def library():
                return mod(xs, hs)[0]
        with torch.inference_mode():
            want = plain()
            want = want[0] if cell == "lstm" else want
            require(_max_err(library()[:, :B], want[0], 2e-5)[1],
                    f"cuDNN's nn.{cell.upper()} floor does not compute the "
                    "repo's layer on client 0's rows")
            n_bytes, flops = _layer_bytes_flops(G, T, B, I, H)
            t = _timed(kernel, plain, library, iters=100, warmup=10, M=M,
                       T=T, B=B, I=I, H=H, bytes=M * n_bytes,
                       flops=M * flops,
                       plan=_cuda.cell_plan(name, B, I, H, 4, sms,
                                            M=M)._asdict())
        out[key] = _bound(t, FP32_FLOPS_PER_S)
        out[key]["library"] = (f"torch.nn.{cell.upper()} (cuDNN), one "
                               f"weight set over {M * B} rows: a floor")
    emit({"phase": "train_layer_timing", "median_of": 100, **out})
    return out


# --------------------------------------------------------------- phase 5
def lm_slice(seed):
    """The dense-LM inference path at qwen3-14b's full width (LM_LAYERS of
    its layers, bf16, weights seeded on the card): prefill LM_BATCH x
    LM_PROMPT random tokens, then LM_NEW greedy decode steps, through
    ``launch/lm_steps.py``.  The kernel route is held against the plain
    attention route on the same tokens, step by step, at the bf16 tolerance
    scaled by the largest |logit|.  Returns the flash launches of one
    prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    gen = torch.Generator("cuda").manual_seed(seed + 4)
    t0 = time.perf_counter()
    params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    # ModelConfig.num_params counts the matrices, not the norm scales
    hd = cfg.resolved_head_dim
    norms = cfg.n_layers * (2 * cfg.d_model + 2 * hd * cfg.qk_norm) \
        + cfg.d_model
    require(n_params == cfg.num_params() + norms,
            f"{n_params} params, config says {cfg.num_params()} + {norms} "
            "norm scales")
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ops.reset_launch_counts()
        kern = lm_steps.generate(params, {"tokens": prompt}, cfg, LM_NEW,
                                 attn_impl="kernel")
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        require(counts == {"lstm_cell": 0, "gru_cell": 0,
                           "flash_attention": cfg.n_layers},
                f"launch counts {counts} in one prefill + {LM_NEW} decode "
                f"steps, expected flash_attention = {cfg.n_layers} layers")
        plain = lm_steps.generate(params, {"tokens": prompt}, cfg, LM_NEW,
                                  attn_impl="torch", feed=kern["tokens"])
        worst = []
        for a, b in zip([kern["prefill_logits"]] + kern["logits"],
                        [plain["prefill_logits"]] + plain["logits"]):
            require(a.shape == (LM_BATCH, 1, cfg.vocab_size) and
                    bool(torch.isfinite(a).all()),
                    f"logits of shape {tuple(a.shape)} or not finite")
            bound = FLASH_TOL["bfloat16"] * max(float(b.float().abs().max())
                                                + 1e-6, 1.0)
            err = float((a.float() - b.float()).abs().max())
            worst.append(err / bound)
            require(err < bound, f"kernel route vs plain route: max abs "
                    f"logit error {err:.4g} >= {bound:.4g}")
        # warm timings: the same path again, then the flash share of a
        # prefill from CUDA events around each flash call inside it
        warm = lm_steps.generate(params, {"tokens": prompt}, cfg, LM_NEW,
                                 attn_impl="kernel", feed=kern["tokens"])
        spans, real = [], ops.flash_attention

        def timed_flash(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            out = real(*a, **kw)
            e.record()
            spans.append((s, e))
            return out

        shape = InputShape("lm", LM_PROMPT + LM_NEW, LM_BATCH, "prefill")
        capacity = lm_steps.cache_capacity(cfg, shape)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        ops.flash_attention = timed_flash
        try:
            start.record()
            lm_steps.prefill_step(params, {"tokens": prompt}, cfg,
                                  capacity=capacity)
            end.record()
        finally:
            ops.flash_attention = real
        torch.cuda.synchronize()
        prefill_profile = profile_prefill(params, prompt, cfg, capacity)
        decode_profile = profile_decode(params, prompt, cfg, kern["tokens"])
    prefill_dev_ms = start.elapsed_time(end)
    flash_ms = sum(s.elapsed_time(e) for s, e in spans)
    emit({"phase": "lm_slice", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "params": n_params, "dtype": "bfloat16",
          "batch": LM_BATCH, "prompt_len": LM_PROMPT, "decode_steps": LM_NEW,
          "launches": counts, "kernel_vs_plain_worst_over_tol": max(worst),
          "init_s": init_s, "peak_memory_gib": peak_gb,
          "prefill_wall_ms_first": kern["prefill_s"] * 1e3,
          "prefill_wall_ms": warm["prefill_s"] * 1e3,
          "prefill_wall_ms_plain_route": plain["prefill_s"] * 1e3,
          "prefill_device_ms": prefill_dev_ms,
          "flash_ms_in_prefill": flash_ms,
          "flash_share_of_prefill": flash_ms / prefill_dev_ms,
          "decode_tokens_per_s": LM_BATCH * LM_NEW / warm["decode_s"],
          "decode_ms_per_step": warm["decode_s"] * 1e3 / LM_NEW,
          "over_tol_by_step": worst, "prefill_profile": prefill_profile,
          "decode_profile": decode_profile,
          "tokens": kern["tokens"][0].tolist()})
    prefill_logits = kern["prefill_logits"].clone()
    del params, kern, plain, warm
    torch.cuda.empty_cache()
    return counts["flash_attention"], prefill_logits


# -------------------------------------------------------------- phase 5b
# the LM families at full width, depth cut where the weights or the phase's
# time force it: (arch, config fields replaced, flash launches a prefill).
# Only attention that is full-sequence GQA/MHA launches the kernel: one a
# layer; zamba2's shared block once per group of 6 Mamba2 layers (81 // 6);
# MLA (deepseek) takes the plain path, as the reference does; xLSTM has no
# attention
FAMILIES = [("codeqwen1.5-7b", {"n_layers": 4}, 4),
            ("qwen2-72b", {"n_layers": 4}, 4),
            ("dbrx-132b", {"n_layers": 4}, 4),
            ("deepseek-v3-671b", {"n_layers": 3, "dense_layers": 1}, 0),
            ("zamba2-7b", {}, 13),
            ("xlstm-1.3b", {}, 0),
            ("llava-next-34b", {"n_layers": 8}, 8),
            ("musicgen-medium", {}, 48)]
FAM_BATCH, FAM_PROMPT, FAM_NEW = 2, 2048, 8


def _param_count(cfg):
    """The leaves of ``cfg``'s parameter tree, counted from its dims:
    ``ModelConfig.num_params()`` plus what it leaves out (norm scales, QKV
    biases, MLA's latent norms, the Mamba2 block's conv bias, per-head
    scalars and gated norm, the VLM projector, DeepSeek's MTP block, and
    the audio heads past the first codebook's).  For xLSTM ``num_params``
    is the reference's own approximation ("# approx" in
    ``configs/base.py``), so its blocks are counted here exactly."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn_extra = 2 * d                                   # ln1, ln2
    if cfg.mla is not None:
        attn_extra += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    else:
        attn_extra += cfg.qkv_bias * (H + 2 * Hkv) * hd \
            + cfg.qk_norm * 2 * hd
    if cfg.arch_type == "ssm":
        x = cfg.xlstm
        dm = int(x.mlstm_proj_factor * d)
        nh = max(1, dm // x.mlstm_head_dim)
        dff = int(x.slstm_proj_factor * d)
        mlstm = d + 2 * d * dm + 4 * dm * dm + 2 * dm * nh + 2 * nh + dm \
            + dm * d
        slstm = d + 4 * d * d + 4 * d * (d // H) + 4 * d + d + 3 * d * dff
        n_s = L // x.slstm_every
        return (2 * V * d + d + (L - n_s) * mlstm + n_s * slstm)
    n = cfg.num_params() + d                             # + final norm
    if cfg.arch_type == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        n += L * (d + d_in + 2 * s.n_groups * s.state_dim + 3 * nh + d_in)
        return n + attn_extra
    n += L * attn_extra
    if cfg.arch_type == "vlm":
        n += cfg.frontend.embed_dim * d + d * d
    if cfg.arch_type == "audio":
        n += (cfg.frontend.n_codebooks - 1) * V * d     # cb_heads (d, K, V)
    if cfg.mtp:
        m = cfg.mla
        mla = (d * m.q_lora_rank
               + m.q_lora_rank * H * (m.qk_nope_dim + m.qk_rope_dim)
               + d * (m.kv_lora_rank + m.qk_rope_dim)
               + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
               + H * m.v_head_dim * d)
        n += 2 * d * d + mla + 3 * d * cfg.d_ff + attn_extra + d
    return n


def _over_tol(kern, plain):
    """Each compared step's max abs logit error over phase 5's bf16 bound
    (FLASH_TOL scaled by the step's largest plain |logit|)."""
    out = []
    for a, b in zip([kern["prefill_logits"]] + kern["logits"],
                    [plain["prefill_logits"]] + plain["logits"]):
        bound = FLASH_TOL["bfloat16"] * max(float(b.float().abs().max())
                                            + 1e-6, 1.0)
        out.append(float((a.float() - b.float()).abs().max()) / bound)
    return out


def _set_misses(chosen, own):
    """(G, S, k) bool: expert ``chosen[..., j]`` is not in the token's own
    top-k set ``own``."""
    return ~(chosen[..., :, None] == own[..., None, :]).any(-1)


class _Routing:
    """Wraps ``models/moe.py::_route`` for one run: records every call's
    expert choices (``calls``); with ``forced`` (an earlier run's
    ``calls``), routes each call on those choices instead, the gates from
    this run's own router probabilities (renormalised, as ``_route``
    does), and counts the (token, k) choices its own top-k set lacks
    (``flips``) and the largest router-probability margin by which its own
    k-th choice beat a forced one (``max_margin``).  As phase 5 feeds the
    plain route the kernel route's tokens, this feeds it the kernel
    route's routing, the other discrete choice of the path."""

    def __init__(self, forced=None):
        self.forced = None if forced is None else iter(forced)
        self.calls, self.flips, self.max_margin = [], 0, 0.0

    def route(self, router_w, x32, mcfg):
        import torch
        gates, own, aux = self.real(router_w, x32, mcfg)
        if self.forced is None:
            self.calls.append(own)
            return gates, own, aux
        chosen = next(self.forced)
        probs = torch.softmax(torch.matmul(x32, router_w), dim=-1)
        g = probs.gather(-1, chosen)
        miss = _set_misses(chosen, own)
        self.flips += int(miss.sum())
        if bool(miss.any()):
            kth = probs.gather(-1, own[..., -1:])            # own k-th prob
            margin = (kth - g).masked_select(miss)
            self.max_margin = max(self.max_margin, float(margin.max()))
        self.calls.append(chosen)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), \
            chosen, aux

    def __enter__(self):
        from repro_torch.models import moe
        self.real, moe._route = moe._route, self.route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real
        if self.forced is not None and exc[0] is None:
            require(next(self.forced, None) is None,
                    "the forced run made fewer routing calls")


class _FedBlocks:
    """Wraps ``models/transformer.py::_dense_block_fwd`` / ``_dense_block_dec``
    for one run: records the residual stream entering each call
    (``inputs``); with ``fed`` (an earlier run's ``inputs``), replaces it
    with the earlier run's.  Phase 5b feeds zamba2's plain route the
    kernel route's stream at each call of the shared attention block, so
    each group (6 Mamba2 layers and the block) of the plain route starts
    where the kernel route's did: run free, the 81 bf16 layers amplify one
    bf16 ulp of noise on the embeddings to 11.8 % of the largest logit on
    an H100 (``tools/lm_route_sensitivity.py``), past phase 5's 3 %."""

    def __init__(self, fed=None):
        self.fed = None if fed is None else iter(fed)
        self.inputs = []

    def _wrap(self, real):
        def block(p, x, *args, **kw):
            if self.fed is not None:
                x = next(self.fed)
            self.inputs.append(x)
            return real(p, x, *args, **kw)
        return block

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.real = tf._dense_block_fwd, tf._dense_block_dec
        tf._dense_block_fwd, tf._dense_block_dec = map(self._wrap, self.real)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf
        tf._dense_block_fwd, tf._dense_block_dec = self.real
        if self.fed is not None and exc[0] is None:
            require(next(self.fed, None) is None,
                    "the fed run made fewer block calls")


def lm_families(seed):
    """The LM families' inference paths (phase 5b): each of FAMILIES at full
    width in bf16 from weights seeded on the card, through
    ``launch/lm_steps.py``: a prefill of FAM_BATCH x FAM_PROMPT positions
    (llava: 1,152 media embeddings + 896 text tokens; musicgen: 4
    codebooks), then FAM_NEW greedy decode steps on the kernel route, then
    the plain route on the same fed tokens and, for the MoE archs, the
    same expert choices (``_Routing``), for zamba2 the same residual
    stream entering each shared-block call (``_FedBlocks``), held at phase
    5's bf16 bound scaled by the largest |logit|.  Those archs also run the
    plain route free: its logits' distance and, for MoE, how many
    (token, k) choices it makes otherwise are reported, not held (a
    near-tie that flips sends a token through another expert, and the
    change spreads through attention to later tokens and layers; zamba2's
    81 layers amplify any bf16 rounding past the bound).  Asserts the parameter
    count and each prefill's flash launches; times a warm prefill (host
    wall and CUDA events) and warm decode steps.  Each model is freed
    before the next.  Returns {arch: flash launches}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf

    launches = {}
    for i, (arch, cut, want_flash) in enumerate(FAMILIES):
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **cut)
        gen = torch.Generator("cuda").manual_seed(seed + 50 + i)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        require(n_params == _param_count(cfg),
                f"{arch}: {n_params} params, its dims say "
                f"{_param_count(cfg)} (num_params() {cfg.num_params()})")
        batch = lm_steps.make_batch(cfg, FAM_BATCH, FAM_PROMPT, gen)
        moe = cfg.moe is not None
        hybrid = cfg.arch_type == "hybrid"
        with torch.inference_mode():
            with _Routing() as kern_routing, _FedBlocks() as kern_blocks:
                ops.reset_launch_counts()
                kern = lm_steps.generate(params, batch, cfg, FAM_NEW,
                                         attn_impl="kernel")
                counts = ops.launch_counts()
            require(counts == {"lstm_cell": 0, "gru_cell": 0,
                               "flash_attention": want_flash},
                    f"{arch}: launch counts {counts} in one prefill + "
                    f"{FAM_NEW} decode steps, expected flash_attention = "
                    f"{want_flash}")
            free = {}
            if moe or hybrid:
                # the plain route on its own choices and stream: reported,
                # not held
                with _Routing() as own:
                    free_run = lm_steps.generate(params, batch, cfg,
                                                 FAM_NEW, attn_impl="torch",
                                                 feed=kern["tokens"])
                flips = [int(_set_misses(a, b).sum()) for a, b in
                         zip(kern_routing.calls, own.calls)]
                free = {"over_tol_free": max(_over_tol(kern, free_run))}
                if moe:
                    free.update(routing_flips_free=sum(flips),
                                routing_flips_free_by_call=flips[:8])
                del free_run
            # held: the plain route on the kernel route's tokens and, for
            # the MoE archs, its expert choices, for the hybrid its stream
            # at each shared-block call
            with _Routing(forced=kern_routing.calls if moe else None
                          ) as forced, \
                    _FedBlocks(fed=kern_blocks.inputs if hybrid else None):
                plain = lm_steps.generate(params, batch, cfg, FAM_NEW,
                                          attn_impl="torch",
                                          feed=kern["tokens"])
            del kern_blocks
            choices = sum(a.numel() for a in kern_routing.calls)
            worst = _over_tol(kern, plain)
            require(all(bool(torch.isfinite(a).all()) for a in
                        [kern["prefill_logits"]] + kern["logits"]),
                    f"{arch}: logits not finite")
            require(max(worst) < 1.0, f"{arch}: kernel route vs plain "
                    f"route: max abs logit error {max(worst):.4g} of phase "
                    f"5's bound ({forced.flips} of {choices} routing "
                    "choices the plain route would make otherwise)")
            shp = (FAM_BATCH, 1, cfg.vocab_size)
            if cfg.arch_type == "audio":
                shp = (FAM_BATCH, cfg.frontend.n_codebooks, 1,
                       cfg.vocab_size)
            require(tuple(kern["prefill_logits"].shape) == shp,
                    f"{arch}: last logits {tuple(kern['prefill_logits'].shape)}"
                    f", expected {shp}")
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            # a warm prefill (host wall ending in a synchronise, CUDA events
            # around it) and warm decode steps on its caches
            S = lm_steps.seq_len(batch, cfg)
            capacity = lm_steps.cache_capacity(
                cfg, InputShape("lm", S + FAM_NEW, FAM_BATCH, "prefill"))
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            _, caches = lm_steps.prefill_step(params, batch, cfg,
                                              capacity=capacity)
            end.record()
            torch.cuda.synchronize()
            prefill_wall = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for t in range(FAM_NEW):
                lm_steps.decode_step(params, caches,
                                     kern["tokens"][..., t:t + 1], S + t,
                                     cfg)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / FAM_NEW
        launches[arch] = counts["flash_attention"]
        emit({"phase": "lm_family", "arch": arch,
              "family": cfg.arch_type + ("+mla" if cfg.mla else ""),
              "n_layers": cfg.n_layers,
              "of_layers": get_config(arch).n_layers,
              "d_model": cfg.d_model, "head_dim": cfg.resolved_head_dim,
              "params": n_params, "num_params": cfg.num_params(),
              "dtype": "bfloat16", "batch": FAM_BATCH,
              "prompt_positions": S, "decode_steps": FAM_NEW,
              "flash_launches_per_prefill": counts["flash_attention"],
              "routing_choices": choices,
              "fed": (["tokens"] + ["routing"] * moe
                       + ["shared_block_inputs"] * hybrid),
              "routing_flips_held": forced.flips,
              "routing_flip_max_margin": forced.max_margin, **free,
              "kernel_vs_plain_worst_over_tol": max(worst),
              "over_tol_by_step": worst, "init_s": init_s,
              "peak_memory_gib": peak_gib,
              "prefill_wall_ms_first": kern["prefill_s"] * 1e3,
              "prefill_wall_ms": prefill_wall,
              "prefill_device_ms": start.elapsed_time(end),
              "prefill_wall_ms_plain_route": plain["prefill_s"] * 1e3,
              "decode_ms_per_step": decode_ms,
              "phase_s": time.perf_counter() - t_arch,
              "tokens": kern["tokens"][0].tolist()})
        del params, batch, kern, plain, caches
        torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 6
# launch/train.py's defaults (100 CA buildings, all per round, 365 days,
# B=64, E=1, lr 0.05, ew_mse beta 2, fedavg, no clusters, 200 held-out
# buildings) with the rounds cut 100 -> 3; the plain route for the first 2
# the 2-layer GRU at lr 0.02: at launch/train.py's 0.05, one client's local
# SGD (building 6) diverges to inf within the first round from the seed-0
# init, on both routes and on the CPU alike (the port matches the JAX
# package from the JAX package's init, which trains at 0.05)
GRU_TRAIN = ("--clients", "20", "--days", "60", "--heldout", "20",
             "--lr", "0.02")
TRAIN_ROUNDS, CHECK_ROUNDS = 3, 2
EVAL_BATCH = 8192                  # fedavg.evaluate_global's sub-batches


def _route_deviation(a, b):
    """Kernel route ``a`` against plain route ``b`` (FLResult dicts): the
    worst loss-history error over its rtol 1e-4 and the worst param error
    over rtol 1e-3 / atol 1e-5 (1 = at the tolerance)."""
    import numpy as np
    from repro_torch.models.layers import tree_leaves

    loss = max(float(np.max(np.abs(a[c].loss_history - b[c].loss_history)
                            / (1e-4 * np.abs(b[c].loss_history))))
               for c in b)
    par = max(float(np.max(np.abs(x - y) / (1e-5 + 1e-3 * np.abs(y))))
              for c in b for x, y in zip(tree_leaves(a[c].params),
                                         tree_leaves(b[c].params)))
    return {"loss_history_over_tol": loss, "params_over_tol": par}


def _train_routes(argv, fcfg):
    """run_federated_training on the kernel route (its launches counted)
    and on the plain route, from the same seeded init, for the config of
    launch/train.py's flags ``argv``.  Returns both results, the kernel
    route's launches, the flags and the local steps per round."""
    from repro_torch.core import fedavg
    from repro_torch.data import partition, synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args, _, flcfg = train.configs(argv)
    series = synthetic.generate_buildings(args.state, list(range(
        args.clients)), days=args.days)
    steps = partition.local_steps(
        fedavg._as_provider(series, fcfg).n_win_max, args.batch_size,
        args.local_epochs)
    ops.reset_launch_counts()
    kern = fedavg.run_federated_training(series, fcfg, flcfg, device="cuda")
    counts = ops.launch_counts()
    plain = fedavg.run_federated_training(series, fcfg, flcfg,
                                          cell_impl="torch", device="cuda")
    return kern, plain, counts, args, steps


def _step_split(fcfg, seed, n_clients=100, days=365, reps=10):
    """One warm local step of n_clients at B=64 (``client.sgd_step``), at
    the phase's shapes: its unprofiled wall; the device time of each of its
    parts (the forward kernel, the head, the loss, the plain backward, the
    SGD update) from CUDA events between the parts, with the host held
    ahead of the card by a spin so that no host gap falls between two
    events (median of ``reps``); and torch.profiler over one step: the
    device's activities, its busy share of the wall, and the costliest
    kernels.  The profiler does not always list the layer kernel (a
    ctypes launch), so the split comes from the events."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import fedavg, losses
    from repro_torch.core.client import sgd_step
    from repro_torch.data import synthetic
    from repro_torch.models import forecaster
    from repro_torch.models.layers import (seeded_generator, tree_leaves,
                                           tree_map)

    series = synthetic.generate_buildings("CA", list(range(n_clients)),
                                          days=days)
    x, y, _ = fedavg._as_provider(series, fcfg).round_batch(
        np.arange(n_clients))
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, x.shape[1], (n_clients, 64))
                           ).cuda()
    rows = torch.arange(n_clients, device="cuda")[:, None]
    batch = {"x": torch.from_numpy(x).cuda()[rows, idx],
             "y": torch.from_numpy(y).cuda()[rows, idx]}
    params = forecaster.init_forecaster(seeded_generator(seed, 0), fcfg)
    stacked = tree_map(lambda w: w.cuda().expand((n_clients,) + w.shape)
                       .clone(), params)
    loss, lr = losses.make_loss("ew_mse", 2.0), 0.05

    def step():
        return sgd_step(stacked, batch, lr, fcfg, loss)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 20

    # the same step in its parts (client.sgd_step's body), an event after
    # each; the autograd engine runs the backward on the same stream
    parts = ("forward_kernel", "head", "loss", "backward", "sgd_update")

    def split_step(events):
        leaves = [t.detach().requires_grad_()
                  for t in tree_leaves(stacked)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), stacked)
        events[0].record()
        with torch.enable_grad():
            h = forecaster.encode(p, batch["x"], fcfg)
            events[1].record()
            pred = forecaster.head(p, h)
            events[2].record()
            per_client = loss(pred, batch["y"], dim=(-2, -1))
            events[3].record()
            grads = torch.autograd.grad(per_client.sum(), leaves)
            events[4].record()
        with torch.no_grad():
            [w - lr * g for w, g in zip(tree_leaves(stacked), grads)]
        events[5].record()

    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / a.elapsed_time(b)
    split = []
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda._sleep(int(cycles_per_ms * 3 * wall_ms))
        split_step(events)
        torch.cuda.synchronize()
        split.append([events[i].elapsed_time(events[i + 1])
                      for i in range(5)])
    by_part = dict(zip(parts, np.median(np.array(split), axis=0).tolist()))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = sorted(acts, key=lambda e: -e.self_device_time_total)[:12]
    device_ms = sum(by_part.values())
    return {
        "clients": n_clients, "batch": 64, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ms_by_part": by_part, "split_median_of": reps,
        "profiler": {
            "device_activities": sum(e.count for e in acts),
            "device_ms": sum(e.self_device_time_total for e in acts) / 1e3,
            "layer_kernel_listed": any("_layer_kernel" in e.key
                                       for e in acts),
            "top": [{"name": e.key[:90], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}}


def train_slice(seed):
    """Federated training on the card (phase 6).  The main path:
    ``launch/train.py`` with its defaults, rounds cut to TRAIN_ROUNDS,
    through ``run_federated_training`` on the kernel route at
    ``ForecasterConfig()``, then evaluation on 200 held-out buildings; its
    LSTM launches must be rounds x local steps x n_layers in training and
    one per 8192-window batch in evaluation.  Then the kernel and plain
    routes for CHECK_ROUNDS rounds from the same init, held to each other at
    the CPU tests' tolerances; the 2-layer GRU on 20 buildings x 60 days the
    same way; and a profile of one warm local step.  Returns the training
    launches of each cell."""
    import math

    import numpy as np
    from repro_torch.configs.base import ForecasterConfig
    from repro_torch.core import fedavg
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    main_argv = ["--rounds", str(TRAIN_ROUNDS), "--seed", str(seed)]
    margs, _, _ = train.configs(main_argv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(main_argv)
    main_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = summary["local_steps_per_round"]
    want_train = TRAIN_ROUNDS * steps
    want_eval = math.ceil(summary["heldout_windows"] / EVAL_BATCH)
    require(summary["launches_train"] == {"lstm_cell": want_train,
                                          "gru_cell": 0,
                                          "flash_attention": 0},
            f"training launches {summary['launches_train']}, expected "
            f"lstm_cell = {TRAIN_ROUNDS} rounds x {steps} steps x 1 layer")
    require(summary["launches_eval"]["lstm_cell"] == want_eval,
            f"evaluation launches {summary['launches_eval']}, expected "
            f"{want_eval} (one per {EVAL_BATCH}-window batch)")
    require(counts["lstm_cell"] == want_train + want_eval,
            f"launch counts {counts} over the main path")
    hist = np.array(summary["loss_history"]["-1"])
    held = summary["heldout"]
    require(np.isfinite(hist).all() and hist[-1] < hist[0],
            f"training loss not finite and falling: {hist}")
    require(all(np.isfinite(v) for v in held.values())
            and 0 < held["accuracy"] <= 100, f"held-out metrics {held}")

    argv = ["--rounds", str(CHECK_ROUNDS), "--seed", str(seed)]
    kern, plain, _, _, _ = _train_routes(argv, ForecasterConfig())
    dev = _route_deviation(kern, plain)
    require(max(dev.values()) <= 1.0, f"kernel vs plain route: {dev}")
    np.testing.assert_allclose(hist[:CHECK_ROUNDS],
                               kern[-1].loss_history, rtol=1e-4)

    gcfg = ForecasterConfig(cell="gru", n_layers=2)
    gkern, gplain, gcounts, gargs, gsteps = _train_routes(
        [*GRU_TRAIN, *argv], gcfg)
    require(gcounts == {"lstm_cell": 0, "gru_cell": CHECK_ROUNDS * gsteps * 2,
                        "flash_attention": 0},
            f"GRU-2 launch counts {gcounts}, expected {CHECK_ROUNDS} rounds "
            f"x {gsteps} steps x 2 layers")
    gdev = _route_deviation(gkern, gplain)
    require(max(gdev.values()) <= 1.0, f"GRU-2 kernel vs plain: {gdev}")
    ghist = gkern[-1].loss_history
    require(np.isfinite(ghist).all(), f"GRU-2 loss {ghist}")
    held_ids = list(range(10_000, 10_000 + int(gargs.heldout)))
    gheld = fedavg.evaluate_unseen_clients(
        gkern[-1].params, synthetic.generate_buildings(
            gargs.state, held_ids, days=gargs.days), gcfg, device="cuda")

    split = _step_split(ForecasterConfig(), seed)
    emit({"phase": "train", "cfg": dataclasses.asdict(ForecasterConfig()),
          "clients": margs.clients,
          "clients_per_round": summary["clients_per_round"],
          "days": margs.days, "rounds": TRAIN_ROUNDS,
          "cut": "rounds 100 -> 3 (launch/train.py's defaults otherwise)",
          "local_steps_per_round": steps,
          "wall_s_per_round": summary["wall_s_per_round"],
          "local_steps_per_s": steps / summary["wall_s_per_round"],
          "main_path_s": main_s, "loss_history": hist.tolist(),
          "heldout_buildings": margs.heldout, "heldout": held,
          "launches": counts, "launches_train": summary["launches_train"],
          "launches_eval": summary["launches_eval"],
          "route_check_rounds": CHECK_ROUNDS,
          "kernel_vs_plain": dev, "local_step_profile": split,
          "gru2": {"clients": gargs.clients, "days": gargs.days,
                   "rounds": CHECK_ROUNDS,
                   "local_steps_per_round": gsteps, "launches": gcounts,
                   "loss_history": ghist.tolist(), "kernel_vs_plain": gdev,
                   "heldout_buildings": len(held_ids),
                   "heldout": {k: gheld[k] for k in
                               ("accuracy", "mape", "rmse")}}})
    return ({"lstm_cell": want_train, "gru_cell": gcounts["gru_cell"]},
            {"wall_s_per_round": summary["wall_s_per_round"],
             "accuracy": held["accuracy"]})


# --------------------------------------------------------------- phase 7
# train-lstm with the privacy pipeline: phase 6's setting (launch/train.py's
# defaults, 3 rounds) under per-client L2 clip 1.0, Gaussian noise z = 0.5,
# 8-bit quantization and secure aggregation, so the ring quantizer is on
# (the DP + quantize + secure-agg flags of benchmarks/bench_scalability.py,
# its usage lines 57-59); ring_levels(8, 100, 2.0) = 9 levels
DP = dict(dp_clip=1.0, dp_noise=0.5, quantize_bits=8, secure_agg=True)


def _round0(provider, flcfg, seed, steps):
    """Round 0's (x, y, minibatch indices, sample counts) on the host,
    drawn as run_federated_training draws them."""
    import numpy as np
    from repro_torch.core import fedavg, sampling
    from repro_torch.data import partition

    holdout_rng, rng = fedavg._seed_rngs(seed)
    train_ids, _ = partition.holdout_clients(holdout_rng, provider.n_clients,
                                             flcfg.holdout_frac)
    counts = provider.train_counts.astype(np.float32)
    m = min(flcfg.clients_per_round, len(train_ids))
    sel = sampling.make_sampler(flcfg.sampling_config)(
        rng, train_ids, m, 0, counts[train_ids])
    bidx = partition.ragged_minibatch_indices(rng, counts[sel], steps,
                                              flcfg.batch_size)
    x, y, w = provider.round_batch(sel)
    return x, y, bidx, w


def _stage_split(engine, params, locals_, client_loss, w, reps=5):
    """The transform -> mask -> decode stage of one round (round 0's keys)
    in its three parts, with a CUDA event after each: the deltas with
    clip, noise and the ring quantizer; the pairwise masker; the unweighted
    sum, ring wrap and decode.  Its output must equal
    ``fedavg.transform_and_aggregate``'s bit for bit.  Returns the device
    ms of each part (median of ``reps``) and the stage's host wall."""
    import numpy as np
    import torch
    from repro_torch.core import fedavg, secure_agg, transforms
    from repro_torch.models.layers import tree_leaves, tree_map

    stack = engine.stack
    M = w.shape[0]
    keys = engine.round_keys(0, M)
    rk = engine.base_round_key(0)
    ctx = secure_agg.CohortContext(torch.arange(M, device=w.device), w, rk)
    front = transforms.TransformStack(stack.transforms[:-1])
    masker = stack.transforms[-1]
    bits, sens, head = stack.ring_spec
    scale = transforms.ring_scale(bits, sens, M, head)

    def run(ev):
        ev[0].record()
        up = front(tree_map(lambda l, g: l - g, locals_, params), keys, ctx)
        ev[1].record()
        up = masker(up, None, ctx)
        ev[2].record()
        agg = tree_map(lambda g, d: g + scale * transforms.ring_wrap(
            d.sum(0), bits), params, up)
        ev[3].record()
        return agg

    want, _ = fedavg.transform_and_aggregate(params, locals_, client_loss, w,
                                             keys, stack, rk)
    parts, walls = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(ev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    require(all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(want))),
            "the timed stage differs from transform_and_aggregate")
    med = np.median(np.array(parts), axis=0).tolist()
    return {"device_ms": dict(zip(("clip_noise_quantize", "mask",
                                   "sum_wrap_decode"), med)),
            "device_ms_total": sum(med), "wall_ms": float(np.median(walls)),
            "median_of": reps}


def train_dp_slice(seed, phase6):
    """Federated training with the privacy pipeline on the card (phase 7).
    The main path: ``run_federated_training`` at phase 6's setting plus
    ``DP`` on the kernel route for TRAIN_ROUNDS rounds, then evaluation on
    the 200 held-out buildings; its LSTM launches must be rounds x local
    steps in training and one per 8192-window batch in evaluation.  Then
    (a) one round's aggregate with masking equals it with the ring
    quantizer and no masking, bit for bit; (b) with clip + noise only, the
    kernel and plain routes agree after CHECK_ROUNDS rounds at phase 6's
    tolerances; (c) under the full stack one round's aggregates of the two
    routes differ by at most one ring grid step per coordinate; (d) the
    held-out numbers are finite; (e) epsilon at delta 1e-5 from the
    central secure-agg accountant; (f) the wall per round beside phase
    6's, and the device time of the transform, mask and decode stage.
    Returns the main path's LSTM launches."""
    import math

    import numpy as np
    import torch
    from repro_torch.core import fedavg, transforms
    from repro_torch.core.client import local_update
    from repro_torch.data import partition, synthetic, windows
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.layers import seeded_generator, tree_leaves

    args, fcfg, base = train.configs(["--rounds", str(TRAIN_ROUNDS),
                                      "--seed", str(seed)])
    flcfg = dataclasses.replace(base, **DP)
    series = synthetic.generate_buildings(args.state, list(range(
        args.clients)), days=args.days)
    provider = fedavg._as_provider(series, fcfg)
    steps = partition.local_steps(provider.n_win_max, args.batch_size,
                                  args.local_epochs)
    held = synthetic.generate_buildings(
        args.state, list(range(10_000, 10_000 + args.heldout)),
        days=args.days)
    hx, hy, hstats = windows.flatten_test_windows(
        windows.batched_client_windows(held, fcfg.lookback, fcfg.horizon))

    # ---- the main path
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fedavg.run_federated_training(provider, fcfg, flcfg, device="cuda")
    train_s = time.perf_counter() - t0
    r = res[-1]
    held_m = fedavg.evaluate_global(r.params, hx, hy, fcfg, stats=hstats,
                                    device="cuda")
    counts = ops.launch_counts()
    want_train = TRAIN_ROUNDS * steps * fcfg.n_layers
    want_eval = math.ceil(hx.shape[0] / EVAL_BATCH)
    require(counts == {"lstm_cell": want_train + want_eval, "gru_cell": 0,
                       "flash_attention": 0},
            f"phase 7 launch counts {counts}, expected lstm_cell = "
            f"{TRAIN_ROUNDS} x {steps} + {want_eval}")
    hist = r.loss_history
    require(np.isfinite(hist).all(), f"DP training loss {hist}")
    held_m = {k: held_m[k] for k in ("accuracy", "mape", "rmse")}
    require(all(np.isfinite(v) for v in held_m.values())
            and 0 <= held_m["accuracy"] <= 100, f"held-out {held_m}")
    priv = r.privacy
    require(priv["mode"] == "central:secure-agg" and priv["enabled"]
            and np.isfinite(priv["epsilon"]) and priv["delta"] == 1e-5,
            f"accountant {priv}")

    # ---- (a) masked == clear, (c) routes under the full stack, (f) stage
    engine = fedavg.RoundEngine(fcfg, flcfg, device="cuda")
    clear = transforms.make_stack(dataclasses.replace(
        flcfg.transform, quantize_ring=True))
    require(clear.ring_spec == engine.stack.ring_spec
            and not any(getattr(t, "is_masker", False)
                        for t in clear.transforms), "clear stack")
    params, _ = engine.init(seeded_generator(seed, 0))
    x, y, bidx, w = (torch.from_numpy(a).cuda()
                     for a in _round0(provider, flcfg, seed, steps))
    if not engine.weighted:
        w = (w > 0).float()
    keys, rk = engine.round_keys(0, w.shape[0]), engine.base_round_key(0)
    loc = {}
    for impl in ("kernel", "torch"):
        loc[impl] = local_update(params, x, y, bidx, flcfg.lr, fcfg,
                                 engine.loss, impl, engine.prox_mu)
    agg = {}
    for name, stack, impl in (("masked", engine.stack, "kernel"),
                              ("clear", clear, "kernel"),
                              ("masked_plain", engine.stack, "torch")):
        with torch.no_grad():
            agg[name] = fedavg.transform_and_aggregate(
                params, *loc[impl], w, keys, stack, rk)
    require(all(t.is_cuda for t in tree_leaves(agg["masked"][0])),
            "aggregate not on the card")
    equal = torch.equal(agg["masked"][1], agg["clear"][1]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(agg["masked"][0]),
                                          tree_leaves(agg["clear"][0])))
    require(equal, "ring-masked aggregate differs from the clear one")
    bits, sens, head = engine.stack.ring_spec
    grid = transforms.ring_scale(bits, sens, w.shape[0], head)
    diffs = [(a - b).abs() for a, b in zip(
        tree_leaves(agg["masked"][0]), tree_leaves(agg["masked_plain"][0]))]
    steps_off = max(float(d.max()) for d in diffs) / grid
    require(steps_off <= 1.0 + 1e-3, f"full stack: kernel vs plain route "
            f"aggregates differ by {steps_off:.3g} grid steps")
    with torch.no_grad():
        stage = _stage_split(engine, params, *loc["kernel"], w)

    # ---- (b) clip + noise, both routes, CHECK_ROUNDS rounds
    cn = dataclasses.replace(flcfg, rounds=CHECK_ROUNDS, quantize_bits=0,
                             secure_agg=False)
    kern = fedavg.run_federated_training(provider, fcfg, cn, device="cuda")
    plain = fedavg.run_federated_training(provider, fcfg, cn,
                                          cell_impl="torch", device="cuda")
    dev = _route_deviation(kern, plain)
    require(max(dev.values()) <= 1.0, f"clip + noise: kernel vs plain {dev}")

    emit({"phase": "train_dp", "cfg": dataclasses.asdict(fcfg),
          "clients": args.clients, "days": args.days,
          "rounds": TRAIN_ROUNDS, "privacy_knobs": DP,
          "ring": {"bits": bits, "levels": transforms.ring_levels(
              bits, w.shape[0], head), "grid_step": grid},
          "local_steps_per_round": steps,
          "wall_s_per_round": train_s / TRAIN_ROUNDS,
          "phase6_wall_s_per_round": phase6["wall_s_per_round"],
          "loss_history": hist.tolist(), "heldout": held_m,
          "phase6_heldout_accuracy": phase6["accuracy"],
          "epsilon": priv["epsilon"], "delta": priv["delta"],
          "accountant": priv, "eps_history": r.eps_history.tolist(),
          "launches": counts, "masked_equals_clear_bitwise": equal,
          "clip_noise_kernel_vs_plain": dev,
          "full_stack_kernel_vs_plain_grid_steps": steps_off,
          "full_stack_coords_differing": int(sum(
              int((d > 0).sum()) for d in diffs)),
          "stage": stage})
    return counts["lstm_cell"]


# --------------------------------------------------------------- phase 8
# the rank-sharded round (core/aggregation.py): phase 6's setting for one
# round (launch/train.py's defaults, 100 clients x 365 days, 411 local
# steps), flat and hierarchical, on one NCCL rank (8a) and on four gloo
# ranks sharing the one card, 25 clients a rank on the kernel's grid (8b);
# the ring case adds phase 7's DP knobs (masks across ranks)
MESH_RANKS = 4
MESH_TIMEOUT_S = 600


class _TimedReduce:
    """An aggregator whose ``reduce`` also adds its host wall (the card
    synchronised on both sides) to ``seconds``."""

    def __init__(self, agg):
        self.agg, self.seconds, self.calls = agg, 0.0, 0
        self.mesh_axes = agg.mesh_axes

    def reduce(self, x):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = self.agg.reduce(x)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return y


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_round(engine, params_np, data):
    """One round of ``engine`` from ``params_np`` on round-0 ``data``; its
    aggregator timed.  Returns (params as numpy, loss, wall s, reduce s,
    reduce calls)."""
    import torch
    from repro_torch.models import forecaster

    timed = engine.agg = _TimedReduce(engine.agg)
    p, s = engine.init(params=params_np)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s, loss = engine.step(p, s, *data, round_idx=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (forecaster.params_to_numpy(p), float(loss), wall, timed.seconds,
            timed.calls)


def _mesh_cases(seed):
    """(fcfg, {case: FLConfig kwargs}): phase 6's configuration for one
    round, and the same under phase 7's DP knobs (the ring)."""
    from repro_torch.launch import train

    _, fcfg, flcfg = train.configs(["--rounds", "1", "--seed", str(seed)])
    kw = dataclasses.asdict(flcfg)
    return fcfg, {"identity": kw, "ring": dict(kw, **DP)}


def _mesh_engines(fcfg, kw, meshes):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import fedavg

    for topo, mesh in meshes.items():
        yield topo, fedavg.RoundEngine(
            fcfg, FLConfig(**dict(kw, aggregation=topo,
                                  n_regions=mesh.shape.get("region", 0))),
            mesh=mesh, device="cuda")


def _gloo_rank(rank, world, init, data_dir, seed, params):
    """Phase 8b's rank program (spawned): join the gloo group, run one
    round of each case flat over every rank and hierarchical 2 x 2 on the
    card, write params, loss, wall and reduce time to
    ``<data_dir>/rank<r>.npz``."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        ops.build()                    # the parent's build, loaded
        data = [np.load(Path(data_dir) / f"{k}.npy", mmap_mode="c")
                for k in ("x", "y", "bidx", "w")]
        fcfg, cases = _mesh_cases(seed)
        meshes = {"flat": aggregation.make_mesh(AggregationConfig()),
                  "hierarchical": aggregation.make_mesh(AggregationConfig(
                      kind="hierarchical", n_regions=2))}
        out = {}
        ops.reset_launch_counts()
        for case, kw in cases.items():
            for topo, engine in _mesh_engines(fcfg, kw, meshes):
                p, loss, wall, red, calls = _mesh_round(engine, params,
                                                        data)
                for k, v in _flat_params(p).items():
                    out[f"{case}.{topo}.{k}"] = v
                out[f"{case}.{topo}.stats"] = np.array([loss, wall, red,
                                                        calls])
        out["launches"] = np.array(ops.launch_counts()["lstm_cell"])
        np.savez(Path(data_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _flat_params(p):
    return {**{f"layers.{k}": p["layers"][0][k] for k in ("wx", "wh", "b")},
            **{f"head.{k}": p["head"][k] for k in ("w", "b")}}


def _params_equal(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(
        _flat_params(a).values(), _flat_params(b).values()))


def _params_close(a, b, rtol, atol):
    """Worst error over rtol / atol (1 = at the tolerance)."""
    import numpy as np
    return max(float(np.max(np.abs(x - y) / (atol + rtol * np.abs(y))))
               for x, y in zip(_flat_params(a).values(),
                               _flat_params(b).values()))


def mesh_slice(seed):
    """The rank-sharded round on the card (phase 8).  8a: one NCCL rank,
    flat and hierarchical 1 x 1, one round each of phase 6's setting and of
    its ring case, bit-equal to the local round.  8b: four gloo ranks
    spawned on the one card (the kernels built once here, loaded by each
    rank), flat 4 and hierarchical 2 x 2, 25 clients a rank: held to the
    local round at rtol 1e-6 / atol 1e-7 (loss rtol 1e-6), the ring case
    bit-equal, every rank's params equal.  Returns the lstm_cell launches
    of the mesh rounds (8a, 8b)."""
    import datetime
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from repro_torch.configs.base import AggregationConfig, FLConfig
    from repro_torch.core import aggregation, fedavg
    from repro_torch.data import partition, synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import forecaster
    from repro_torch.models.layers import seeded_generator

    fcfg, cases = _mesh_cases(seed)
    flcfg = FLConfig(**cases["identity"])
    provider = fedavg._as_provider(synthetic.generate_buildings(
        "CA", list(range(flcfg.n_clients)), days=365), fcfg)
    steps = partition.local_steps(provider.n_win_max, flcfg.batch_size,
                                  flcfg.local_epochs)
    data = _round0(provider, flcfg, seed, steps)
    params = forecaster.params_to_numpy(forecaster.init_forecaster(
        seeded_generator(seed, 0), fcfg))
    local = {}
    for case, kw in cases.items():
        e = fedavg.RoundEngine(fcfg, FLConfig(**kw), device="cuda")
        local[case] = _mesh_round(e, params, data)

    # ---- 8a: one NCCL rank
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {"flat": aggregation.make_mesh(AggregationConfig()),
                  "hierarchical": aggregation.make_mesh(AggregationConfig(
                      kind="hierarchical"))}
        require(meshes["hierarchical"].shape == {"region": 1, "clients": 1}
                and dist.get_backend() == "nccl", "phase 8a mesh")
        nccl = {}
        ops.reset_launch_counts()
        for case, kw in cases.items():
            for topo, engine in _mesh_engines(fcfg, kw, meshes):
                nccl[f"{case}.{topo}"] = _mesh_round(engine, params, data)
        nccl_launches = ops.launch_counts()["lstm_cell"]
    finally:
        dist.destroy_process_group()
    require(nccl_launches == 4 * steps, f"phase 8a launches {nccl_launches},"
            f" expected 4 rounds x {steps} steps")
    for key, r in nccl.items():
        want = local[key.split(".")[0]]
        require(_params_equal(r[0], want[0]) and r[1] == want[1],
                f"phase 8a {key}: the one-rank NCCL round differs from the "
                "local round")

    # ---- 8b: four gloo ranks on the one card
    work = Path(tempfile.mkdtemp(prefix="mesh8b_"))
    for k, a in zip(("x", "y", "bidx", "w"), data):
        np.save(work / f"{k}.npy", a)
    t0 = time.perf_counter()
    ctx = tmp.start_processes(_gloo_rank, args=(MESH_RANKS,
                                                str(work / "pg_init"),
                                                str(work), seed, params),
                              nprocs=MESH_RANKS, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.05)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"phase 8b ranks not done in "
                               f"{MESH_TIMEOUT_S} s")
    spawn_s = time.perf_counter() - t0
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(MESH_RANKS)]
    gloo, worst = {}, {}
    for case in cases:
        for topo in ("flat", "hierarchical"):
            key = f"{case}.{topo}"
            got = [({"layers": [{k: r[f"{key}.layers.{k}"]
                                 for k in ("wx", "wh", "b")}],
                     "head": {k: r[f"{key}.head.{k}"] for k in ("w", "b")}},
                    r[f"{key}.stats"]) for r in ranks]
            want_p, want_l = local[case][0], local[case][1]
            require(all(_params_equal(g[0], got[0][0]) for g in got),
                    f"phase 8b {key}: ranks hold different params")
            if case == "ring":
                require(_params_equal(got[0][0], want_p),
                        f"phase 8b {key}: the ring round differs from the "
                        "local one")
            err = _params_close(got[0][0], want_p, 1e-6, 1e-7)
            lerr = abs(got[0][1][0] - want_l) / (1e-6 * abs(want_l))
            require(err <= 1.0 and lerr <= 1.0, f"phase 8b {key}: params "
                    f"{err:.3g}, loss {lerr:.3g} of the tolerance")
            worst[key] = {"params_over_tol": err, "loss_over_tol": lerr,
                          "bit_equal_local": _params_equal(got[0][0],
                                                           want_p)}
            gloo[key] = {"wall_s_by_rank": [float(g[1][1]) for g in got],
                         "reduce_s_by_rank": [float(g[1][2]) for g in got],
                         "reduce_calls": int(got[0][1][3])}
    gloo_launches = [int(r["launches"]) for r in ranks]
    require(gloo_launches == [4 * steps] * MESH_RANKS,
            f"phase 8b launches by rank {gloo_launches}, expected 4 rounds x "
            f"{steps} steps each")

    emit({"phase": "mesh", "cfg": dataclasses.asdict(fcfg),
          "clients": int(data[3].shape[0]), "local_steps": steps,
          "cases": {k: {kk: v for kk, v in kw.items()
                        if kk in ("dp_clip", "dp_noise", "quantize_bits",
                                  "secure_agg")} for k, kw in cases.items()},
          "local": {k: {"loss": v[1], "wall_s": v[2]}
                    for k, v in local.items()},
          "nccl_1": {k: {"loss": v[1], "wall_s": v[2], "reduce_s": v[3],
                         "reduce_calls": v[4], "bit_equal_local": True}
                     for k, v in nccl.items()},
          "nccl_launches": nccl_launches,
          "gloo_4": {"ranks": MESH_RANKS, "clients_per_rank":
                     int(data[3].shape[0]) // MESH_RANKS,
                     "spawn_to_join_s": spawn_s, "by_case": gloo,
                     "vs_local": worst, "launches_by_rank": gloo_launches}})
    return nccl_launches, sum(gloo_launches)


# --------------------------------------------------------------- phase 9
# semi-synchronous rounds: the pacing setting of
# benchmarks/bench_scalability.py (usage lines 60-61, run_pacing at
# :298-340): 500 CA buildings x 120 days, m = 32, m' = 48 (over_select
# 1.5), buffer_k = 32, lognormal stragglers of jitter 1.0, alpha 0.5,
# fedavg_weighted, ew_mse, lr 0.05; rounds 12 -> 6; 50 unseen buildings
PACING = dict(n_clients=500, clients_per_round=32, rounds=6, lr=0.05,
              loss="ew_mse", n_clusters=0, server_opt="fedavg_weighted",
              stragglers="lognormal", straggler_jitter=1.0)
SEMI = dict(mode="semi_sync", over_select=1.5, buffer_k=32,
            staleness_alpha=0.5)
CHURN = dict(dropout_prob=0.3, timeout_rounds=1, quantize_bits=8,
             dp_clip=1.0)
PACING_DAYS, PACING_HELD, KILL_AT = 120, 50, 3


class _Engines:
    """Record the RoundEngines ``fedavg.run_federated_training`` builds
    (their SemiSyncState counters are the phase's readout)."""

    def __enter__(self):
        from repro_torch.core import fedavg
        self.real, self.built = fedavg.RoundEngine, []
        built = self.built

        class Recorded(self.real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)

        fedavg.RoundEngine = Recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core import fedavg
        fedavg.RoundEngine = self.real


def _json_floats(a):
    """A float array as a JSON list, ``nan`` (a flush that folds nothing)
    as null."""
    import numpy as np
    return [float(v) if np.isfinite(v) else None for v in a]


def _same_run(a, b):
    """Histories (nan == nan) and params of two FLResults bit for bit."""
    import numpy as np
    return (all(np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
                for k in ("loss_history", "sim_times", "eps_history"))
            and _params_equal(a.params, b.params))


def pacing_slice(seed):
    """Semi-synchronous rounds on the card (phase 9).  The main path:
    ``run_federated_training`` at PACING + SEMI on the kernel route (its
    launches: rounds x local steps, every round dispatching m' clients),
    the sync run on the same latency model, held-out accuracy on 50
    unseen buildings.  Then: the kernel route against the plain route on
    the first 2 rounds at phase 6's tolerances, ``sim_times`` equal; the
    same run under dropout 0.3 / timeout 1 with the 8-bit ring, clip 1.0
    and secure aggregation, bit-equal to the ring-clear cohort-atomic run
    with re-keys; that run twice (determinism) and killed at round 3 and
    resumed from its checkpoint, bit-equal; ``ModelRegistry``'s poll of
    the written checkpoint publishes generation 6.  Returns the lstm_cell
    launches of the semi-sync and churned main runs."""
    import tempfile

    import numpy as np
    from repro_torch.configs.base import FLConfig, ForecasterConfig
    from repro_torch.core import fedavg
    from repro_torch.data import partition, windows
    from repro_torch.kernels import ops
    from repro_torch.serving import ModelRegistry

    fcfg = ForecasterConfig()
    provider = windows.ClientWindowProvider.from_synthetic(
        "CA", range(PACING["n_clients"]), fcfg.lookback, fcfg.horizon,
        days=PACING_DAYS)
    held = windows.ClientWindowProvider.from_synthetic(
        "CA", range(PACING["n_clients"], PACING["n_clients"] + PACING_HELD),
        fcfg.lookback, fcfg.horizon, days=PACING_DAYS)
    steps = partition.local_steps(provider.n_win_max, 64, 1)
    semi = FLConfig(**PACING, **SEMI, seed=seed)
    sync = FLConfig(**PACING, seed=seed)

    # ---- the main path
    ops.reset_launch_counts()
    with _Engines() as rec:
        t0 = time.perf_counter()
        res = fedavg.run_federated_training(provider, fcfg, semi,
                                            device="cuda")[-1]
        semi_s = time.perf_counter() - t0
    launches = ops.launch_counts()["lstm_cell"]
    ss = rec.built[-1].async_state
    require(launches == semi.rounds * steps, f"phase 9 launches {launches},"
            f" expected {semi.rounds} x {steps}")
    require(np.isfinite(res.loss_history).all()
            and ss.late_folds > 0, f"semi-sync run {res.loss_history}, "
            f"late folds {ss.late_folds}")
    acc = fedavg.evaluate_unseen_clients(res.params, held, fcfg,
                                         device="cuda")
    acc = {k: acc[k] for k in ("accuracy", "mape", "rmse")}
    require(all(np.isfinite(v) for v in acc.values())
            and 0 <= acc["accuracy"] <= 100, f"held-out {acc}")
    t0 = time.perf_counter()
    res_sync = fedavg.run_federated_training(provider, fcfg, sync,
                                             device="cuda")[-1]
    sync_s = time.perf_counter() - t0

    # ---- the kernel route against the plain route, 2 rounds
    two = dataclasses.replace(semi, rounds=CHECK_ROUNDS)
    kern = fedavg.run_federated_training(provider, fcfg, two, device="cuda")
    plain = fedavg.run_federated_training(provider, fcfg, two,
                                          cell_impl="torch", device="cuda")
    dev = _route_deviation(kern, plain)
    require(max(dev.values()) <= 1.0
            and np.array_equal(kern[-1].sim_times, plain[-1].sim_times),
            f"phase 9 kernel vs plain route {dev}")

    # ---- churn + ring + secure aggregation; determinism; kill and resume
    masked = FLConfig(**PACING, **SEMI, **CHURN, secure_agg=True, seed=seed)
    clear = FLConfig(**PACING, **SEMI, **CHURN, quantize_ring=True,
                     cohort_atomic=True, seed=seed)
    ck_dir = Path(tempfile.mkdtemp(prefix="pacing9_"))
    ops.reset_launch_counts()
    with _Engines() as rec:
        t0 = time.perf_counter()
        r_masked = fedavg.run_federated_training(provider, fcfg, masked,
                                                 device="cuda")[-1]
        churn_s = time.perf_counter() - t0
    churn_launches = ops.launch_counts()["lstm_cell"]
    css = rec.built[-1].async_state
    require(churn_launches == masked.rounds * steps,
            f"phase 9 churn launches {churn_launches}")
    r_clear = fedavg.run_federated_training(provider, fcfg, clear,
                                            device="cuda")[-1]
    require(css.rekeys > 0 and _same_run(r_masked, r_clear)
            and np.isfinite(r_masked.loss_history).any(),
            f"ring-masked run differs from the ring-clear one (re-keys "
            f"{css.rekeys})")
    ck = ck_dir / "full"
    r_again = fedavg.run_federated_training(provider, fcfg, masked,
                                            device="cuda",
                                            checkpoint_path=ck)[-1]
    require(_same_run(r_again, r_masked),
            "the churned run differs between two runs on the card")
    kill = ck_dir / "kill"
    fedavg.run_federated_training(provider, fcfg, masked, device="cuda",
                                  checkpoint_path=kill,
                                  stop_after_rounds=KILL_AT)
    r_resumed = fedavg.run_federated_training(provider, fcfg, masked,
                                              device="cuda",
                                              checkpoint_path=kill)[-1]
    require(_same_run(r_resumed, r_masked),
            "the resumed run differs from the uninterrupted one")
    reg = ModelRegistry(device="cuda")
    handles = reg.poll_checkpoint(str(ck) + "*", fcfg)
    require([h.generation for h in handles] == [masked.rounds]
            and reg.generation(-1) == masked.rounds,
            f"poll_checkpoint published {[h.generation for h in handles]}")

    emit({"phase": "pacing", "cfg": dataclasses.asdict(fcfg),
          "clients": PACING["n_clients"], "days": PACING_DAYS,
          "m": PACING["clients_per_round"],
          "m_prime": rec.built[-1].dispatch_m(PACING["clients_per_round"]),
          "buffer_k": SEMI["buffer_k"], "rounds": semi.rounds,
          "cut": "rounds 12 -> 6 (bench_scalability's usage line 60)",
          "local_steps_per_round": steps,
          "wall_s_per_round": semi_s / semi.rounds,
          "sync_wall_s_per_round": sync_s / sync.rounds,
          "sim_s": res.sim_times.tolist(),
          "sync_sim_s": res_sync.sim_times.tolist(),
          "loss_history": _json_floats(res.loss_history),
          "sync_loss_history": _json_floats(res_sync.loss_history),
          "late_folds": ss.late_folds, "max_staleness": ss.max_staleness,
          "pending_at_end": len(ss.pending),
          "heldout_buildings": PACING_HELD, "heldout": acc,
          "launches": launches, "kernel_vs_plain": dev,
          "churn": {"knobs": dict(CHURN, secure_agg=True),
                    "wall_s_per_round": churn_s / masked.rounds,
                    "loss_history": _json_floats(r_masked.loss_history),
                    "sim_s": r_masked.sim_times.tolist(),
                    "rekeys": css.rekeys, "abandoned": css.abandoned,
                    "empty_flushes": css.empty_flushes,
                    "late_folds": css.late_folds,
                    "masked_equals_clear_bitwise": True,
                    "rerun_bitwise": True, "kill_at": KILL_AT,
                    "resume_bitwise": True, "launches": churn_launches},
          "poll_generation": reg.generation(-1)})
    return launches, churn_launches


# -------------------------------------------------------------- phase 10
# LLM training (launch/lm_steps.py's train entry): qwen3-14b at full width,
# bf16, n_layers 40 -> 4 (2.877e9 params; 8 layers would need ~67 GB of
# weights, grads, fp32 accumulator and Adam moments), train_4k's global
# batch 256 x 4096 cut to 8 x 4096 (make_lm_batch), its MICROBATCHES (4),
# Adam, fp32 accumulator, beta 1, a constant lr; one warm step, then
# TRAIN_STEPS timed steps on the same batch, then one profiled step.  Adam
# moves every weight by about lr on its first steps, whatever its gradient,
# and a d_model-wide product sums those moves coherently: at lr 3e-4 the
# outputs move by about 3e-4 x 5120 x E|x| ~ 1.2 x their size and the loss
# rose 12.30 -> 25.44 in 3 steps (PERF.md §6); 1e-5 moves them ~4 %
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-14b", 4, 8, 4096
TRAIN_STEPS, TRAIN_LR = 3, 1e-5
# (a2) bf16 against fp32: the same model at 1 layer, one microbatch of
# 2 x 4096, from the same (bf16) weights; the bf16 kernel tolerance
TRAIN_BF16_TOL = 2e-2
# (b) every family at .reduced(), fp32, 2 microbatches of 2 x 64, card
# against the CPU: loss rtol 1e-4, grads 1e-3 of each leaf's largest
# |value|; a bf16-accumulated leaf (deepseek's) is held at the bf16 bound
# as well (one bf16 ulp is 3.9e-3 of a value), its 1e-3 reading reported
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 64
# (c) local SGD: qwen1.5-0.5b whole (24 layers, 4.64e8 params), bf16, two
# pod replicas in one process, H = 4 inner steps, 2 rounds, 4 x 1024 a pod
SGD_ARCH, SGD_PODS, SGD_H, SGD_ROUNDS = "qwen1.5-0.5b", 2, 4, 2
SGD_BATCH, SGD_SEQ, SGD_LR = 4, 1024, 1e-4     # d_model 1024: ~8 %
TRAIN_DEVICE = "cuda"


def _leaf_ratios(got, ref):
    """Each leaf's max |got - ref| over its largest |ref| (leaf paths)."""
    import torch
    from repro_torch.models.layers import tree_leaves

    out = {}

    def paths(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from paths(v, f"{pre}{k}/")
        else:
            yield pre[:-1]
    for name, a, b in zip(paths(ref), tree_leaves(got), tree_leaves(ref)):
        a, b = a.float().cpu(), b.float().cpu()
        require(bool(torch.isfinite(a).all()), f"{name}: non-finite gradient")
        out[name] = float((a - b).abs().max()
                          / b.abs().max().clamp_min(1e-30))
    return out


def _free_cuda():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _train_main_path(seed):
    """(a): the main path, timed and profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_steps, roofline
    from repro_torch.launch.mesh import PEAK_FLOPS
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    params = tf.init_model(torch.Generator(TRAIN_DEVICE).manual_seed(seed), cfg,
                           dtype=lm_steps.PARAM_DTYPE)
    # the tensors' elements; num_params() (6·N·D's N) leaves out the norms
    n_params = sum(t.numel() for t in _leaves(params))
    optimizer, step = lm_steps.build_train_step(cfg)
    opt_state = optimizer.init(params)
    batch = lm_steps.train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, TRAIN_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    ops.reset_launch_counts()
    losses, ms = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        params, opt_state, m = step(params, opt_state, batch, TRAIN_LR)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        losses.append(float(m["loss"]))
    flash = ops.launch_counts()["flash_attention"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(flash == 0, f"training launched flash_attention {flash} times")
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    require(all(b < a for a, b in zip(losses, losses[1:])),
            f"{cfg.name}: the loss does not fall over the steps: {losses}")
    prof = _device_profile(
        lambda: step(params, opt_state, batch, TRAIN_LR), 1)
    step_s = statistics.median(ms[1:]) / 1e3
    flops = roofline.model_flops(cfg, InputShape(
        "train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train"))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "num_params": cfg.num_params(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": lm_steps.MICROBATCHES[TRAIN_ARCH],
           "optimizer": "adam", "accum": "float32", "lr": TRAIN_LR,
           "losses": losses, "step_ms": ms,
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "model_flops_per_step": flops, "peak_flops": PEAK_FLOPS,
           "peak_share": roofline.peak_share(flops, step_s),
           "state_gib": state_gib, "peak_gib": peak_gib,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash_launches": flash, "profile": prof}
    del params, opt_state, batch, step, optimizer
    _free_cuda()
    return out


def _train_bf16_vs_fp32(seed):
    """(a2): one microbatch's loss and grads in bf16 against fp32, from the
    same weights, at full width and one layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=1)
    p16 = tf.init_model(torch.Generator(TRAIN_DEVICE).manual_seed(seed + 1), cfg,
                        dtype=torch.bfloat16)
    batch = lm_steps.train_batch(cfg, TRAIN_BATCH // lm_steps.MICROBATCHES[
        TRAIN_ARCH], TRAIN_SEQ, seed + 1, TRAIN_DEVICE)
    l16, _, g16 = tf.value_and_grad(p16, batch, cfg, dtype=torch.bfloat16)
    p32 = tree_map(lambda t: t.float(), p16)
    del p16
    l32, _, g32 = tf.value_and_grad(p32, batch, cfg, dtype=torch.float32)
    del p32
    ratios = _leaf_ratios(g16, g32)
    del g16, g32
    _free_cuda()
    loss_rel = abs(float(l16) - float(l32)) / abs(float(l32))
    worst = max(ratios, key=ratios.get)
    require(loss_rel <= TRAIN_BF16_TOL,
            f"bf16 loss {float(l16)} against fp32 {float(l32)}")
    require(ratios[worst] <= TRAIN_BF16_TOL,
            f"bf16 grads of {worst}: {ratios[worst]:.4g} of the leaf's "
            f"largest |value| from fp32, over {TRAIN_BF16_TOL}")
    return {"n_layers": 1, "batch": int(batch["tokens"].shape[0]),
            "seq": TRAIN_SEQ, "loss_bf16": float(l16),
            "loss_fp32": float(l32), "loss_rel": loss_rel,
            "tol": TRAIN_BF16_TOL, "worst_leaf": worst,
            "worst_ratio": ratios[worst], "ratios": ratios}


def _train_families(seed):
    """(b): every family's train step at .reduced() in fp32, the card
    against the CPU from the same params and batch."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map

    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 on in phase 10")
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        bf16_acc = arch in lm_steps.ADAFACTOR_ARCHS
        accum = torch.bfloat16 if bf16_acc else torch.float32
        base = tf.init_model(torch.Generator().manual_seed(seed), cfg,
                             dtype=torch.float32)
        runs = {}
        for dev in ("cpu", TRAIN_DEVICE):
            # a copy on either device: the step updates its params in place
            params = tree_map(lambda t: t.to(dev, copy=True), base)
            batch = lm_steps.train_batch(cfg, FAMILY_TRAIN_BATCH,
                                         FAMILY_TRAIN_SEQ, seed, dev)
            # the step's gradient half, then the whole step (the arch's
            # optimizer, the update in place)
            loss, _, grads = tf.accumulate_grads(
                params, batch, cfg, microbatches=2, accum_dtype=accum,
                dtype=torch.float32)
            opt, step = lm_steps.build_train_step(cfg, microbatches=2,
                                                  dtype=torch.float32)
            step(params, opt.init(params), batch, 1e-3)
            require(all(bool(torch.isfinite(t).all())
                        for t in _leaves(params)),
                    f"{arch} on {dev}: non-finite params after the step")
            runs[dev] = (float(loss), grads)
        (lc, gc), (lg, gg) = runs["cpu"], runs[TRAIN_DEVICE]
        ratios = _leaf_ratios(gg, gc)
        worst = max(ratios, key=ratios.get)
        tol = TRAIN_BF16_TOL if bf16_acc else 1e-3
        require(abs(lg - lc) <= 1e-4 * abs(lc),
                f"{arch}: card loss {lg} against the CPU's {lc}")
        require(ratios[worst] <= tol,
                f"{arch}: grads of {worst} {ratios[worst]:.4g} of the "
                f"leaf's largest |value| from the CPU's, over {tol}")
        out[arch] = {"loss_card": lg, "loss_cpu": lc,
                     "loss_rel": abs(lg - lc) / abs(lc),
                     "worst_leaf": worst, "worst_ratio": ratios[worst],
                     "tol": tol, "within_1e-3": ratios[worst] <= 1e-3,
                     "optimizer": ("adafactor" if bf16_acc else "adam"),
                     "accum": "bfloat16" if bf16_acc else "float32",
                     "mtp": cfg.mtp}
    return out


def _train_local_sgd(seed):
    """(c): local SGD on qwen1.5-0.5b, two pods in one process."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import local_sgd
    from repro_torch.launch import lm_steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_leaves, tree_map

    cfg = get_config(SGD_ARCH)
    params = tf.init_model(torch.Generator(TRAIN_DEVICE).manual_seed(seed + 2),
                           cfg, dtype=lm_steps.PARAM_DTYPE)
    n_params = sum(t.numel() for t in _leaves(params))
    optimizer, step = lm_steps.build_train_step(cfg)
    params_p = lm_steps.stack_pods(params, SGD_PODS)
    opt_p = lm_steps.stack_pods(optimizer.init(params), SGD_PODS)
    del params
    fed = local_sgd.LocalSGDConfig(outer_lr=1.0, outer_momentum=0.0)
    rounds = []
    for r in range(SGD_ROUNDS):
        per = [[lm_steps.train_batch(
            cfg, SGD_BATCH, SGD_SEQ,
            seed + 100 + (r * SGD_PODS + i) * SGD_H + h, TRAIN_DEVICE)
            for h in range(SGD_H)] for i in range(SGD_PODS)]
        batches = {k: torch.stack([torch.stack([b[k] for b in pod])
                                   for pod in per]) for k in per[0][0]}
        anchor = tree_map(lambda t: t[0].clone(), params_p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = lm_steps.pod_steps(step, params_p, opt_p, batches, SGD_LR)
        torch.cuda.synchronize()
        inner_s = time.perf_counter() - t0
        # outer_step at outer_lr 1, momentum 0 against the pods' mean, in
        # the params' bf16 and on their values in fp32: mathematically
        # equal, in floating point anchor - mean(anchor - w_i) rounds at
        # the operands' scale, so each element is held within 4 machine
        # epsilons of max(|anchor|, |w_i|), and the elements that differ
        # are counted
        checks = {}
        for name, dt in (("bfloat16", None), ("float32", torch.float32)):
            cast = (lambda t: t) if dt is None else (lambda t: t.to(dt))
            pods = tree_map(cast, params_p)
            a = tree_map(cast, anchor)
            state = local_sgd.OuterState(a, tree_map(torch.zeros_like, a))
            new, _ = local_sgd.outer_step(pods, state, fed)
            mean = local_sgd.fedavg_outer(pods)
            eps = torch.finfo(next(iter(_leaves(a))).dtype).eps
            differ, worst = 0, 0.0
            for x, y, an, w in zip(tree_leaves(new), tree_leaves(mean),
                                   tree_leaves(a), tree_leaves(pods)):
                scale = torch.maximum(an.float().abs(),
                                      w.float().abs().amax(0))
                gap = (x.float() - y.float()).abs()
                differ += int((gap > 0).sum())
                worst = max(worst, float((gap / (eps * scale).clamp_min(
                    torch.finfo(torch.float32).tiny)).max()))
            checks[name] = {"elements_differing": differ,
                            "elements": n_params,
                            "max_gap_in_eps_of_scale": worst}
            require(worst <= 4, f"outer_step(lr 1, momentum 0) {worst:.3g} "
                    f"epsilons from the pods' mean in {name}")
            del pods, a, state, new, mean
        mean = local_sgd.fedavg_outer(params_p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        drift = float(lm_steps.sync_pods(params_p))
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t1
        require(all(torch.equal(t[i], t[0]) for t in tree_leaves(params_p)
                    for i in range(1, SGD_PODS)),
                "the pod replicas differ after the sync")
        require(all(torch.equal(t[0], m) for t, m in
                    zip(tree_leaves(params_p), tree_leaves(mean))),
                "the synced replicas are not the pods' mean")
        lv = losses.float().cpu()
        require(bool(torch.isfinite(lv).all()), f"non-finite losses {lv}")
        rounds.append({"pod_losses": lv.tolist(), "drift": drift,
                       "inner_s": inner_s, "sync_s": sync_s,
                       "round_s": inner_s + sync_s,
                       "outer_step_vs_mean": checks})
        del anchor, mean, per
    first, last = rounds[0]["pod_losses"], rounds[-1]["pod_losses"]
    require(sum(p[-1] for p in last) < sum(p[0] for p in first),
            "local SGD's loss did not fall")
    # where an inner step's time goes: one more step of pod 0, profiled
    p0, o0 = (tree_map(lambda t: t[0], tree) for tree in (params_p, opt_p))
    prof = _device_profile(lambda: step(
        p0, o0, {k: v[0, 0] for k, v in batches.items()}, SGD_LR), 1)
    del params_p, opt_p, p0, o0, batches
    _free_cuda()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
            "pods": SGD_PODS, "inner_steps": SGD_H, "rounds_run": SGD_ROUNDS,
            "batch_per_pod": SGD_BATCH, "seq": SGD_SEQ, "lr": SGD_LR,
            "rounds": rounds, "step_profile": prof}


def lm_train_slice(seed):
    """LLM training on the card (phase 10).  The main path: qwen3-14b at
    full width through ``lm_steps.build_train_step`` (Adam, 4 microbatches
    into an fp32 accumulator, remat, the plain attention route, the update
    in place), no flash launch; then (a2) bf16 against fp32, (b) every
    family's step against the CPU, (c) local SGD.  Prints one JSON line a
    part; returns the flash launches of the main path (0)."""
    main_path = _train_main_path(seed)
    emit({"phase": "lm_train", "part": "main", **main_path})
    emit({"phase": "lm_train", "part": "bf16_vs_fp32",
          **_train_bf16_vs_fp32(seed)})
    emit({"phase": "lm_train", "part": "families",
          "archs": _train_families(seed)})
    emit({"phase": "lm_train", "part": "local_sgd", **_train_local_sgd(seed)})
    return main_path["flash_launches"], main_path["peak_bytes"]


def _device_profile(run, steps):
    """torch.profiler around ``run()`` (which does ``steps`` steps and ends
    in a synchronize): the device's own activity (kernels, copies, fills;
    not the host ops that launched them) against the window's host wall
    (the busy share), its count per step, and what takes the most device
    time.  Device times are None where the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": steps, "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_ms_per_step": (device_us / 1e3 / steps
                                   if device_us else None),
            "device_busy_share": device_us / wall_us if device_us else None,
            "device_activities_per_step": launches / steps,
            "top": [{"name": e.key[:80], "calls_per_step": e.count / steps,
                     "ms_per_step": e.self_device_time_total / 1e3 / steps}
                    for e in top]}


def profile_prefill(params, prompt, cfg, capacity):
    """torch.profiler over one warm prefill: where its device time goes."""
    from repro_torch.launch import lm_steps

    return _device_profile(
        lambda: lm_steps.prefill_step(params, {"tokens": prompt}, cfg,
                                      capacity=capacity), 1)


def profile_decode(params, prompt, cfg, feed, steps=8):
    """torch.profiler over ``steps`` warm decode steps after a prefill."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import lm_steps

    S = prompt.shape[1]
    shape = InputShape("lm", S + steps, prompt.shape[0], "prefill")
    _, caches = lm_steps.prefill_step(params, {"tokens": prompt}, cfg,
                                      capacity=lm_steps.cache_capacity(cfg,
                                                                       shape))
    lm_steps.decode_step(params, caches, feed[:, :1], S, cfg)
    torch.cuda.synchronize()

    def run():
        for t in range(1, steps + 1):
            lm_steps.decode_step(params, caches, feed[:, t:t + 1], S + t, cfg)

    return _device_profile(run, steps)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -------------------------------------------------------------- phase 11
# examples/torch_quickstart.py at its own settings (12 buildings x 60 days,
# 20 rounds, LSTM H=32); the e2e example at the verify recipe's small
# settings, as it is and under semi-sync with the privacy stack; the
# serving demo at its defaults
E2E_ARGS = ["--clients", "8", "--rounds", "6", "--heldout", "6",
            "--days", "40"]
E2E_PRIVATE = ["--mode", "semi_sync", "--dp-clip", "1", "--dp-noise", "0.5",
               "--quantize", "8", "--secure-agg"]
EXAMPLE_RUNS = [("quickstart", "torch_quickstart", []),
                ("e2e", "torch_fl_forecasting_e2e", E2E_ARGS),
                ("e2e_semi_sync_private", "torch_fl_forecasting_e2e",
                 E2E_ARGS + E2E_PRIVATE),
                ("serve", "torch_serve_forecaster", [])]


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_slice(seed):
    """Phase 11: each ``examples/torch_*.py`` through its ``main(argv)`` on
    the card, the launch counts set to 0 just before it and read just
    after: every local step's forward and every evaluation batch is one
    launch of the LSTM layer kernel a layer.  Losses and metrics must be
    finite (the last finite loss of each cluster where cohort-atomic
    pacing records nan for a flush that completes no cohort).  Prints
    each one's wall and held-out accuracy (the quickstart's: its unseen
    building's test windows; the serving demo forecasts past the end of
    its data, so it has none).  Returns each one's launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ForecasterConfig
    from repro_torch.core import fedavg
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    launches, report = {}, {}
    for name, module, argv in EXAMPLE_RUNS:
        mod = _example(module)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches[name] = counts["lstm_cell"]
        require(counts["gru_cell"] == 0 and counts["flash_attention"] == 0,
                f"{name}: launch counts {counts}")
        if name == "quickstart":
            require(bool(np.isfinite(res["loss_history"]).all())
                    and bool(np.isfinite(res["forecast_kwh"]).all()),
                    f"{name}: non-finite loss or forecast")
            unseen = synthetic.generate_buildings("CA", [99_999], days=60)
            acc = fedavg.evaluate_unseen_clients(
                res["params"], unseen, ForecasterConfig(cell="lstm",
                                                        hidden_dim=32),
                device="cuda")
            losses = [float(res["loss_history"][-1])]
        elif name.startswith("e2e"):
            results = list(res["clustered"].values()) + [res["global"]]
            losses = [fedavg.final_loss(r) for r in results]
            if name == "e2e":
                require(all(bool(np.isfinite(r.loss_history).all())
                            for r in results), f"{name}: non-finite loss")
            acc = res["global_eval"]
            for m in (acc, *res["unseen"].values()):
                require(all(math.isfinite(m[k]) for k in ("accuracy",
                                                          "rmse")),
                        f"{name}: non-finite metric {m}")
        else:
            served = np.stack([t.result for t in res])
            require(len(res) == 256 and bool(np.isfinite(served).all()),
                    f"{name}: {len(res)} tickets or non-finite forecasts")
            acc, losses = None, []
        require(all(map(math.isfinite, losses)), f"{name}: loss {losses}")
        report[name] = {"argv": argv, "wall_s": wall,
                        "lstm_cell_launches": counts["lstm_cell"],
                        "final_losses": losses,
                        "held_out_accuracy": (None if acc is None
                                              else acc["accuracy"]),
                        "held_out_mape": (None if acc is None
                                          else acc["mape"])}
        del res
        _free_cuda()
    emit({"phase": "examples", "runs": report})
    return launches


# -------------------------------------------------------------- phase 12
# 12a: steps that one card runs, predicted by the dry run on a 1 x 1 mesh
# and measured: phase 10a's train step, and phase 5's prefill on the plain
# attention route (the dry run's route: a kernel takes device pointers,
# which fake tensors have not).  The prediction must land within
# DRYRUN_MEM_TOL of the measured peak (PERF.md says why this bound)
DRYRUN_MEM_TOL = 0.05
DRYRUN_DIR = ROOT / "build" / "dryrun_smoke"
# 12b: the production mesh, 16 x 16 for qwen3-14b at every shape, and
# deepseek-v3-671b's train_4k (the reference's Adafactor case) on
# 2 x 16 x 16, its depth cut 61 -> 5 (its 3 dense layers and 2 MoE): at
# full depth its 16 microbatches take the eager dry run past the script's
# time (the full grid runs through the CLI, PERF.md); at 8 microbatches,
# so that a microbatch's 32 sequences fill the 32-way ("pod", "data")
# batch split (at 16, DTensor's view of the flattened tokens goes wrong:
# ROADMAP queue C); every run a process of its own, read within the limit
PRODUCTION_RUNS = [("qwen3-14b", shape, []) for shape in
                   ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("deepseek-v3-671b", "train_4k",
        ["--multi-pod", "--layers", "5", "--microbatches", "8"])]
PRODUCTION_LIMIT_S = 780


def _dryrun_cmd(arch, shape, extra, out):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--out", str(out), *extra]


def _dryrun_env():
    import os
    return dict(os.environ, PYTHONPATH=str(SRC))


def _record(out, arch, shape, stdout):
    """The record a dry run wrote (its line names the mesh)."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[dryrun]")]
    require(lines and ": OK" in lines[-1],
            f"dry run {arch} x {shape}: {stdout[-2000:]}")
    mesh = lines[-1].split(" × ")[2].split(":")[0]
    path = max(Path(out).glob(f"{arch}__{shape}__{mesh}*.json"),
               key=lambda p: p.stat().st_mtime)
    return json.loads(path.read_text())


def _predicted(rec):
    m = rec["memory"]
    return m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]


def dryrun_vs_card(seed, train_peak):
    """Phase 12a."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_steps, roofline
    from repro_torch.models import transformer as tf

    out = DRYRUN_DIR / "one_card"
    runs = {"train": ("train_4k", ["--layers", str(TRAIN_LAYERS), "--batch",
                                   str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                                   "--microbatches", str(
                                       lm_steps.MICROBATCHES[TRAIN_ARCH])]),
            "prefill": ("prefill_32k", ["--layers", str(LM_LAYERS),
                                        "--batch", str(LM_BATCH),
                                        "--seq", str(LM_PROMPT)])}
    recs, walls = {}, {}
    for part, (shape, extra) in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run(_dryrun_cmd(TRAIN_ARCH, shape,
                                          ["--mesh", "1x1", *extra], out),
                              env=_dryrun_env(), capture_output=True,
                              text=True, timeout=900)
        walls[part] = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"dry run {part}: {proc.stdout[-1500:]}{proc.stderr[-1500:]}")
        recs[part] = _record(out, TRAIN_ARCH, shape, proc.stdout)

    # the prefill measured: phase 5's weights and prompt, the plain route,
    # the cache at the dry run's capacity (the prompt)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    gen = torch.Generator("cuda").manual_seed(seed + 4)
    params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        last, caches = lm_steps.prefill_step(params, {"tokens": prompt}, cfg,
                                             capacity=LM_PROMPT,
                                             attn_impl="torch")
        torch.cuda.synchronize()
    prefill_peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(last).all()), "plain prefill not finite")
    del params, last, caches, prompt
    _free_cuda()

    report = {}
    for part, measured in (("train", train_peak), ("prefill", prefill_peak)):
        rec = recs[part]
        pred = _predicted(rec)
        rel = pred / measured - 1.0
        report[part] = {
            "memory": rec["memory"], "predicted_bytes": pred,
            "measured_max_memory_allocated": measured,
            "predicted_gib": pred / 2 ** 30,
            "measured_gib": measured / 2 ** 30,
            "rel_diff": rel,
            "useful_ratio": roofline.terms(rec)["useful_ratio"],
            "flops_global": rec["flops_global"],
            "bytes_global": rec["bytes_global"],
            "dryrun_wall_s": walls[part],
            "dryrun_s": {k: rec[k] for k in ("build_s", "global_s",
                                             "sharded_s")}}
        require(abs(rel) <= DRYRUN_MEM_TOL,
                f"12a {part}: the dry run predicts {pred} bytes, the card "
                f"measured {measured} ({rel:+.2%}, bound "
                f"{DRYRUN_MEM_TOL:.0%})")
    emit({"phase": "dryrun_vs_card", "tolerance": DRYRUN_MEM_TOL, **report})


def start_production_dryruns():
    """Phase 12b, started: every run of PRODUCTION_RUNS in a process of
    its own (a fake process group of 256 or 512 ranks each)."""
    out = DRYRUN_DIR / "production"
    return [(arch, shape, extra, time.monotonic(), subprocess.Popen(
        _dryrun_cmd(arch, shape, extra, out), env=_dryrun_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for arch, shape, extra in PRODUCTION_RUNS], out


def finish_production_dryruns(started):
    """Phase 12b, read: each run's per-device GiB, global FLOPs and
    collective MiB a device, as the reference's line prints them, and how
    long it took.  A run not done within PRODUCTION_LIMIT_S of its start
    is stopped and fails the phase."""
    from repro_torch.launch import roofline
    procs, out = started
    runs = {}
    try:
        for arch, shape, extra, t0, proc in procs:
            left = PRODUCTION_LIMIT_S - (time.monotonic() - t0)
            try:
                stdout, _ = proc.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"12b {arch} x {shape} not done in "
                                   f"{PRODUCTION_LIMIT_S} s")
            require(proc.returncode == 0,
                    f"12b {arch} x {shape}: {stdout[-2000:]}")
            rec = _record(out, arch, shape, stdout)
            t = roofline.terms(rec)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("[dryrun]")][-1]
            print(line, flush=True)
            runs[f"{arch}__{shape}__{rec['mesh']}"] = {
                "line": line,
                "gib_per_device": t["hbm_gib_per_dev"],
                "flops_global": rec["flops_global"],
                "collective_mib_per_device": sum(
                    rec["collective_bytes_per_device"].values()) / 2 ** 20,
                "collective_bytes_per_device":
                    rec["collective_bytes_per_device"],
                "memory": rec["memory"], "terms": t,
                "seconds": {k: rec[k] for k in ("build_s", "global_s",
                                                "sharded_s")},
                "wall_s": time.monotonic() - t0}
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": "dryrun_production", "runs": runs})


def sharded_prefill(seed, want_logits):
    """Phase 12c: phase 5's prefill (qwen3-14b, LM_LAYERS layers, the
    same weights and prompt) with DTensor params on one NCCL rank's 1 x 1
    ("data", "model") mesh under ``make_rules``: attention runs on each
    rank's local heads through the flash kernel, one launch a layer.  The
    same kernels run in the same order as phase 5's, so the last
    position's logits must equal phase 5's bit for bit.  Returns the flash
    launches."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, lm_steps
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map
    from repro_torch.sharding import placements, use_rules
    from repro_torch.sharding.rules import P, spec_of

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    gen = torch.Generator("cuda").manual_seed(seed + 4)
    params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    cap = lm_steps.cache_capacity(cfg, InputShape(
        "lm", LM_PROMPT + LM_NEW, LM_BATCH, "prefill"))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = mesh_mod.make_rules(mesh)

        def lay_out(tree, specs):
            return tree_map(lambda t, sp: DTensor.from_local(
                t, mesh, placements(sp, mesh), run_check=False), tree, specs)
        dparams = lay_out(params, rules.pspec_tree(params))
        caches = tf.init_cache(cfg, LM_BATCH, cap, device="cuda")
        dcaches = lay_out(caches, dryrun.cache_pspec_tree(caches, mesh,
                                                           rules))
        batch = {"tokens": DTensor.from_local(
            prompt, mesh, placements(P(("data",), None), mesh),
            run_check=False)}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), use_rules(rules), implicit_replication():
            logits, _, _ = tf.forward(dparams, batch, cfg,
                                      dtype=torch.bfloat16, caches=dcaches,
                                      remat=False, attn_impl="kernel")
            last = lm_steps.last_logits(logits, cfg)
            layout = spec_of(last)
            got = last.full_tensor()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    require(counts == {"lstm_cell": 0, "gru_cell": 0,
                       "flash_attention": cfg.n_layers},
            f"12c launch counts {counts}, expected {cfg.n_layers} flash "
            "launches (one a layer)")
    diff = float((got.float() - want_logits.float()).abs().max())
    require(got.shape == want_logits.shape and bool(torch.isfinite(got).all())
            and torch.equal(got, want_logits),
            f"12c logits differ from phase 5's: max abs {diff:.4g}")
    emit({"phase": "sharded_prefill", "mesh": "1x1 (nccl)", "arch": cfg.name,
          "n_layers": cfg.n_layers, "batch": LM_BATCH,
          "prompt_len": LM_PROMPT, "launches": counts,
          "logits_layout": repr(layout), "equal_to_phase5": True,
          "max_abs_diff": diff, "wall_ms": wall * 1e3})
    del params, dparams, caches, dcaches, logits, last, got
    _free_cuda()
    return counts["flash_attention"]


# -------------------------------------------------------------- phase 13
# flcheck on the card (src/repro_torch/analysis/, tools/flcheck_torch):
# (a) the AST lint of the port's tree; (b) the round's hot-path guards at
# train-lstm's shape (ForecasterConfig(), M = 100 clients, B = 64, the
# kernel route; the local steps of a round cut 411 -> FLCHECK_STEPS), 3
# rounds after a warm-up, under the reference's guard stack (clip, noise,
# 4-bit quantize) and under train-lstm-dp's (clip 1.0, noise 0.5, the 8-bit
# ring, secure aggregation); (c) the taint proofs of the local round and of
# the semi-sync dispatch under the full stack at M = 100 on the kernel
# route; (d) the cost audit against the committed baseline (its mesh paths
# on 8 gloo ranks that the CLI spawns on the card), on this machine's
# torch.  (a) and (d) run as processes of their own while (b) and (c) run
# here.
FLCHECK_M, FLCHECK_B, FLCHECK_STEPS, FLCHECK_ROUNDS = 100, 64, 8, 3
FLCHECK_LIMIT_S = 600
BASELINE = "src/repro_torch/analysis/baselines/round_costs.json"


def _flcheck(*args):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "flcheck_torch"), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc, t0, label):
    try:
        out, _ = proc.communicate(timeout=max(
            FLCHECK_LIMIT_S - (time.monotonic() - t0), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0,
            f"13 {label}: exit {proc.returncode}\n{out[-4000:]}")
    return out, time.monotonic() - t0


def flcheck_slice(seed):
    """Phase 13: flcheck on the card; one JSON line with each part's
    result and wall.  The launch counts are set to 0 just before (b) and
    (c), the main path of this phase, and read just after: the guarded
    rounds and the traced rounds launch the LSTM layer kernel.  Returns
    those launches."""
    import re

    import torch
    from repro_torch.analysis import recompile, taint
    from repro_torch.configs.base import ForecasterConfig, TransformConfig
    from repro_torch.kernels import ops

    t0 = time.monotonic()
    lint = _flcheck(str(SRC / "repro_torch"))
    cost = _flcheck("--no-lint", "--cost", "--baseline", BASELINE)
    fcfg = ForecasterConfig()
    out = {"shape": {"M": FLCHECK_M, "B": FLCHECK_B,
                     "local_steps": FLCHECK_STEPS, "cfg": "ForecasterConfig()",
                     "cell_impl": "kernel"}}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    # (b) the hot-path guards
    guards = {}
    for name, tcfg, scfg in (
            ("clip_noise_q4", None, None),
            ("dp_ring8_secure", taint.full_stack(), taint.secure())):
        t1 = time.monotonic()
        rep, err, launched = recompile.check_round_hot_path(
            steps=FLCHECK_ROUNDS, device="cuda", fcfg=fcfg, m=FLCHECK_M,
            batch=FLCHECK_B, local_steps=FLCHECK_STEPS, n_win=256,
            tcfg=tcfg, scfg=scfg)
        require(rep.ok, f"13b {name}: {rep.render()}")
        require(err is None, f"13b {name}: host read or sync: {err}")
        require(launched > 0, f"13b {name}: no lstm_cell launch inside the "
                "guarded round")
        guards[name] = {"new_per_round": rep.new_entries_per_step,
                        "by_kind": rep.by_kind, "host_reads": 0,
                        "sync_debug_mode": "error",
                        "launches_in_guard": launched,
                        "wall_s": time.monotonic() - t1}
    out["hot_path"] = guards
    # (c) the taint proofs on the card
    proofs = {}
    for topo in ("vmap", "semi_sync"):
        t1 = time.monotonic()
        rep = taint.verify_pipeline(topo, taint.full_stack(), taint.secure(),
                                    fcfg=fcfg, device="cuda", m=FLCHECK_M)
        require(rep.proved and not rep.violations,
                f"13c {topo}: {rep.render()}")
        require(rep.launches_before_source > 0
                and rep.launches_after_source == 0,
                f"13c {topo}: launches before / after the source "
                f"{rep.launches_before_source} / "
                f"{rep.launches_after_source}")
        proofs[topo] = {"required": sorted(rep.required),
                        "sources": rep.sources, "checked": rep.checked,
                        "violations": len(rep.violations),
                        "launches_before_source":
                            rep.launches_before_source,
                        "launches_after_source": rep.launches_after_source,
                        "wall_s": time.monotonic() - t1}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts["lstm_cell"] > 0 and counts["gru_cell"] == 0
            and counts["flash_attention"] == 0,
            f"13 launch counts {counts}")
    out["taint"] = proofs
    # (a) and (d), read
    text, wall = _finish(lint, t0, "lint")
    found = re.search(r"flcheck lint: (\d+) files, (\d+) findings, "
                      r"(\d+) suppressed", text)
    require(found is not None and found.group(2) == "0",
            f"13a lint: {text[-2000:]}")
    out["lint"] = {"files": int(found.group(1)),
                   "findings": int(found.group(2)),
                   "suppressed": int(found.group(3)), "wall_s": wall}
    text, wall = _finish(cost, t0, "cost")
    drift = [ln for ln in text.splitlines()
             if "DRIFT" in ln or "FATAL" in ln or " note: " in ln]
    require(not drift and "report matches baseline" in text,
            "13d cost: " + "\n".join(drift or text.splitlines()[-20:]))
    out["cost"] = {"baseline": BASELINE, "diff": drift,
                   "audits": sum(" wire=" in ln for ln in text.splitlines()),
                   "torch": torch.__version__, "wall_s": wall}
    out["launches"] = counts
    out["wall_s"] = time.monotonic() - t0
    emit({"phase": "flcheck", **out})
    return counts["lstm_cell"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").exists():
        sys.exit(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
                 "checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's kernels need one")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import ForecasterConfig
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    require({shape[4] for shape in FLASH_SHAPES} == set(HEAD_DIMS),
            f"phase 2b's shapes miss a head dim of the kernel: {HEAD_DIMS}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 still on")

    # ---- phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    ops.build()
    build_s = time.perf_counter() - t0
    # ptxas -v of each kernel compiled in this run (none if the libraries
    # were already built): registers, stack, spills, static shared memory
    ptxas = {n: _cuda.ptxas_report(log) for n, log in _cuda.BUILD_LOG.items()}
    # the launch plans of the serving path's layers (B=256, H=64, fp32)
    # and of a local step's forward (M=100 clients x B=64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {f"{n}_I{I}": _cuda.cell_plan(n, 256, I, 64, 4, sms)._asdict()
             for n, I in (("lstm_cell", 1), ("gru_cell", 1),
                          ("gru_cell", 64))}
    train_plans = {f"{n}_I{I}": _cuda.cell_plan(n, 64, I, 64, 4, sms,
                                                M=100)._asdict()
                   for n, I in (("lstm_cell", 1), ("gru_cell", 1),
                                ("gru_cell", 64))}
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": sms,
          "kernel_build_s": build_s, "serving_plans": plans,
          "training_plans": train_plans, "ptxas": ptxas})

    # ---- phase 2: each kernel against its plain version on the card, the
    # cells also with the client axis and through their autograd Function
    errs = check_kernels(args.seed)
    errs["flash_attention"] = check_flash(args.seed)
    train_errs = check_client_axis(args.seed)

    # ---- phase 3: the serving slice, LSTM then 2-layer GRU: one launch of
    # the layer kernel per layer per flush
    launches, wall, int8_launches = {}, {}, {}
    for cfg in (ForecasterConfig(), ForecasterConfig(cell="gru", n_layers=2)):
        name = f"{cfg.cell}_cell"
        served = serve_slice(cfg, args.seed, launches_per_flush=cfg.n_layers,
                             int8=cfg.cell == "lstm")
        launches[name] = served["launches"]
        int8_launches[name] = served.get("int8_launches", 0)
        wall[name] = served["full_flush_wall_s"]
        require(launches[name] > 0, f"{name} never launched on its path")

    # ---- phase 4: times at the serving shape, flash at the LM shape, the
    # cells at the training shape
    times = time_kernels(args.seed)
    times["flash_attention"] = time_flash(args.seed)
    flash_by_hd = {label: time_flash(args.seed, shape, label)
                   for label, shape in FLASH_FAMILY_SHAPES.items()}
    train_times = time_training_layer(args.seed)

    # ---- phase 5: the dense-LM prefill and decode slice
    launches["flash_attention"], lm_logits = lm_slice(args.seed)
    require(launches["flash_attention"] > 0,
            "flash_attention never launched on its path")

    # ---- phase 5b: the LM families at full width, cut depth
    family_launches = lm_families(args.seed)
    require(sum(family_launches.values()) > 0,
            "flash_attention never launched on the families' paths")

    # ---- phase 6: federated training, LSTM at ForecasterConfig() then the
    # 2-layer GRU: one launch per layer per local step for all clients
    train_launches, phase6 = train_slice(args.seed)
    for n, k in train_launches.items():
        require(k > 0, f"{n} never launched on the training path")

    # ---- phase 7: phase 6's LSTM training under clip, DP noise, the 8-bit
    # ring quantizer and secure aggregation
    dp_launches = train_dp_slice(args.seed, phase6)
    require(dp_launches > 0, "lstm_cell never launched on the DP path")

    # ---- phase 8: the rank-sharded round, one NCCL rank and four gloo
    # ranks on the card, flat and hierarchical
    nccl_launches, gloo_launches = mesh_slice(args.seed)
    require(nccl_launches > 0 and gloo_launches > 0,
            "lstm_cell never launched on the mesh paths")

    # ---- phase 9: semi-synchronous rounds, churn and re-keying, resume
    semi_launches, churn_launches = pacing_slice(args.seed)
    require(semi_launches > 0 and churn_launches > 0,
            "lstm_cell never launched on the semi-sync paths")
    lstm_more = {"mesh_nccl_1": nccl_launches, "mesh_gloo_4": gloo_launches,
                 "semi_sync": semi_launches,
                 "semi_sync_churn": churn_launches}

    # ---- phase 10: LLM training (no kernel: the plain attention route, as
    # the reference trains)
    train_flash, train_peak = lm_train_slice(args.seed)

    # ---- phase 12b starts first: the production-mesh dry runs are host
    # work only, in processes of their own, read after phase 12c
    production = start_production_dryruns()

    # ---- phase 11: the paper's examples, on the layer kernel
    example_launches = examples_slice(args.seed)
    for n, k in example_launches.items():
        require(k > 0, f"lstm_cell never launched by {n}")

    # ---- phase 12a: the dry run's memory model against the card
    dryrun_vs_card(args.seed, train_peak)

    # ---- phase 12c: a sharded prefill (DTensor params, one NCCL rank,
    # the production rules) through the flash kernel
    sharded_flash = sharded_prefill(args.seed, lm_logits)

    # ---- phase 12b: read the production-mesh dry runs
    finish_production_dryruns(production)

    # ---- phase 13: flcheck on the card (lint, hot-path guards, taint,
    # the cost audit against the committed baseline)
    lstm_more["flcheck"] = flcheck_slice(args.seed)

    replaces = {"lstm_cell": "src/repro/kernels/lstm_cell.py:24",
                "gru_cell": "src/repro/kernels/gru_cell.py:17",
                "flash_attention": "src/repro/kernels/flash_attention.py:28"}

    def extra(n):
        """The cells' line: the layer at T=8 (the GRU's first layer) at
        the serving shape, with the second GRU layer and the T = 1 step
        beside it; the launches of each path; the layer at the training
        shape (M=100 clients x B=64) with the client axis.  Flash's line:
        its launches by path (phase 5's prefill, each family's of phase
        5b) and its times at the families' head dims (phase 4b)."""
        if n == "flash_attention":
            return {"launches_by_path": {"lm_qwen3_14b": launches[n],
                                         "lm_families": family_launches,
                                         "lm_train": train_flash,
                                         "lm_sharded_prefill": sharded_flash},
                    "head_dims": list(HEAD_DIMS),
                    "by_shape": {label: {
                        "shape": dict(zip("B S Hq Hkv hd".split(), shp)),
                        **{k: flash_by_hd[label][k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "bound_share", "tflops")}}
                        for label, shp in FLASH_FAMILY_SHAPES.items()}}
        if n not in wall:
            return {}
        tt = train_times[n]
        more = {"launches_by_path": {"serve": launches[n],
                                     "serve_int8": int8_launches[n],
                                     "train": train_launches[n],
                                     "train_dp": (dp_launches
                                                  if n == "lstm_cell" else 0),
                                     **{k: (v if n == "lstm_cell" else 0)
                                        for k, v in lstm_more.items()},
                                     **{f"example_{k}":
                                        (v if n == "lstm_cell" else 0)
                                        for k, v in example_launches.items()}},
                "train_shape": {
                    "M": tt["M"], "B": tt["B"], "T": tt["T"], "I": tt["I"],
                    "H": tt["H"], "max_abs_err": train_errs[n],
                    **{k: tt[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "bound_share",
                                          "library_ms", "library")}},
                "shape": {"B": 256, "T": 8, "I": 1, "H": 64,
                          "dtype": "float32"},
                "library": f"torch.nn.{n[:-5].upper()} (cuDNN)",
                "engine_full_flush_wall_ms": wall[n] * 1e3,
                "step_ms": times[f"{n}_step"]["ms"],
                "step_library_ms": times[f"{n}_step"]["library_ms"]}
        if n == "gru_cell":
            more["second_layer"] = {k: times["gru_cell_i64"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_share")}
            more["train_shape"]["second_layer"] = {
                k: train_times["gru_cell_i64"][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_share")}
        return more

    emit({"kernels": [
        {"name": n, "route": "cuda", "source": f"src/repro_torch/csrc/{n}.cu",
         "replaces": replaces[n],
         "launches": (launches[n] + train_launches.get(n, 0)
                      + int8_launches.get(n, 0)
                      + (sum(family_launches.values()) + sharded_flash
                         if n == "flash_attention" else 0)
                      + (dp_launches + sum(lstm_more.values())
                         + sum(example_launches.values())
                         if n == "lstm_cell" else 0)),
         "max_abs_err": errs[n], "ms": times[n]["ms"],
         "plain_ms": times[n]["plain_ms"], "bound_ms": times[n]["bound_ms"],
         "bound_by": times[n]["bound_by"],
         "bound_share": times[n]["bound_share"],
         "library_ms": times[n]["library_ms"], **extra(n)}
        for n in ops.KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
