#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch/``).

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the
forecast-serving path end to end (registry -> router -> bucketed engine ->
fused recurrent layers, one launch per layer) at the paper forecaster's
full width for the LSTM and a 2-layer GRU, checks the results against the
same engine on the CPU, profiles one full flush, times the kernels at their
paths' shapes beside cuDNN's sequence calls, drives the dense-LM prefill
and decode steps at qwen3-14b's full width (8 of its 40 layers) through the
flash attention kernel (bf16: wgmma on the tensor cores fed by TMA; fp32:
the CUDA-core kernel), holds them against the plain attention route, then
trains the forecaster federatedly (the paper's Algorithm 1: 100 clients x
365 days, every local step's forward one launch of the layer kernel for
all clients, its backward the plain layer's VJP) on the kernel route
against the plain route, and ends with one JSON status line.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; without one (or outside a checkout of the repo) it
exits non-zero before printing any result.  Each phase prints one JSON
line; any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
# one across tiles; hd 16, 32, 64, 128; GQA 5:1 at hd 128
FLASH_SHAPES = [(2, 128, 4, 4, 32, 0), (2, 256, 8, 2, 64, 0),
                (1, 256, 4, 1, 64, 0), (1, 512, 2, 2, 32, 128),
                (3, 384, 6, 2, 16, 0), (2, 200, 4, 2, 64, 0),
                (1, 200, 4, 2, 128, 64), (2, 4096, 40, 8, 128, 0),
                (2, 4096, 40, 8, 128, 1024),
                (1, 1, 8, 2, 128, 0), (2, 64, 8, 2, 64, 0),
                (1, 127, 4, 2, 32, 0), (1, 129, 4, 1, 16, 0),
                (1, 4097, 8, 2, 128, 0), (1, 1000, 4, 2, 64, 48),
                (1, 3000, 4, 2, 128, 1024), (2, 300, 10, 2, 128, 0)]
FLASH_SLICE = (2, 4096, 40, 8, 128)


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
def serve_slice(cfg, seed, launches_per_flush=None):
    """Serve REQUESTS_PER_CONSUMER requests from each of CONSUMERS synthetic
    CA consumers on the card and on the CPU, then profile one more full
    (max_batch) flush on the card.  Returns the card run's launches of the
    config's cell, its flushes, the mean wall time of a full flush and the
    profile.  With ``launches_per_flush`` the run must have launched the
    config's cell exactly that many times a flush, and the other cell
    never."""
    import numpy as np
    import torch
    from repro_torch import serving as sv
    from repro_torch.core import clustering
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

    def run(device):
        reg = sv.ModelRegistry(device=device)
        for s in slots:
            reg.publish(params[s], cfg, slot=s, generation=1)
        eng = sv.ServingEngine(reg, sv.ClusterRouter(cents), max_batch=256,
                               min_bucket=8, device=device)
        eng.warmup()
        if device == "cuda":
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
    worst = 0.0
    for a, b in zip(tickets, cpu_tickets):
        scale = b.hi - b.lo
        err = np.abs(a.result - b.result)
        worst = max(worst, float((err / (1e-4 * np.abs(b.result)
                                         + 1e-4 * scale)).max()))
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
    return {"launches": counts[name], "flushes": flushes,
            "full_flush_wall_s": full_wall, "profile": profile}


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
def time_flash(seed):
    """Flash kernel, its plain version and scaled_dot_product_attention at
    the LM slice's prefill shape (B=2, S=4096, Hq=40, Hkv=8, hd=128, bf16,
    causal), beside the bound: the causal FLOPs of these inputs on the bf16
    tensor cores, or q, k, v read and o written once; with the achieved
    TFLOP/s of the kernel and of the library call, and the kernel's share
    of the bound (bound_ms / ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    B, S, Hq, Hkv, hd = FLASH_SLICE
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
    emit({"phase": "flash_timing",
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
        kern = lm_steps.generate(params, prompt, cfg, LM_NEW,
                                 attn_impl="kernel")
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        require(counts == {"lstm_cell": 0, "gru_cell": 0,
                           "flash_attention": cfg.n_layers},
                f"launch counts {counts} in one prefill + {LM_NEW} decode "
                f"steps, expected flash_attention = {cfg.n_layers} layers")
        plain = lm_steps.generate(params, prompt, cfg, LM_NEW,
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
        warm = lm_steps.generate(params, prompt, cfg, LM_NEW,
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
            lm_steps.prefill_step(params, prompt, cfg, capacity=capacity)
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
    del params, kern, plain, warm
    torch.cuda.empty_cache()
    return counts["flash_attention"]


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
    return {"lstm_cell": want_train, "gru_cell": gcounts["gru_cell"]}


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
        lambda: lm_steps.prefill_step(params, prompt, cfg, capacity=capacity),
        1)


def profile_decode(params, prompt, cfg, feed, steps=8):
    """torch.profiler over ``steps`` warm decode steps after a prefill."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import lm_steps

    S = prompt.shape[1]
    shape = InputShape("lm", S + steps, prompt.shape[0], "prefill")
    _, caches = lm_steps.prefill_step(params, prompt, cfg,
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
    launches, wall = {}, {}
    for cfg in (ForecasterConfig(), ForecasterConfig(cell="gru", n_layers=2)):
        name = f"{cfg.cell}_cell"
        served = serve_slice(cfg, args.seed, launches_per_flush=cfg.n_layers)
        launches[name] = served["launches"]
        wall[name] = served["full_flush_wall_s"]
        require(launches[name] > 0, f"{name} never launched on its path")

    # ---- phase 4: times at the serving shape, flash at the LM shape, the
    # cells at the training shape
    times = time_kernels(args.seed)
    times["flash_attention"] = time_flash(args.seed)
    train_times = time_training_layer(args.seed)

    # ---- phase 5: the dense-LM prefill and decode slice
    launches["flash_attention"] = lm_slice(args.seed)
    require(launches["flash_attention"] > 0,
            "flash_attention never launched on its path")

    # ---- phase 6: federated training, LSTM at ForecasterConfig() then the
    # 2-layer GRU: one launch per layer per local step for all clients
    train_launches = train_slice(args.seed)
    for n, k in train_launches.items():
        require(k > 0, f"{n} never launched on the training path")

    replaces = {"lstm_cell": "src/repro/kernels/lstm_cell.py:24",
                "gru_cell": "src/repro/kernels/gru_cell.py:17",
                "flash_attention": "src/repro/kernels/flash_attention.py:28"}

    def extra(n):
        """The cells' line: the layer at T=8 (the GRU's first layer) at
        the serving shape, with the second GRU layer and the T = 1 step
        beside it; the launches of each path; the layer at the training
        shape (M=100 clients x B=64) with the client axis."""
        if n not in wall:
            return {}
        tt = train_times[n]
        more = {"launches_by_path": {"serve": launches[n],
                                     "train": train_launches[n]},
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
         "launches": launches[n] + train_launches.get(n, 0),
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
