#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch/``).

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the
forecast-serving path end to end (registry -> router -> bucketed engine ->
fused cells) at the paper forecaster's full width for the LSTM and a
2-layer GRU, checks the results against the same engine on the CPU, times
the kernels at the serving shape, and ends with one JSON status line.

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

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# dense fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py
REQUESTS_PER_CONSUMER = 8
CONSUMERS = 256
HISTORY_DAYS = 14


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


# --------------------------------------------------------------- phase 2
def check_kernels(seed):
    """Kernel vs plain version on the same CUDA tensors; returns the max
    abs error of each kernel at the serving shape in fp32."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.gru_cell import gru_cell
    from repro_torch.kernels.lstm_cell import lstm_cell

    lstm_shapes = [(8, 1, 16), (64, 8, 64), (128, 4, 128), (32, 16, 256)]
    gru_shapes = [(8, 1, 16), (64, 8, 64), (128, 4, 128)]
    # the shapes the serving path gives the kernels: every batch bucket at
    # H=64, with I=1 (first layer) and I=64 (the GRU's second layer); then
    # ragged shapes that no block divides, for the masked tails
    extra = [(B, I, 64) for B in (8, 16, 32, 64, 128, 256) for I in (1, 64)]
    extra += [(37, 1, 50), (37, 50, 50)]
    serving_err = {}
    gen = torch.Generator().manual_seed(seed)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)

        def rnd(*shape):
            return (torch.randn(*shape, generator=gen) * 0.3).to("cuda", dt)

        rows = []
        for name, shapes in (("lstm_cell", lstm_shapes + extra),
                             ("gru_cell", gru_shapes + extra)):
            for B, I, H in shapes:
                if name == "lstm_cell":
                    args = (rnd(B, I), rnd(B, H), rnd(B, H), rnd(I, 4 * H),
                            rnd(H, 4 * H), rnd(4 * H))
                    outs = lstm_cell(*args)
                    refs = ref.lstm_cell_ref(*args)
                else:
                    args = (rnd(B, I), rnd(B, H), rnd(I, 3 * H),
                            rnd(H, 3 * H), rnd(3 * H))
                    outs = (gru_cell(*args),)
                    refs = (ref.gru_cell_ref(*args),)
                torch.cuda.synchronize()
                errs = [_max_err(o, r, TOL[dname]) for o, r in zip(outs, refs)]
                err = max(e for e, _ in errs)
                ok = all(k for _, k in errs) and all(
                    o.dtype == dt and o.is_cuda for o in outs)
                rows.append({"kernel": name, "B": B, "I": I, "H": H,
                             "max_abs_err": err, "ok": ok})
                require(ok, f"{name} {dname} B={B} I={I} H={H}: kernel "
                        f"disagrees with its plain version (max abs err "
                        f"{err:.3g}, tol {TOL[dname]})")
                if dname == "float32" and (B, I, H) == (256, 1, 64):
                    serving_err[name] = err
        emit({"phase": "kernel_vs_plain", "dtype": dname, "tol": TOL[dname],
              "cases": rows})
    return serving_err


# --------------------------------------------------------------- phase 3
def serve_slice(cfg, seed):
    """Serve REQUESTS_PER_CONSUMER requests from each of CONSUMERS synthetic
    CA consumers on the card and on the CPU; returns the card run's
    launches of the config's cell and mean wall time of a full (max_batch)
    flush."""
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
    expect = st.flushes * cfg.lookback * cfg.n_layers
    require(counts[name] == expect and counts[other] == 0,
            f"launch counts {counts}, expected {name}={expect} "
            f"(= {st.flushes} flushes x {cfg.lookback} x {cfg.n_layers})")
    worst = 0.0
    for a, b in zip(tickets, cpu_tickets):
        scale = b.hi - b.lo
        err = np.abs(a.result - b.result)
        worst = max(worst, float((err / (1e-4 * np.abs(b.result)
                                         + 1e-4 * scale)).max()))
    require(worst <= 1.0, f"card vs CPU engine disagree: worst error is "
            f"{worst:.3g}x the tolerance (rtol 1e-4, atol 1e-4*(hi-lo))")
    full = st.flushes - len(last)
    require(full > 0, "no full flush")
    full_wall = (st.busy_s - sum(f.wall_s for f in last)) / full
    emit({"phase": "serve", "cfg": dataclasses.asdict(cfg),
          "requests": len(tickets), "consumers": CONSUMERS, "slots": sorted({t.slot for t in tickets}),
          "flushes": st.flushes, "by_bucket": st.by_bucket,
          "fill": st.fill(), "launches": counts,
          "card_vs_cpu_worst_over_tol": worst,
          "mean_full_flush_wall_ms": full_wall * 1e3,
          "busy_s": st.busy_s, "run_s": card_s})
    return counts[name], full_wall


# --------------------------------------------------------------- phase 4
def time_ms(fn, iters=300, warmup=50, chunk=20):
    """(device ms, host ms) of one call of ``fn``.

    Device: median over ``iters`` calls of CUDA events recorded around each
    call, with the host kept ahead of the card (a ``torch.cuda._sleep``
    spin, sized from the measured host cost, holds the stream while a chunk
    of calls is enqueued), so each pair times the call's kernels and not
    the host's dispatch.  Host: wall time per call of back-to-back calls ending
    in a synchronize, which is what a caller waits when the card is idle.
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


def _timed(kernel, plain, library, **counts):
    out = dict(counts)
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"], out[f"{key}host_ms"] = time_ms(fn)
    return out


def time_kernels(seed):
    """Kernel, plain version and the one-call yardstick at the serving
    shape (B=256, I=1, H=64, fp32), beside the bound from bytes and
    FLOPs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.gru_cell import gru_cell
    from repro_torch.kernels.lstm_cell import lstm_cell

    B, I, H = 256, 1, 64
    gen = torch.Generator().manual_seed(seed + 1)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen) * 0.3).to("cuda")

    out = {}
    x, h, c = rnd(B, I), rnd(B, H), rnd(B, H)
    wx, wh, b = rnd(I, 4 * H), rnd(H, 4 * H), rnd(4 * H)
    w_ih, w_hh, b_hh = wx.t().contiguous(), wh.t().contiguous(), \
        torch.zeros_like(b)
    lib_h, lib_c = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)
    ref_h, ref_c = ref.lstm_cell_ref(x, h, c, wx, wh, b)
    require(_max_err(lib_h, ref_h, 2e-5)[1] and _max_err(lib_c, ref_c, 2e-5)[1],
            "torch.lstm_cell yardstick does not compute the repo's cell")
    n_bytes = 4 * (B * I + 2 * B * H + I * 4 * H + H * 4 * H + 4 * H
                   + 2 * B * H)
    flops = 2 * B * (I + H) * 4 * H
    out["lstm_cell"] = _timed(
        lambda: lstm_cell(x, h, c, wx, wh, b),
        lambda: ref.lstm_cell_ref(x, h, c, wx, wh, b),
        lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh),
        bytes=n_bytes, flops=flops)

    gx, gwx, gwh, gb = rnd(B, I), rnd(I, 3 * H), rnd(H, 3 * H), rnd(3 * H)
    # torch.gru_cell orders the gates [r|z|n]; the repo's are [z|r|h~]
    perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                      torch.arange(2 * H, 3 * H)]).cuda()
    g_ih, g_hh = gwx[:, perm].t().contiguous(), gwh[:, perm].t().contiguous()
    g_b, g_bhh = gb[perm].contiguous(), torch.zeros_like(gb)
    require(_max_err(torch.gru_cell(gx, h, g_ih, g_hh, g_b, g_bhh),
                     ref.gru_cell_ref(gx, h, gwx, gwh, gb), 2e-5)[1],
            "torch.gru_cell yardstick does not compute the repo's cell")
    out["gru_cell"] = _timed(
        lambda: gru_cell(gx, h, gwx, gwh, gb),
        lambda: ref.gru_cell_ref(gx, h, gwx, gwh, gb),
        lambda: torch.gru_cell(gx, h, g_ih, g_hh, g_b, g_bhh),
        bytes=4 * (B * I + B * H + I * 3 * H + H * 3 * H + 3 * H + B * H),
        flops=2 * B * (I + H) * 3 * H)
    for t in out.values():
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["flops"] / FP32_FLOPS_PER_S * 1e3
        t["bound_ms"] = max(bytes_ms, ops_ms)
        t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"phase": "timing", "shape": {"B": B, "I": I, "H": H,
                                       "dtype": "float32"},
          "median_of": 300, **out})
    return out


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
    from repro_torch.kernels import ops

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
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "kernel_build_s": build_s})

    # ---- phase 2: each kernel against its plain version on the card
    errs = check_kernels(args.seed)

    # ---- phase 3: the serving slice, LSTM then 2-layer GRU
    launches, wall = {}, {}
    for cfg in (ForecasterConfig(), ForecasterConfig(cell="gru", n_layers=2)):
        name = f"{cfg.cell}_cell"
        launches[name], wall[name] = serve_slice(cfg, args.seed)
        require(launches[name] > 0, f"{name} never launched on its path")

    # ---- phase 4: times at the serving shape
    times = time_kernels(args.seed)

    replaces = {"lstm_cell": "src/repro/kernels/lstm_cell.py:24",
                "gru_cell": "src/repro/kernels/gru_cell.py:17"}
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": f"src/repro_torch/csrc/{n}.cu",
         "replaces": replaces[n], "launches": launches[n],
         "max_abs_err": errs[n], "ms": times[n]["ms"],
         "plain_ms": times[n]["plain_ms"], "bound_ms": times[n]["bound_ms"],
         "bound_by": times[n]["bound_by"],
         "library_ms": times[n]["library_ms"],
         "engine_full_flush_wall_ms": wall[n] * 1e3}
        for n in ops.KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
