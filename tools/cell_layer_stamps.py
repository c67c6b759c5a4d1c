#!/usr/bin/env python3
"""Where the time of one recurrent-layer launch goes, phase by phase: the
LSTM and GRU layer kernels built with their cycle stamps compiled in
(``-DLAYER_STAMPS``, see ``csrc/recurrent_layer.cuh``), launched at the
serving shape (B=256, T=8, H=64, fp32; LSTM I=1, GRU I=1 and I=64) with the
default launch plan, and read back from thread 0 of the first block.

    python3 tools/cell_layer_stamps.py [--launches 5]

Prints one JSON line per layer: the prologue's phases and each step's sums,
epilogue and barrier, in SM cycles, and in microseconds at the SM clock
measured under load (a ``torch.cuda._sleep`` spin of known cycles between
CUDA events), from the last of ``--launches`` back-to-back launches.  The
stamped libraries build into ``build/layer_stamps/`` and never replace the
kernels the port loads.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROLOGUE = ("mbarrier_ready", "copies_issued", "padding_zeroed",
            "row_buffers_filled", "weights_landed", "prologue_done")


def build(name):
    from repro_torch.kernels import _cuda
    out = ROOT / "build" / "layer_stamps"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-DLAYER_STAMPS",
                    "-o", str(lib), str(_cuda.CSRC / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=5)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        sys.exit("cell_layer_stamps: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10_000_000)                 # bring the clock up
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    mhz = 20_000_000 / (a.elapsed_time(b) * 1e3)
    B, T, H = 256, 8, 64
    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for name, I in (("lstm_cell", 1), ("gru_cell", 1), ("gru_cell", 64)):
        lib = build(name)
        G = _cuda.GATES[name]
        x, h0, c0 = (torch.randn(*s, generator=gen).cuda() * 0.3
                     for s in ((T, B, I), (B, H), (B, H)))
        w = [torch.randn(*s, generator=gen).cuda() * 0.3
             for s in ((I, G * H), (H, G * H), (G * H,))]
        h_seq = torch.empty(T, B, H, device="cuda")
        c_out = torch.empty(B, H, device="cuda")
        ins = [x, h0, c0, *w, h_seq, c_out] if G == 4 else [x, h0, *w, h_seq]
        plan = _cuda.cell_plan(name, B, I, H, 4, sms)
        fn = getattr(lib, f"repro_{name}_f32")
        fn.argtypes = _cuda._ARGTYPES[name] + [ctypes.c_void_p]
        for _ in range(args.launches):
            err = fn(*[t.data_ptr() for t in ins], T, B, I, H, *plan, stream)
            if err:
                sys.exit(f"cell_layer_stamps: {name} launch failed ({err})")
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * 64)()
        lib.repro_layer_stamps(raw)
        at = [v - raw[0] for v in raw]
        steps = [{"sums": at[9 + 4 * t] - at[8 + 4 * t],
                  "epilogue": at[10 + 4 * t] - at[9 + 4 * t],
                  "barrier": at[11 + 4 * t] - at[10 + 4 * t]}
                 for t in range(T - 1)]
        last = at[8 + 4 * (T - 1)]
        print(json.dumps({
            "kernel": name, "I": I, "B": B, "T": T, "H": H,
            "plan": plan._asdict(), "sm_mhz": mhz,
            "prologue_cycles": dict(zip(PROLOGUE, at[1:7])),
            "first_step_top_cycles": at[8],
            "steps_cycles": steps, "last_step_top_cycles": last,
            "mean_step_cycles": (last - at[8]) / (T - 1),
            "prologue_us": at[6] / mhz,
            "mean_step_us": (last - at[8]) / (T - 1) / mhz}), flush=True)


if __name__ == "__main__":
    main()
