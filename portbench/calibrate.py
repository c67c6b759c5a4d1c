"""The readings that the limits in ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control 3] [--seconds 5]

For every seed: the program's numbers against the plain reference, through
the cell's own path at its own size (training: the set-up's three rounds,
no measured window; serving: a window of ``--seconds`` at the cell's own
load).  For the first ``--control`` seeds also the control, the reference
in the program's place with TF32 products (the nearest precision below the
configurations' fp32 with TF32 off), and for training the planted fault
of half of every minibatch left out.  One JSON line per reading; one
process for all seeds, so set-up's imports and kernel builds are paid
once.  Needs the card, as a run does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from benchlib import harness  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def train(ctx, drv, control: bool):
    cell = drv.Cell(ctx)
    got = drv.program_rounds(cell)
    ref = drv.reference_rounds(cell)
    emit(seed=ctx.seed, side="program", **drv.readings(cell, got[:3], ref))
    if control:
        ctl = drv.reference_rounds(cell, tf32=True)
        emit(seed=ctx.seed, side="control_tf32",
             **drv.readings(cell, ctl, ref))
        half = drv.reference_rounds(cell, half_batch=True)
        emit(seed=ctx.seed, side="fault_half_batch",
             **drv.readings(cell, half, ref))


def serve(ctx, drv, control: bool):
    from benchlib import compare, serving
    dep = serving.Deployment(ctx)
    if ctx.traffic["kind"] == "serve_open":
        due, cons, off = drv.arrivals(ctx, dep, ctx.traffic["rate_per_s"],
                                      ctx.seconds)
        book, _, _ = drv.open_loop(dep, drv.stream(dep, due, cons, off))
    else:
        book, cons, off, _ = drv.closed_loop(dep, *drv.sessions(ctx, dep),
                                             ctx.seconds)
    pred, answered, _ = book.collect(len(cons), ctx.config["horizon"])
    gap, unanswered = serving.check(dep, cons, off, pred, answered)
    emit(seed=ctx.seed, side="program", forecast_gap=gap,
         unanswered=unanswered, requests=int(len(cons)))
    if control:
        ref = serving.reference(dep, cons, off)
        ctl = serving.reference(dep, cons, off, tf32=True)
        emit(seed=ctx.seed, side="control_tf32",
             forecast_gap=compare.forecast_gap(ctl, ref, dep.lo[cons],
                                               dep.hi[cons]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    harness.tf32_flags_off()
    bench = harness.bench_json()
    cell, config, traffic, limits = harness.cell_files(bench, args.workload)
    drv = harness.driver(traffic["kind"])
    for k, seed in enumerate(args.seeds):
        ctx = harness.Ctx(cell=cell, config=config, traffic=traffic,
                          limits=limits, seed=seed, seconds=args.seconds,
                          trace=False, device=torch.device("cuda", 0),
                          t_start=time.perf_counter())
        (train if traffic["kind"] == "fl_sync" else serve)(
            ctx, drv, k < args.control)
    emit(forbidden=harness.forbidden_modules(),
         card=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
