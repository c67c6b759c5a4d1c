"""The knee of an open-loop serving cell: one set-up, then a short window
at each offered rate.

    python3 portbench/sweep.py --config lstm-h64 \
        --traffic serve-open-poisson-p80 --seed 7 --seconds 6 \
        --rates 20000 40000 60000 ...

For each rate: requests offered, the share answered by the window's close,
the backlog (requests due but not answered) at a quarter, half, three
quarters and the end of the window, the answered rate, and p50 / p95 / p99 from
due time.  The knee is the highest rate at which the backlog does not grow
over the window and at least 99 % of the offered requests are answered by
its close; a cell runs at 4/5 of it, a number written into its traffic
file.  The mix needs no cell of ``BENCHMARK.json``.  Needs the card.
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


def main(argv=None) -> int:
    import numpy as np
    import torch
    from benchlib import serving
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    harness.tf32_flags_off()
    bench = harness.bench_json()
    configs = {c["name"]: c for c in bench["configs"]}
    config = harness.load_json(harness.ROOT / configs[args.config]["file"])
    traffic = harness.load_json(harness.BENCH / "traffic" /
                                f"{args.traffic}.json")
    drv = harness.driver(traffic["kind"])
    ctx = harness.Ctx(cell={"name": args.traffic, "chips": 1},
                      config=config, traffic=traffic, limits={},
                      seed=args.seed, seconds=args.seconds,
                      trace=False, device=torch.device("cuda", 0),
                      t_start=T_START)
    dep = serving.Deployment(ctx)
    S = args.seconds
    for rate in args.rates:
        due, cons, off = drv.arrivals(ctx, dep, rate, S)
        delta = serving.EngineDelta(dep.engine)
        from benchlib.trace import GcWatch
        with GcWatch() as gcw:
            book, late, wall = drv.open_loop(dep, drv.stream(dep, due, cons,
                                                             off))
        _, answered, done = book.collect(len(due), config["horizon"])
        done = np.where(answered, done, np.inf)
        lat = (done - due) * 1e3
        eng = delta.read()
        print(json.dumps({
            "rate": rate, "offered": len(due),
            "answered_by_close": float((done <= S).mean()),
            "backlog": [int(((due <= t) & (done > t)).sum())
                        for t in (S / 4, S / 2, 3 * S / 4, S)],
            "answered_per_s": float(answered.sum() / wall),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "lateness_p99_ms": float(np.percentile(late, 99) * 1e3),
            "fill": eng["requests"] / max(eng["padded_rows"], 1),
            "flush_ms": 1e3 * eng["busy_s"] / max(eng["flushes"], 1),
            **gcw.summary()}),
            flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "forbidden": harness.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
