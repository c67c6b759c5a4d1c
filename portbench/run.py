"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its limits are found by
the names in ``BENCHMARK.json``; the traffic names a driver kind, found as
``drivers/<kind>.py``, and each per-layer metric is read by
``metrics/<name>.py``.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, in a traced run ``breakdown``, and last
``checks``: each compared number with its limit); the compared numbers are
also the last lines of standard error.  Without a card, with fewer cards
than the cell asks for, without the program beside the benchmark, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from benchlib import harness  # noqa: E402


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def result_line(bench, workload, out, trace, device):
    metrics = {}
    if trace:
        for m in harness.per_layer_for(bench, workload):
            v = harness.read_metric(m["name"], out.records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in harness.end_to_end_for(bench, workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": harness.judge(out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.bench_json(ROOT)
    cell, config, traffic, limits = harness.cell_files(bench, args.workload)
    # the program's kernel caches stay inside the checkout at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    harness.tf32_flags_off()
    device = torch.device("cuda", 0)
    ctx = harness.Ctx(cell=cell, config=config, traffic=traffic,
                      limits=limits, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      t_start=T_START)
    out = harness.driver(traffic["kind"]).run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes,
           "power_limit_w": power_limit()}
    line = result_line(bench, args.workload, out, args.trace, dev)
    for k, v in (out.notes or {}).items():
        print(f"note {k} {v}", file=sys.stderr)
    print(f"note setup_s {out.setup_s}", file=sys.stderr)
    print(f"note card {dev['kind']} power_limit_w {dev['power_limit_w']}",
          file=sys.stderr)
    if args.trace and out.trace is not None:
        print(f"note layer_kernel_source "
              f"{out.trace.get('layer_kernel_source')}", file=sys.stderr)
    for n, v, lim in out.checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
