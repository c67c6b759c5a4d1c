"""Tiny cells for the CPU tests: each cell of BENCHMARK.json with its
traffic cut to a size a test run holds, on the program's CPU route."""
import time

import torch

from benchlib import harness

SMALL = {
    "fl_sync": dict(clients=4, days=15, clients_per_round=4),
    "serve_open": dict(consumers=200, rate_per_s=2000, trace_seconds=0.3),
    "serve_closed": dict(consumers=200, in_flight=32, trace_seconds=0.3),
}


# the open-loop serving mix of the knee sweep, kept for a later cell (no
# cell of BENCHMARK.json runs it: PERF.md, Open questions)
OPEN = "serve-open.lstm-h64.p80"


def _files(workload):
    if workload == OPEN:
        b = harness.BENCH
        return ({"name": OPEN, "chips": 1},
                harness.load_json(b / "configs" / "lstm-h64.json"),
                harness.load_json(b / "traffic" /
                                  "serve-open-poisson-p80.json"),
                harness.load_json(b / "limits" / f"{OPEN}.json"))
    return harness.cell_files(harness.bench_json(), workload)


def ctx(workload, seed=2 ** 31 + 5, seconds=0.6, trace=False, **over):
    cell, config, traffic, limits = _files(workload)
    traffic = dict(traffic, **SMALL[traffic["kind"]], **over)
    return harness.Ctx(cell=cell, config=config, traffic=traffic,
                       limits=limits, seed=seed, seconds=seconds,
                       trace=trace, device=torch.device("cpu"),
                       t_start=time.perf_counter())


def run(c):
    return harness.driver(c.traffic["kind"]).run(c)


def workloads(with_open=False):
    """The cells of BENCHMARK.json (and the open-loop mix)."""
    names = [w["name"] for w in harness.bench_json()["workloads"]]
    return names + [OPEN] if with_open else names
