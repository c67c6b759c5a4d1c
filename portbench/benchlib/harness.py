"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the run's context, the check against the limits, the
guard against JAX, and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent        # portbench/
ROOT = BENCH.parent                                   # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""
    cell: dict                      # the workloads entry
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<traffic>.json
    limits: dict                    # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: Any                     # torch.device
    t_start: float                  # perf_counter at process start


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    end_to_end: Dict[str, float]    # the cell's end-to-end metrics but setup_s
    setup_s: float
    attempted: int
    failed: int
    checks: List[tuple]             # (name, value, limit)
    memory_peak_bytes: int
    records: dict                   # what the per-layer readers read
    trace: Optional[dict] = None    # DeviceTrace.finish() of a traced run
    notes: Optional[dict] = None    # printed on stderr, not metrics


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a harness file found by name (a driver kind, a metric)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(bench: dict, workload: str, bench_dir: Path = BENCH):
    """(cell, config, traffic, limits) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(bench_dir.parent / configs[cell["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def driver(kind: str, bench_dir: Path = BENCH):
    return load_module(bench_dir / "drivers" / f"{kind}.py",
                       f"portbench_driver_{kind}")


def per_layer_for(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, or,
    without a list, those whose ``moves`` metric it reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def end_to_end_for(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def read_metric(name: str, records: dict, bench_dir: Path = BENCH):
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_"))
    return mod.read(records)


def judge(checks) -> bool:
    """Every compared number is a finite reading within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def settle():
    """The end of set-up: one full collection of the interpreter's cyclic
    garbage, so that every window starts from the same collector state
    (set-up leaves some hundred thousand young objects, whose promotion
    would otherwise bring a full collection into the window at a run-
    dependent moment).  Returns the objects the collector tracks."""
    import gc
    gc.collect()
    return len(gc.get_objects())


def tf32_flags_off():
    """The configurations state fp32 with TF32 off: hold the process to it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
