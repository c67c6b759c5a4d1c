"""The per-layer metrics that read the program's own tracer
(``repro_torch.tracing``): each reads a finite number from a tiny traced
run of its cells on the CPU and nothing from an empty record, and the
program's spans nest inside the harness's spans of the same round.

    python -m pytest -q portbench/tests/test_portbench_tracing.py
"""
import math

import pytest

from benchlib import harness

import _small

PROGRAM_METRICS = ("round_batch_ms.train", "upload_ms.train",
                   "local_step_host_ms.train", "backward_host_ms.train",
                   "device_wait_ms.train", "submit_us.serve_tput",
                   "queue_wait_ms.serve_tput", "flush_host_ms.serve_tput")


def _traced(workload):
    from repro_torch import tracing
    tracing.clear()
    return _small.run(_small.ctx(workload, trace=True))


@pytest.mark.parametrize("workload", _small.workloads())
def test_program_metrics_read_a_traced_run(workload):
    out = _traced(workload)
    mine = [m["name"] for m in harness.per_layer_for(harness.bench_json(),
                                                     workload)
            if m["name"] in PROGRAM_METRICS]
    assert mine
    for name in mine:
        v = harness.read_metric(name, out.records)
        assert v is not None and math.isfinite(v) and v >= 0, (name, v)


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_program_metrics_read_nothing_without_a_window(name):
    assert harness.read_metric(name, {}) is None
    assert harness.read_metric(name, {"trace": None}) is None


def test_program_spans_nest_in_the_harness_spans():
    from repro_torch import tracing
    out = _traced("fl-sync.lstm-h64.m100")
    spans = tracing.snapshot()["spans"]
    rounds = [s for s in spans if s[0] == "fl.round"]
    assert len(rounds) == 1               # the window's last round
    harness_data = out.records["spans"]["data: round_batch"]
    harness_step = out.records["spans"]["round engine: step"]
    for s in tracing.under(spans, "fl.round"):
        if s[0] == "fl.round_batch":
            assert any(a <= s[3] and s[4] <= b for a, b in harness_data)
    for r in rounds:
        steps = [s[4] - s[3] for s in spans
                 if s[0] == "fl.local_step" and s[2] == r[1]]
        assert len(steps) == r[5]["local_steps"]
        step = [b - a for a, b in harness_step if r[3] <= a and b <= r[4]]
        assert len(step) == 1 and sum(steps) <= step[0]
