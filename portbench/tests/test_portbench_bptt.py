"""bptt_per_backward.train, the per-layer metric that reads the program's
``layer.bptt`` counter over its ``fl.backward`` spans: on a synthetic
tracer snapshot and on the tracer itself, on the CPU.

    python -m pytest -q portbench/tests/test_portbench_bptt.py
"""
import pytest

from benchlib import harness


@pytest.mark.parametrize("launches,backwards,want", [
    (3, 3, 1.0),          # one recurrent layer, one BPTT launch a backward
    (6, 3, 2.0),          # two layers
    (0, 3, None),         # a program without the counter (the parent's)
    (2, 0, None),         # no backward recorded
])
def test_bptt_per_backward_reads_the_counter_over_the_backwards(
        monkeypatch, launches, backwards, want):
    """bptt_per_backward.train on a synthetic tracer snapshot: the
    ``layer.bptt`` counter's count over the snapshot's ``fl.backward``
    spans, whatever their parents; None where either is missing."""
    from repro_torch import tracing
    spans = [("fl.round", 1, None, 0, 100, {})] + [
        ("fl.backward", 2 + i, 1 if i % 2 else None, 10 * i, 10 * i + 5, {})
        for i in range(backwards)]
    counters = ({"layer.bptt": [launches, 7 * launches, 7]}
                if launches else {"engine.submit": [4, 40, 10]})
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "spans": spans, "counters": counters, "dropped": 0, "since_ns": 0})
    got = harness.read_metric("bptt_per_backward.train",
                              {"trace": {"window_s": 1.0}})
    assert got == want
    assert harness.read_metric("bptt_per_backward.train", {}) is None


def test_bptt_per_backward_reads_the_program_tracer():
    """The same reading from the tracer itself: a counter event beside each
    recorded backward span."""
    from repro_torch import tracing
    tracing.clear()
    with tracing.recording():
        for _ in range(4):
            with tracing.span("fl.backward"):
                if tracing.on():
                    tracing.count("layer.bptt", 1000)
        got = harness.read_metric("bptt_per_backward.train",
                                  {"trace": {"window_s": 1.0}})
    assert got == 1.0
