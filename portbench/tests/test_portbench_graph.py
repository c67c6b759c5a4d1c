"""graphed_steps.train, the per-layer metric that reads the program's
``fl.step_graph`` counter over its ``fl.local_step`` spans under
``fl.round``: on a synthetic tracer snapshot and on the tracer itself, on
the CPU.

    python -m pytest -q portbench/tests/test_portbench_graph.py
"""
import pytest

from benchlib import harness


@pytest.mark.parametrize("replays,steps,want", [
    (4, 4, 1.0),          # every step replayed
    (3, 4, 0.75),         # the round that captured: its first step eager
    (0, 4, None),         # a program without the counter (the parent's)
    (2, 0, None),         # no local step recorded under a round
])
def test_graphed_steps_reads_the_counter_over_the_round_steps(
        monkeypatch, replays, steps, want):
    """graphed_steps.train on a synthetic tracer snapshot: the
    ``fl.step_graph`` counter's count over the ``fl.local_step`` spans
    that lie under an ``fl.round`` span; steps outside a round do not
    count; None where either is missing."""
    from repro_torch import tracing
    spans = ([("fl.round", 1, None, 0, 1000, {})]
             + [("fl.local_step", 2 + i, 1, 10 * i, 10 * i + 5, {})
                for i in range(steps)]
             + [("fl.local_step", 900, None, 2000, 2005, {})])
    counters = ({"fl.step_graph": [replays, 3 * replays, 3],
                 "fl.step_graph.capture": [1, 50, 50]}
                if replays else {"layer.bptt": [4, 40, 10]})
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "spans": spans, "counters": counters, "dropped": 0, "since_ns": 0})
    got = harness.read_metric("graphed_steps.train",
                              {"trace": {"window_s": 1.0}})
    assert got == want
    assert harness.read_metric("graphed_steps.train", {}) is None


def test_graphed_steps_reads_the_program_tracer():
    """The same reading from the tracer itself: a replay counted in each
    local step of a recorded round."""
    from repro_torch import tracing
    tracing.clear()
    with tracing.recording():
        with tracing.span("fl.round"):
            for _ in range(5):
                with tracing.span("fl.local_step"):
                    if tracing.on():
                        tracing.count("fl.step_graph", 1000)
        got = harness.read_metric("graphed_steps.train",
                                  {"trace": {"window_s": 1.0}})
    assert got == 1.0
