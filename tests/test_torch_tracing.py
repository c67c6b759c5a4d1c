"""The port's tracer (``repro_torch.tracing``): off, the round and the engine
record nothing; on, under ``tracing.recording()`` or a CPU
``torch.profiler`` session, the spans nest as the program runs them, their
attributes count what the run did, and the numbers the program computes are
bit for bit those of a run with the tracer off."""
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import FLConfig, ForecasterConfig  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.data import partition, synthetic, windows  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402
from repro_torch.models.layers import (seeded_generator,  # noqa: E402
                                       tree_leaves)
from repro_torch.serving import ModelRegistry, ServingEngine  # noqa: E402

CFG = ForecasterConfig(hidden_dim=8)
FL = dict(n_clients=4, clients_per_round=3, rounds=2, batch_size=32,
          n_clusters=0, seed=3)
DAYS = 10


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


def _switch(kind):
    if kind == "recording":
        return tracing.recording()
    return profile(activities=[ProfilerActivity.CPU])


def _series():
    return synthetic.generate_buildings("CA", list(range(4)), days=DAYS)


def _provider():
    return windows.ClientWindowProvider.from_series(_series(), CFG.lookback,
                                                    CFG.horizon)


def _train():
    return fedavg.run_federated_training(_series(), CFG, FLConfig(**FL),
                                         device="cpu")[-1]


def _engine():
    reg = ModelRegistry(device="cpu")
    reg.publish(forecaster.init_forecaster(seeded_generator(7), CFG), CFG,
                generation=1)
    return ServingEngine(reg, max_batch=16, min_bucket=8, auto_flush=False,
                         device="cpu")


def _windows(n=37):
    return (np.random.default_rng(5).random((n, CFG.lookback)) * 3 + 1
            ).astype(np.float32)


def _serve(eng, wins):
    reqs = [eng.submit(None, w) for w in wins[:20]]
    stats = eng.flush()
    reqs += [eng.submit(None, w) for w in wins[20:]]
    stats += eng.flush()
    return reqs, stats


def test_off_records_nothing():
    _train()
    reqs, _ = _serve(_engine(), _windows())
    assert tracing.snapshot() == {"spans": [], "counters": {}, "dropped": 0,
                                  "since_ns": 0}
    assert all(r.submit_ns == 0 for r in reqs)


@pytest.mark.parametrize("kind", ["recording", "profiler"])
def test_round_spans_nest_and_count_the_run(kind):
    off = _train()
    t_before = time.time_ns()
    with _switch(kind):
        got = _train()
    t_after = time.time_ns()
    np.testing.assert_array_equal(got.loss_history, off.loss_history)
    for a, b in zip(tree_leaves(got.params), tree_leaves(off.params)):
        np.testing.assert_array_equal(a, b)
    spans = tracing.snapshot()["spans"]
    by_id = {s[1]: s for s in spans}
    names = Counter(s[0] for s in spans)
    rounds = [s for s in spans if s[0] == "fl.round"]
    steps = partition.local_steps(_provider().n_win_max, FL["batch_size"],
                                  1)
    assert [s[5]["round"] for s in rounds] == list(range(FL["rounds"]))
    for r in rounds:
        assert r[2] is None
        assert r[5]["clients"] == FL["clients_per_round"]
        assert r[5]["local_steps"] == steps
        assert r[5]["windows"] == (FL["clients_per_round"] * steps
                                   * FL["batch_size"])
        kids = Counter(s[0] for s in spans if s[2] == r[1])
        assert kids == {"fl.round_batch": 1, "fl.upload": 1,
                        "fl.local_step": steps, "fl.wait": 1}
    assert names["fl.local_step"] == names["fl.backward"] == \
        FL["rounds"] * steps
    parent_of = {"fl.round_batch": "fl.round", "fl.upload": "fl.round",
                 "fl.local_step": "fl.round", "fl.wait": "fl.round",
                 "fl.backward": "fl.local_step"}
    for s in spans:
        assert t_before <= s[3] <= s[4] <= t_after
        if s[0] == "fl.round":
            continue
        p = by_id[s[2]]
        assert p[0] == parent_of[s[0]]
        assert p[3] <= s[3] and s[4] <= p[4]
    up = [s for s in spans if s[0] == "fl.upload"]
    assert all(s[5]["bytes"] > 0 for s in up)


@pytest.mark.parametrize("kind", ["recording", "profiler"])
def test_engine_counts_submits_and_queue_waits(kind):
    wins = _windows()
    want = np.stack([r.result for r in _serve(_engine(), wins)[0]])
    eng = _engine()
    with _switch(kind):
        reqs, stats = _serve(eng, wins)
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]), want)
    snap = tracing.snapshot()
    n = len(wins)
    assert snap["counters"]["engine.submit"][0] == n
    total, peak = snap["counters"]["engine.submit"][1:]
    assert 0 < peak <= total
    flushes = [s for s in snap["spans"] if s[0] == "engine.flush"]
    assert [(s[5]["rows"], s[5]["bucket"]) for s in flushes] == \
        [(fs.n_requests, fs.bucket) for fs in stats]
    assert sum(s[5]["wait_n"] for s in flushes) == n
    forward = {s[2]: s for s in snap["spans"] if s[0] == "engine.forward"}
    for s in flushes:
        f = forward[s[1]]
        assert s[3] <= f[3] <= f[4] <= s[4]
        assert (s[4] - s[3]) - (f[4] - f[3]) >= 0
        assert 0 <= s[5]["wait_max_ns"] <= s[5]["wait_sum_ns"]
    assert all(r.submit_ns > 0 for r in reqs)


def test_a_new_session_restarts_the_records():
    eng = _engine()
    wins = _windows()
    with tracing.recording():
        _serve(eng, wins)
    assert tracing.snapshot()["counters"]["engine.submit"][0] == len(wins)
    assert not tracing.on()         # the switch off, noticed
    with tracing.recording():
        eng.submit(None, wins[0])
        eng.flush()
    snap = tracing.snapshot()
    assert snap["counters"]["engine.submit"][0] == 1
    assert [s[0] for s in snap["spans"]] == ["engine.forward", "engine.flush"]
    assert snap["since_ns"] <= snap["spans"][0][3]


def test_a_span_opened_while_off_is_no_parent():
    with tracing.span("outer") as outer:
        assert not outer
        with tracing.recording():
            with tracing.span("inner") as inner:
                assert inner
    assert [s[:3] for s in tracing.snapshot()["spans"]] == \
        [("inner", inner.id, None)]


def test_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with tracing.recording():
        for _ in range(5):
            with tracing.span("s"):
                pass
    snap = tracing.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2


def test_under_follows_parents_at_any_depth():
    with tracing.recording():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
        with tracing.span("d"):
            pass
    spans = tracing.snapshot()["spans"]
    assert sorted(s[0] for s in tracing.under(spans, "a")) == ["b", "c"]
    assert tracing.under(spans, "d") == []
