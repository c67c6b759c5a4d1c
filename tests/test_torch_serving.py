"""The port's serving tier against the JAX package's, on the CPU.

Buckets, the copied numpy modules, per-request kWh from the engine with
routed clusters, checkpoint polling, generations and hot-swap atomicity,
``serve_forecaster``, and the rule that entry points run on the card unless
the caller asks for the CPU.  Weights are made by JAX and carried across as
numpy arrays; kWh agree at rtol 1e-5 and atol 1e-5·(hi−lo) of the row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import serving as jsv  # noqa: E402
from repro.configs.base import ForecasterConfig as JaxForecasterConfig  # noqa: E402
from repro.core import clustering as jclu  # noqa: E402
from repro.data import synthetic as jsyn, windows as jwin  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import serving as tsv  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.core import clustering as tclu  # noqa: E402
from repro_torch.data import synthetic as tsyn, windows as twin  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import forecaster as tfc  # noqa: E402

JCFG, CFG = JaxForecasterConfig(), ForecasterConfig()
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(i):
    return jfc.init_forecaster(jax.random.PRNGKey(i), JCFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fleet():
    """Histories of 24 CA consumers and a 2-cluster router over them, built
    as ``benchmarks/bench_serving.py`` builds its router."""
    days = 6
    series = jsyn.generate_buildings("CA", list(range(24)), days=days)
    z = jwin.daily_average_vector(series, days=days)
    cents, _, _ = jclu.kmeans(z, 2, seed=0)
    return series, cents


# ------------------------------------------------------------------ buckets
def test_buckets_match_jax():
    for lo, hi in [(1, 1), (1, 64), (8, 256), (16, 16), (4, 1024)]:
        assert tsv.bucket_ladder(lo, hi) == jsv.bucket_ladder(lo, hi)
        for n in range(1, hi + 1):
            assert tsv.bucket_for(n, lo, hi) == jsv.bucket_for(n, lo, hi)
    for n in (0, 65):
        with pytest.raises(ValueError):
            tsv.bucket_for(n, 8, 64)


# ----------------------------------------------------------- numpy copies
def test_numpy_copies_are_array_equal(fleet):
    ids = [0, 3, 50_001]
    np.testing.assert_array_equal(tsyn.generate_buildings("FLO", ids, 3),
                                  jsyn.generate_buildings("FLO", ids, 3))
    series, cents = fleet
    z_j = jwin.daily_average_vector(series, days=5)
    z_t = twin.daily_average_vector(series, days=5)
    np.testing.assert_array_equal(z_t, z_j)
    for k, seed in [(2, 0), (3, 7)]:
        cj, aj, ij = jclu.kmeans(z_j, k, seed=seed)
        ct, at, it = tclu.kmeans(z_t, k, seed=seed)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(at, aj)
        assert it == ij
        np.testing.assert_array_equal(tclu.assign(z_t, ct),
                                      jclu.assign(z_j, cj))
    jr, tr = jsv.ClusterRouter(cents), tsv.ClusterRouter(cents)
    for s in list(series) + [series[0][:150], series[1][:10]]:
        np.testing.assert_array_equal(tsv.daily_summary_of(s, 6),
                                      jsv.daily_summary_of(s, 6))
        assert tr.route(s) == jr.route(s)
    z6 = twin.daily_average_vector(series, days=6)
    np.testing.assert_array_equal(tr.route_summaries(z6),
                                  jr.route_summaries(z6))
    assert (tsv.ClusterRouter(None).route(series[0])
            == jsv.ClusterRouter(None).route(series[0]) == tsv.GLOBAL_SLOT)


# --------------------------------------------------------------- engine
def _replay(engine, series, rng_seed=4):
    """Submit a mixed stream: first contact with history, cache hits,
    anonymous window-only requests; flush; return the tickets."""
    rng = np.random.default_rng(rng_seed)
    L = CFG.lookback
    tickets = []
    for i, s in enumerate(series):
        tickets.append(engine.submit(i, s[-L:], history=s))
    for _ in range(60):
        i = int(rng.integers(len(series)))
        t = int(rng.integers(L, series.shape[1]))
        tickets.append(engine.submit(i, series[i, t - L:t]))
    for _ in range(5):
        tickets.append(engine.submit(None, series[0, 100:100 + L]))
    engine.flush()
    return tickets


def test_engine_kwh_matches_jax_per_request(fleet):
    series, cents = fleet
    jreg, treg = jsv.ModelRegistry(), tsv.ModelRegistry(device=CPU)
    for i, slot in enumerate((jsv.GLOBAL_SLOT, 0, 1)):
        p = _jparams(10 + i)
        jreg.publish(p, JCFG, slot=slot, generation=1)
        treg.publish(tfc.params_from_numpy(_np(p)), CFG, slot=slot,
                     generation=1)
    kw = dict(max_batch=32, min_bucket=8)
    jeng = jsv.ServingEngine(jreg, jsv.ClusterRouter(cents), **kw)
    teng = tsv.ServingEngine(treg, tsv.ClusterRouter(cents), device=CPU, **kw)
    assert teng.warmup() == len(tsv.bucket_ladder(8, 32))
    jt, tt = _replay(jeng, series), _replay(teng, series)
    assert {t.slot for t in tt} == {jsv.GLOBAL_SLOT, 0, 1}
    for a, b in zip(tt, jt):
        assert (a.slot, a.lo, a.hi) == (b.slot, b.lo, b.hi)
        assert a.done and a.result.shape == (CFG.horizon,)
        np.testing.assert_allclose(a.result, b.result, rtol=1e-5,
                                   atol=1e-5 * (b.hi - b.lo))
    assert teng.stats.flushes == jeng.stats.flushes
    assert teng.stats.by_bucket == jeng.stats.by_bucket
    assert teng.stats.requests == jeng.stats.requests == len(tt)
    assert teng.stats.fill() == pytest.approx(jeng.stats.fill())
    assert teng.pending() == 0


def test_engine_validation():
    reg = tsv.ModelRegistry(device=CPU)
    reg.publish(tfc.param_template(CFG), CFG, generation=1)
    eng = tsv.ServingEngine(reg, max_batch=8, min_bucket=8, device=CPU)
    with pytest.raises(ValueError, match="lookback"):
        eng.submit(0, np.ones(CFG.lookback + 1, np.float32))
    for mb, mn in [(12, 4), (8, 3), (8, 16)]:
        with pytest.raises(ValueError):
            tsv.ServingEngine(reg, max_batch=mb, min_bucket=mn, device=CPU)
    with pytest.raises(ValueError, match="registry"):
        tsv.ServingEngine(reg, device="meta")
    reqs = [eng.submit(None, np.arange(CFG.lookback, dtype=np.float32) + i)
            for i in range(8)]
    assert all(r.done for r in reqs)                  # 8th submit flushed
    assert eng.stats.flushes == 1 and eng.stats.by_bucket == {8: 1}


# ------------------------------------------------------------ registry
def test_stale_publish_raises_or_skips():
    reg = tsv.ModelRegistry(device=CPU)
    p = tfc.param_template(CFG)
    reg.publish(p, CFG, generation=3)
    with pytest.raises(ValueError, match="stale"):
        reg.publish(p, CFG, generation=3)
    assert reg.publish(p, CFG, generation=2, if_newer=True) is None
    assert reg.publish(p, CFG, generation=4, if_newer=True).generation == 4
    assert reg.generation() == 4 and reg.generation(5) == -1
    assert reg.handle(5).slot == tsv.GLOBAL_SLOT          # global fallback
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reg.publish(p, CFG, generation=5, weights="int8")
    with pytest.raises(KeyError):
        tsv.ModelRegistry(device=CPU).handle(0)


def test_poll_checkpoint_matches_jax_on_fl_layout(tmp_path):
    """An FL-training-layout checkpoint written by JAX publishes the same
    slots, generations and weights in both registries."""
    p0, p1 = _jparams(20), _jparams(21)
    jck.save(tmp_path / "fl", {"done": {"0": {"params": p0}},
                               "cur": {"params": p1}},
             metadata={"done": [0], "cluster": 1, "generation": 5})
    glob = str(tmp_path / "*.npz")
    jreg, treg = jsv.ModelRegistry(), tsv.ModelRegistry(device=CPU)
    jup, tup = jreg.poll_checkpoint(glob, JCFG), treg.poll_checkpoint(glob,
                                                                      CFG)
    assert [(h.slot, h.generation) for h in tup] == \
        [(h.slot, h.generation) for h in jup] == [(0, 5), (1, 5)]
    for slot, p in ((0, p0), (1, p1)):
        got = tfc.params_to_numpy(treg.handle(slot).params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(p))):
            np.testing.assert_array_equal(a, b)
    assert treg.poll_checkpoint(glob, CFG) == []          # watermark
    # a bare params tree, written by the port, publishes the global slot
    tck_path = tmp_path / "g" / "params"
    tck.save(tck_path, tfc.params_from_numpy(_np(p0)),
             metadata={"generation": 2})
    gglob = str(tmp_path / "g" / "*.npz")
    assert [(h.slot, h.generation) for h in
            tsv.ModelRegistry(device=CPU).poll_checkpoint(gglob, CFG)] == \
        [(h.slot, h.generation) for h in
         jsv.ModelRegistry().poll_checkpoint(gglob, JCFG)] == \
        [(tsv.GLOBAL_SLOT, 2)]


class _SwapOnHandle(tsv.ModelRegistry):
    """Fires a publish the instant a flush fetches its handle: a checkpoint
    poller racing the batch executor."""

    def __init__(self):
        super().__init__(device=CPU)
        self.armed = None

    def handle(self, slot=tsv.GLOBAL_SLOT):
        h = super().handle(slot)
        if self.armed is not None:
            fire, self.armed = self.armed, None
            fire()
        return h


def test_publish_mid_flush_lands_at_next_flush():
    p1 = tfc.params_from_numpy(_np(_jparams(30)))
    p2 = {"layers": [{k: v + 1.0 for k, v in lp.items()}
                     for lp in p1["layers"]],
          "head": {k: v + 1.0 for k, v in p1["head"].items()}}
    reg = _SwapOnHandle()
    reg.publish(p1, CFG, generation=1)
    eng = tsv.ServingEngine(reg, max_batch=16, min_bucket=8,
                            auto_flush=False, device=CPU)
    wins = (np.random.default_rng(3).random((10, CFG.lookback)) * 3 + 1
            ).astype(np.float32)
    reqs = [eng.submit(None, w) for w in wins]
    reg.armed = lambda: reg.publish(p2, CFG, generation=2)
    assert [fs.generation for fs in eng.flush()] == [1]
    want = tserve.serve_forecaster(
        p1, CFG, (wins - wins.min(1, keepdims=True))
        / (wins.max(1, keepdims=True) - wins.min(1, keepdims=True)))
    for r, w, y in zip(reqs, wins, want):
        np.testing.assert_allclose(r.result, y * (w.max() - w.min())
                                   + w.min(), rtol=1e-5, atol=1e-5)
    eng.submit(None, wins[0])
    assert [fs.generation for fs in eng.flush()] == [2]
    assert eng.stats.swaps_seen == 1


# ------------------------------------------------------- entry points
def test_serve_forecaster_matches_jax():
    jp = _jparams(40)
    x = np.random.default_rng(5).random((70, CFG.lookback)).astype(np.float32)
    want = jserve.serve_forecaster(jp, JCFG, x, batch=32)
    got = tserve.serve_forecaster(tfc.params_from_numpy(_np(jp)), CFG, x,
                                  batch=32)
    assert got.shape == want.shape == (70, CFG.horizon)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_serve_main_on_cpu_from_a_jax_checkpoint(tmp_path, capsys):
    jck.save(tmp_path / "w", _jparams(50), metadata={"generation": 1})
    tickets = tserve.main(["--device", "cpu", "--requests", "12", "--days",
                           "3", "--max-batch", "8", "--checkpoint",
                           str(tmp_path / "w.npz")])
    assert len(tickets) == 12
    assert all(np.isfinite(t.result).all() for t in tickets)
    assert "12 forecasts" in capsys.readouterr().out
    tickets = tserve.main(["--device", "cpu", "--requests", "6", "--days",
                           "3", "--clusters", "2", "--max-batch", "8",
                           "--train-clients", "6", "--rounds", "2"])
    assert {t.slot for t in tickets} <= {0, 1}


def test_serve_main_trains_then_serves_the_trained_models(monkeypatch,
                                                          capsys):
    """Without a checkpoint, serve first trains (the port's
    ``run_federated_training``) and publishes each cluster's model at the
    generation of its rounds, routed by the training's centroids; --int8
    raises, naming ROADMAP A7."""
    published = []
    real = tsv.ModelRegistry.publish

    def spy(self, params, cfg, **kw):
        published.append((kw["slot"], kw["generation"],
                          tfc.params_to_numpy(tfc.params_from_numpy(params))))
        return real(self, params, cfg, **kw)

    monkeypatch.setattr(tsv.ModelRegistry, "publish", spy)
    tickets = tserve.main(["--device", "cpu", "--requests", "10", "--days",
                           "4", "--clusters", "2", "--max-batch", "8",
                           "--train-clients", "6", "--rounds", "2"])
    assert "quick FL fit on 6 clients" in capsys.readouterr().out
    assert sorted(s for s, _, _ in published) == [0, 1]
    assert all(g == 2 for _, g, _ in published)
    assert {t.slot for t in tickets} <= {0, 1}
    assert all(np.isfinite(t.result).all() for t in tickets)
    # the published weights are the training's result
    series = tsyn.generate_buildings("CA", list(range(6)), days=4)
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import fedavg as tfed
    res = tfed.run_federated_training(
        series, CFG, FLConfig(n_clients=6, clients_per_round=6, rounds=2,
                              n_clusters=2, lr=0.05, cluster_days=3),
        device=CPU)
    for slot, _, params in published:
        jax.tree.map(np.testing.assert_array_equal, params, res[slot].params)
    with pytest.raises(NotImplementedError, match="A7"):
        tserve.main(["--device", "cpu", "--requests", "2", "--days", "3",
                     "--int8"])


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means CUDA: without a card every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsv.ModelRegistry()
    reg = tsv.ModelRegistry(device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsv.ServingEngine(reg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "2", "--days", "2"])
