"""The port's round pacing (``repro_torch/core/async_engine.py``: semi-sync
buffered rounds, client churn with retries and cohort re-keying) and
checkpoint/resume (``core/fedavg.py::run_federated_training``)
against the JAX package, on the CPU.

The event schedule is host numpy in both packages (``core/latency.py`` is
a bit-exact copy), so flush clocks, ``sim_times``, late folds, staleness,
retries, abandoned uploads and re-keys must be EQUAL; losses and params
agree at the repo's tolerances: a semi-sync run against JAX's from the
same initial params, loss rtol 1e-5 and params rtol 1e-4 / atol 1e-5
(``tests/test_pallas_parity.py:43-46``); under DP noise and float masks
(the port's ``normal`` is within 1e-5 of ``jax.random``'s) the training
tolerances of ``tests/test_torch_training.py``, loss rtol 1e-4 and params
rtol 1e-3 / atol 1e-5.  Inside the port: zero-jitter wait-for-all
semi-sync equals sync, ring-masked equals ring-clear under re-key, and a
killed run resumes bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.configs.base import ForecasterConfig as JForecasterConfig  # noqa: E402
from repro.core import async_engine as jasync  # noqa: E402
from repro.core import fedavg as jfed  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import FLConfig, ForecasterConfig  # noqa: E402
from repro_torch.core import async_engine, fedavg  # noqa: E402
from repro_torch.models.layers import sorted_leaves  # noqa: E402

CPU = "cpu"
JCFG, CFG = JForecasterConfig(hidden_dim=8), ForecasterConfig(hidden_dim=8)
SEMI = dict(mode="semi_sync", over_select=1.5, staleness_alpha=0.5,
            stragglers="lognormal", straggler_jitter=1.0)
# the reference's churn workload (tests/test_churn.py:104-106)
CHURN = dict(SEMI, rounds=6, dropout_prob=0.3, timeout_rounds=1)
RESUME = dict(SEMI, rounds=6, n_clusters=2, secure_agg=True,
              server_opt="fedadam", server_lr=0.05, dp_clip=1.0,
              dp_noise=0.5, dropout_prob=0.15, timeout_rounds=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _series():
    return synthetic.generate_buildings("CA", list(range(6)), days=20)


def _kw(**kw):
    base = dict(n_clients=6, clients_per_round=4, rounds=3, n_clusters=0,
                batch_size=16, lr=0.05, loss="ew_mse", seed=0)
    base.update(kw)
    return base


def _inits(seed=0, clusters=(-1, 0, 1)):
    """The reference's per-cluster initial params (fold_in, cid -1 -> 0)."""
    return {c: jax.tree.map(np.asarray, jfc.init_forecaster(
        jax.random.fold_in(jax.random.PRNGKey(seed), max(c, 0)), JCFG))
        for c in clusters}


def _spy(monkeypatch, module):
    """Record every RoundEngine ``module.run_federated_training`` builds,
    and each engine's selections."""
    engines = []
    real = module.RoundEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.selections = []
            engines.append(self)

        def select(self, *a, **kw):
            sel = super().select(*a, **kw)
            self.selections.append(np.asarray(sel).copy())
            return sel

    monkeypatch.setattr(module, "RoundEngine", Spy)
    return engines


def _pair(monkeypatch, series, **kw):
    """The same run in both packages, the port from JAX's initial params;
    returns both results and both engines."""
    jeng, teng = _spy(monkeypatch, jfed), _spy(monkeypatch, fedavg)
    want = jfed.run_federated_training(series, JCFG, JFLConfig(**kw))
    got = fedavg.run_federated_training(series, CFG, FLConfig(**kw),
                                        init_params=_inits(kw["seed"]),
                                        device=CPU)
    return want, got, jeng[-1], teng[-1]


def _leaves(tree):
    return [np.asarray(x) for x in sorted_leaves(tree)]


def _close(got, want, rtol, atol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _same_books(ts, js):
    """Two SemiSyncStates hold the same schedule: clock, counters, and each
    pending update's round, slot, weight, finish time and retries."""
    assert ts.clock == js.clock
    for k in ("late_folds", "max_staleness", "empty_flushes", "rekeys",
              "abandoned"):
        assert getattr(ts, k) == getattr(js, k), k
    assert [(p.dispatch_round, p.slot, p.weight, p.finish_time, p.retries,
             p.retry_round) for p in ts.pending] == \
        [(p.dispatch_round, p.slot, p.weight, p.finish_time, p.retries,
          p.retry_round) for p in js.pending]
    assert ts.cohort_sizes == js.cohort_sizes
    assert ts.cohort_gen == js.cohort_gen
    assert ts.cohort_W0 == js.cohort_W0


def _same_schedule(got, want):
    for c in want:
        np.testing.assert_array_equal(got[c].sim_times, want[c].sim_times)
        np.testing.assert_array_equal(np.isnan(got[c].loss_history),
                                      np.isnan(want[c].loss_history))


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 2.5, 2.4e-152, 1e-300])
def test_staleness_discount_is_the_references_bitwise(alpha):
    tau = np.arange(0, 40)
    got = async_engine.staleness_discount(tau, alpha)
    want = jasync.staleness_discount(tau, alpha)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1.0
    # non-increasing (at a sub-ulp alpha every tau rounds to 1.0)
    assert np.all(np.diff(got) <= 0.0)


def test_ring_wrap_and_stack_padded_match_the_reference():
    x = np.arange(-700, 700, dtype=np.float32)
    for bits in (4, 8):
        np.testing.assert_array_equal(async_engine._ring_wrap_np(x, bits),
                                      jasync._ring_wrap_np(x, bits))
    pend = [async_engine.PendingUpdate(
        delta={"w": np.full(3, float(i), np.float32)}, weight=1.0, loss=0.0,
        dispatch_round=0, finish_time=0.0) for i in range(5)]
    d, w = async_engine._stack_padded(pend, np.arange(5, dtype=np.float32))
    jd, jw = jasync._stack_padded(pend, np.arange(5, dtype=np.float32))
    assert d["w"].shape == (8, 3)
    np.testing.assert_array_equal(d["w"], jd["w"])
    np.testing.assert_array_equal(w, jw)


def _busy_state(module):
    ss = module.SemiSyncState()
    ss.clock, ss.late_folds, ss.max_staleness = 5.25, 3, 2
    ss.empty_flushes, ss.rekeys, ss.abandoned = 1, 2, 4
    for i, r in enumerate((1, 3)):
        ss.pending.append(module.PendingUpdate(
            delta={"head": {"w": np.full((2, 2), i, np.float32)}},
            weight=3.0 + i, loss=0.25, dispatch_round=r,
            finish_time=float("inf") if i else 7.5, slot=i + 2, retries=i,
            retry_round=r + i))
        ss.cohort_sizes[r] = 2 - i
        ss.cohort_w[r] = np.asarray([1.0, 0.0, 2.0], np.float32)
        ss.cohort_gen[r] = i
        ss.cohort_W0[r] = 4.0 + i
    return ss


def test_semi_sync_state_round_trips_and_matches_the_reference():
    ss, js = _busy_state(async_engine), _busy_state(jasync)
    tree, jtree = ss.to_tree(), js.to_tree()
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    back = async_engine.SemiSyncState.from_tree(tree)
    _same_books(back, ss)
    np.testing.assert_array_equal(back.pending[1].delta["head"]["w"],
                                  ss.pending[1].delta["head"]["w"])
    # pre-cohort_W0 checkpoints fall back to the weight vector's sum
    del tree["cohort_W0"]
    assert async_engine.SemiSyncState.from_tree(tree).cohort_W0 == \
        {1: 3.0, 3: 3.0}
    ss.pending.pop(0)
    ss._sweep()
    assert set(ss.cohort_sizes) == {3} and set(ss.cohort_W0) == {3}
    ss.reset()
    assert not ss.pending and ss.clock == 0.0 and not ss.cohort_w


def test_dispatch_size_and_buffer_k_validation_match_the_reference():
    for kw in (dict(), dict(SEMI), dict(SEMI, over_select=2.0)):
        j = jfed.RoundEngine(JCFG, JFLConfig(**_kw(**kw)))
        t = fedavg.RoundEngine(CFG, FLConfig(**_kw(**kw)), device=CPU)
        assert (t.dispatch_m(4), t.dispatch_m(4, 5), t.buffer_k) == \
            (j.dispatch_m(4), j.dispatch_m(4, 5), j.buffer_k)
    with pytest.raises(ValueError, match="exceeds the dispatch size"):
        fedavg.RoundEngine(CFG, FLConfig(**_kw(**SEMI, buffer_k=7)),
                           device=CPU)


# ------------------------------------------------------------- pacing
def test_zero_jitter_wait_for_all_semi_sync_is_sync_bitwise():
    series = _series()
    sync = fedavg.run_federated_training(series, CFG, FLConfig(**_kw()),
                                         device=CPU)[-1]
    semi = fedavg.run_federated_training(
        series, CFG, FLConfig(**_kw(mode="semi_sync")), device=CPU)[-1]
    np.testing.assert_array_equal(semi.loss_history, sync.loss_history)
    np.testing.assert_array_equal(semi.sim_times, sync.sim_times)
    for a, b in zip(_leaves(semi.params), _leaves(sync.params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [dict(buffer_k=4), dict(buffer_frac=0.5),
                                   dict(buffer_k=1, rounds=5)])
def test_lognormal_semi_sync_matches_jax(monkeypatch, extra):
    """over_select 1.5 (m' = 6), flush at the buffer_k-th arrival: the
    event schedule exact, losses and params at the local-update
    tolerances."""
    want, got, je, te = _pair(monkeypatch, _series(), **_kw(**SEMI, **extra))
    _same_schedule(got, want)
    _same_books(te.async_state, je.async_state)
    assert te.async_state.late_folds > 0
    np.testing.assert_allclose(got[-1].loss_history, want[-1].loss_history,
                               rtol=1e-5)
    _close(got[-1].params, want[-1].params, rtol=1e-4, atol=1e-5)


def test_dropout_retries_and_abandons_as_jax(monkeypatch):
    """The reference's churn workload: lost uploads retried after one
    round and abandoned past max_retries, on the same schedule."""
    want, got, je, te = _pair(monkeypatch, _series(),
                              **_kw(**CHURN, buffer_k=4))
    _same_schedule(got, want)
    _same_books(te.async_state, je.async_state)
    assert te.async_state.abandoned > 0 or any(
        p.retries for p in te.async_state.pending)
    np.testing.assert_allclose(got[-1].loss_history, want[-1].loss_history,
                               rtol=1e-5)
    _close(got[-1].params, want[-1].params, rtol=1e-4, atol=1e-5)


def test_absent_members_are_excluded_as_jax_does(monkeypatch):
    want, got, je, te = _pair(
        monkeypatch, _series(),
        **_kw(mode="semi_sync", absent_prob=0.4, rounds=4,
              stragglers="lognormal", straggler_jitter=1.0, buffer_k=4))
    assert len(te.selections) == len(je.selections) == 4
    for t, (a, b) in enumerate(zip(te.selections, je.selections)):
        np.testing.assert_array_equal(a, b)
        avail = te.latency.available(t, np.arange(6))
        assert avail[a].all()                     # nobody absent selected
    assert any(len(s) < 4 for s in te.selections)  # absence shrank one
    _same_schedule(got, want)
    np.testing.assert_allclose(got[-1].loss_history, want[-1].loss_history,
                               rtol=1e-5)


def test_ring_masked_equals_clear_under_rekey(monkeypatch):
    """quantize 8 + masking under churn: the re-key's mask correction runs
    in the ring (``delta - old + new`` wrapped), so the masked run equals
    the ring-clear cohort-atomic run bit for bit, re-keys included; and
    its schedule is the reference's."""
    series = _series()
    ring = dict(CHURN, quantize_bits=8, dp_clip=1.0)
    engines = _spy(monkeypatch, fedavg)
    clear = fedavg.run_federated_training(
        series, CFG, FLConfig(**_kw(**ring, quantize_ring=True,
                                    cohort_atomic=True)), device=CPU)[-1]
    masked = fedavg.run_federated_training(
        series, CFG, FLConfig(**_kw(**ring, secure_agg=True)),
        device=CPU)[-1]
    assert engines[-1].async_state.rekeys > 0
    np.testing.assert_array_equal(clear.sim_times, masked.sim_times)
    np.testing.assert_array_equal(clear.loss_history, masked.loss_history)
    assert np.isfinite(masked.loss_history).any()
    for a, b in zip(_leaves(clear.params), _leaves(masked.params)):
        np.testing.assert_array_equal(a, b)
    want = jfed.run_federated_training(
        series, JCFG, JFLConfig(**_kw(**ring, secure_agg=True)))[-1]
    np.testing.assert_array_equal(masked.sim_times, want.sim_times)
    assert engines[-1].accountant.report() == pytest.approx(
        want.privacy, rel=1e-9)


def _timeout_engines(**kw):
    kw = _kw(**CHURN, quantize_bits=8, dp_clip=1.0, secure_agg=True, **kw)
    return (jfed.RoundEngine(JCFG, JFLConfig(**kw)),
            fedavg.RoundEngine(CFG, FLConfig(**kw), device=CPU))


def _overdue_cohort(module, rng):
    """Round 2's cohort of 5 ring uploads, 3 arrived and 2 in flight past
    the timeout (one dropped), at clock 10."""
    ss = module.SemiSyncState()
    ss.clock = 10.0
    w = np.asarray([3.0, 1.0, 0.0, 2.0, 5.0, 4.0], np.float32)
    for slot, ft in ((0, 4.0), (1, 11.0), (3, 9.5), (4, float("inf")),
                     (5, 2.0)):
        d = {"layers": [{k: rng.integers(-100, 100, s).astype(np.float32)
                         for k, s in (("b", (32,)), ("wh", (8, 32)),
                                      ("wx", (1, 32)))}],
             "head": {"w": rng.integers(-100, 100, (8, 4)).astype(
                 np.float32), "b": rng.integers(-9, 9, (4,)).astype(
                     np.float32)}}
        ss.pending.append(module.PendingUpdate(
            delta=d, weight=float(w[slot]), loss=0.1, dispatch_round=2,
            finish_time=ft, slot=slot, retry_round=2))
    ss.cohort_sizes[2], ss.cohort_w[2] = 5, w
    ss.cohort_gen[2], ss.cohort_W0[2] = 0, float(w.sum())
    return ss


@pytest.mark.parametrize("bits", [0, 8])
def test_mask_contribution_of_many_slots_is_each_slots(bits):
    """The re-key draws a cohort's masks once for all its survivors: the
    stacked terms equal one call per slot bit for bit."""
    from repro_torch.core import prng, secure_agg
    masker = secure_agg.PairwiseMasker(mask_std=2.0, bits=bits)
    like = {"w": torch.zeros(3, 5), "b": torch.zeros(4)}
    w = torch.tensor([2.0, 0.0, 1.0, 5.0, 3.0])
    many = secure_agg.mask_contribution(masker, like, [4, 0, 3], w,
                                        prng.PRNGKey(9))
    for j, slot in enumerate((4, 0, 3)):
        one = secure_agg.mask_contribution(masker, like, slot, w,
                                           prng.PRNGKey(9))
        for k in like:
            assert torch.equal(many[k][j], one[k])
    assert float(many["w"].abs().max()) > 0


@pytest.mark.parametrize("stream", [0, 3])
def test_handle_timeouts_rekeys_bit_equal_to_the_reference(stream):
    """The same numpy buffer in both packages: the same survivors, the
    same re-masked ring deltas bit for bit, the same re-upload clock."""
    je, te = _timeout_engines()
    je.async_state = _overdue_cohort(jasync, np.random.default_rng(5))
    te.async_state = _overdue_cohort(async_engine, np.random.default_rng(5))
    before = [p.delta for p in te.async_state.pending]
    jasync._handle_timeouts(je, 4, stream)
    async_engine._handle_timeouts(te, 4, stream)
    _same_books(te.async_state, je.async_state)
    assert te.async_state.rekeys == 1 and te.async_state.abandoned == 2
    assert te.async_state.cohort_w[2][[1, 4]].tolist() == [0.0, 0.0]
    for tp, jp in zip(te.async_state.pending, je.async_state.pending):
        for a, b in zip(_leaves(tp.delta), _leaves(jp.delta)):
            np.testing.assert_array_equal(a, b)
            assert a.min() >= -128 and a.max() < 128
    assert not np.array_equal(_leaves(te.async_state.pending[0].delta)[0],
                              _leaves(before[0])[0])


def test_handle_timeouts_retries_plain_semi_sync_as_the_reference():
    kw = _kw(**CHURN)
    je = jfed.RoundEngine(JCFG, JFLConfig(**kw))
    te = fedavg.RoundEngine(CFG, FLConfig(**kw), device=CPU)
    je.async_state = _overdue_cohort(jasync, np.random.default_rng(1))
    te.async_state = _overdue_cohort(async_engine, np.random.default_rng(1))
    for t in (4, 5, 6):
        jasync._handle_timeouts(je, t, 0)
        async_engine._handle_timeouts(te, t, 0)
        _same_books(te.async_state, je.async_state)
    # retried once each, then abandoned (max_retries 1)
    assert te.async_state.abandoned == 2 and te.async_state.pending


# ------------------------------------------------------- checkpoint/resume
@pytest.mark.parametrize("extra", [dict(), dict(quantize_bits=8)])
def test_kill_and_resume_is_bit_identical(tmp_path, extra):
    """Killed mid-cluster (in-flight masked uploads, Adam moments, a live
    accountant, a churned clock; with ``quantize_bits`` the ring wire and
    its cohort_W0), resumed from the checkpoint: losses, event times, eps
    history, params and the privacy report equal the uninterrupted run."""
    series, flcfg = _series(), FLConfig(**_kw(**RESUME, **extra))
    full = fedavg.run_federated_training(series, CFG, flcfg, device=CPU)
    ck = tmp_path / "resume_ck"
    part = fedavg.run_federated_training(series, CFG, flcfg, device=CPU,
                                         checkpoint_path=ck,
                                         stop_after_rounds=8)
    assert len(part) < len(full) or any(
        len(part[c].loss_history) < flcfg.rounds for c in part)
    assert checkpoint.generation(ck) == 8
    resumed = fedavg.run_federated_training(series, CFG, flcfg, device=CPU,
                                            checkpoint_path=ck)
    assert sorted(resumed) == sorted(full)
    for cid in full:
        for k in ("loss_history", "sim_times", "eps_history"):
            np.testing.assert_array_equal(getattr(resumed[cid], k),
                                          getattr(full[cid], k))
        for a, b in zip(_leaves(resumed[cid].params),
                        _leaves(full[cid].params)):
            np.testing.assert_array_equal(a, b)
        assert resumed[cid].privacy == full[cid].privacy


def test_a_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains the churned, masked, clustered run and is killed after 3
    rounds; the port resumes its checkpoint (the configs are copies, so
    ``repr(FLConfig)`` agrees) and finishes the run: the schedule equals
    JAX's uninterrupted run, losses and params at the training
    tolerances."""
    series = _series()
    kw = _kw(**RESUME)
    assert repr(FLConfig(**kw)) == repr(JFLConfig(**kw))
    want = jfed.run_federated_training(series, JCFG, JFLConfig(**kw))
    ck = tmp_path / "jax_ck"
    jfed.run_federated_training(series, JCFG, JFLConfig(**kw),
                                checkpoint_path=ck, stop_after_rounds=3)
    meta = checkpoint.metadata(ck)
    assert meta["rounds_done"] == 3 and meta["generation"] == 3
    got = fedavg.run_federated_training(series, CFG, FLConfig(**kw),
                                        checkpoint_path=ck,
                                        init_params=_inits(), device=CPU)
    assert sorted(got) == sorted(want)
    _same_schedule(got, want)
    for c in want:
        fin = np.isfinite(want[c].loss_history)
        np.testing.assert_allclose(got[c].loss_history[fin],
                                   want[c].loss_history[fin], rtol=1e-4)
        np.testing.assert_allclose(got[c].eps_history, want[c].eps_history,
                                   rtol=1e-9)
        _close(got[c].params, want[c].params, rtol=1e-3, atol=1e-5)
    first = min(want)
    np.testing.assert_array_equal(got[first].loss_history[:3],
                                  want[first].loss_history[:3])


def test_port_checkpoint_is_the_references_format(tmp_path):
    """The port's checkpoint of a killed semi-sync run holds the keys and
    metadata the JAX package writes for the same run."""
    series, kw = _series(), _kw(**CHURN, buffer_k=4)
    jck, tck = tmp_path / "j", tmp_path / "t"
    jfed.run_federated_training(series, JCFG, JFLConfig(**kw),
                                checkpoint_path=jck, stop_after_rounds=4)
    fedavg.run_federated_training(series, CFG, FLConfig(**kw),
                                  checkpoint_path=tck, stop_after_rounds=4,
                                  init_params=_inits(), device=CPU)
    (jf, jm), (tf, tm) = (checkpoint.load_arrays(p) for p in (jck, tck))
    assert sorted(tf) == sorted(jf)
    for k in tf:
        assert tf[k].dtype == jf[k].dtype, k
    assert set(tm) == set(jm)
    for k in ("flcfg", "cluster", "rounds_done", "generation", "done", "rng",
              "accountant", "n_pending"):
        assert tm[k] == jm[k], k
    for k in ("cur/sim", "cur/async/clock", "cur/async/counters",
              "cur/async/cohort_rounds", "cur/async/cohort_sizes"):
        np.testing.assert_array_equal(tf[k].numpy(), jf[k].numpy())


def test_resume_rejects_config_mismatch(tmp_path):
    series = _series()
    ck = tmp_path / "ck"
    fedavg.run_federated_training(series, CFG,
                                  FLConfig(**_kw(mode="semi_sync", rounds=2)),
                                  checkpoint_path=ck, stop_after_rounds=1,
                                  device=CPU)
    with pytest.raises(ValueError, match="different"):
        fedavg.run_federated_training(
            series, CFG, FLConfig(**_kw(mode="semi_sync", rounds=2,
                                        lr=0.01)),
            checkpoint_path=ck, device=CPU)
    # resume=False starts over and overwrites the checkpoint
    fedavg.run_federated_training(
        series, CFG, FLConfig(**_kw(mode="semi_sync", rounds=2, lr=0.01)),
        checkpoint_path=ck, resume=False, device=CPU)
    assert checkpoint.metadata(ck)["rounds_done"] == 2
