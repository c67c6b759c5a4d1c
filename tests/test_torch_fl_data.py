"""The federated training slice's host-side pieces against the JAX package,
on the CPU: the FL configs, partition, sampling, the latency clock, the
privacy accountant (numpy copies: bit-exact, since the numpy ``SeedSequence``
/ ``default_rng`` streams are the same), the losses and metrics (rtol 1e-6)
and the server optimizers (all five rules over three steps, rtol 1e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import server_opt as jsopt  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import losses as tloss  # noqa: E402
from repro_torch.core import privacy as tpriv  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core import server_opt as tsopt  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402

STAGE_CONFIGS = ("SamplingConfig", "ClientOptConfig", "TransformConfig",
                 "SecureAggConfig", "PrivacyConfig", "AggregationConfig",
                 "LatencyConfig", "ChurnConfig", "AsyncConfig",
                 "ServerOptConfig", "FLConfig")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", STAGE_CONFIGS)
def test_config_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jbase, name), getattr(tbase, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert tcls.__dataclass_params__.frozen
    # the default instances agree field by field (nested configs too)
    assert repr(tcls()) == repr(jcls())


def test_config_name_tuples_and_views_match_jax():
    for name in ("SERVER_OPTS", "SAMPLING_STRATEGIES", "AGGREGATORS",
                 "LOSSES", "ASYNC_MODES", "STRAGGLER_DISTRIBUTIONS"):
        assert getattr(tbase, name) == getattr(jbase, name)
    kw = dict(n_clients=7, clients_per_round=5, server_opt="fedyogi",
              server_lr=0.1, sampling="weighted", prox_mu=0.01,
              dp_clip=1.0, dp_noise=0.5, quantize_bits=8, secure_agg=True,
              mode="semi_sync", over_select=1.5, buffer_frac=0.5,
              stragglers="lognormal", absent_prob=0.1, holdout_frac=0.2)
    j, t = jbase.FLConfig(**kw), tbase.FLConfig(**kw)
    assert repr(t) == repr(j)
    for view in ("sampling_config", "client_opt", "transform",
                 "aggregation_config", "async_config", "churn", "secure",
                 "privacy", "server"):
        assert repr(getattr(t, view)) == repr(getattr(j, view))
    assert t.transform.is_identity == j.transform.is_identity
    assert t.churn.faulty == j.churn.faulty


@pytest.mark.parametrize("name,kw", [
    ("FLConfig", dict(server_opt="sgd")),
    ("FLConfig", dict(sampling="random")),
    ("FLConfig", dict(aggregation="ring")),
    ("FLConfig", dict(loss="mae")),
    ("FLConfig", dict(dp_clip=-1.0)),
    ("FLConfig", dict(quantize_bits=9)),
    ("FLConfig", dict(quantize_ring=True)),
    ("FLConfig", dict(mode="async")),
    ("FLConfig", dict(over_select=0.5)),
    ("FLConfig", dict(buffer_k=2, buffer_frac=0.5)),
    ("FLConfig", dict(dropout_prob=0.1)),
    ("FLConfig", dict(stragglers="pareto")),
    ("FLConfig", dict(privacy_delta=1.5)),
    ("FLConfig", dict(secure_mask_std=0.0)),
    ("FLConfig", dict(n_regions=-1)),
    ("ChurnConfig", dict(timeout_rounds=0)),
    ("LatencyConfig", dict(uplink_bytes_per_s=0.0)),
    ("PrivacyConfig", dict(orders=(1, 2))),
])
def test_config_validation_raises_as_jax(name, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jbase, name)(**kw)
    with pytest.raises(ValueError) as terr:
        getattr(tbase, name)(**kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------- partition
def test_partition_is_array_equal():
    rng = lambda s: np.random.default_rng(s)  # noqa: E731
    np.testing.assert_array_equal(tpart.sample_clients(rng(1), 20, 7),
                                  jpart.sample_clients(rng(1), 20, 7))
    for frac in (0.0, 0.25, 0.5):
        for a, b in zip(tpart.holdout_clients(rng(2), 13, frac),
                        jpart.holdout_clients(rng(2), 13, frac)):
            np.testing.assert_array_equal(a, b)
    assign = rng(3).integers(0, 4, 30)
    tp, jp = tpart.cluster_partition(assign), jpart.cluster_partition(assign)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k])
    np.testing.assert_array_equal(
        tpart.sample_minibatch_indices(rng(4), 50, 8, 3),
        jpart.sample_minibatch_indices(rng(4), 50, 8, 3))
    for counts in ([40, 40, 40], [40, 13, 77]):
        np.testing.assert_array_equal(
            tpart.ragged_minibatch_indices(rng(5), counts, 6, 4),
            jpart.ragged_minibatch_indices(rng(5), counts, 6, 4))
    for n, b, e in ((277, 16, 1), (26269, 64, 1), (5, 64, 2)):
        assert tpart.local_steps(n, b, e) == jpart.local_steps(n, b, e)


# ----------------------------------------------------------------- sampling
@pytest.mark.parametrize("strategy", ["uniform", "weighted", "round_robin"])
def test_samplers_are_array_equal(strategy):
    members = np.array([3, 5, 8, 13, 21, 34])
    w = np.array([1.0, 0.0, 4.0, 2.0, 0.0, 3.0])
    ts = tsamp.make_sampler(tbase.SamplingConfig(strategy, seed=4))
    js = jsamp.make_sampler(jbase.SamplingConfig(strategy, seed=4))
    for m in (1, 4, 6, 9):                       # 9 > members: padding
        for r in range(3):
            for weights in (None, w):
                a = ts(np.random.default_rng(r), members, m, r, weights)
                b = js(np.random.default_rng(r), members, m, r, weights)
                np.testing.assert_array_equal(a, b)
                assert len(a) == m


def test_sampler_pad_is_array_equal():
    members = np.arange(10, 20)
    w = np.linspace(0.0, 2.0, 10)
    for sel, m, weights in (([12, 15], 5, None), ([12, 15], 9, w),
                            (list(range(10, 20)), 23, None),
                            ([11], 1, None)):
        a = tsamp._pad(np.random.default_rng(7), np.array(sel), members, m,
                       weights)
        b = jsamp._pad(np.random.default_rng(7), np.array(sel), members, m,
                       weights)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ latency
@pytest.mark.parametrize("dist", ["deterministic", "lognormal", "heavy_tail"])
def test_latency_model_is_array_equal(dist):
    kw = dict(distribution=dist, jitter=0.5)
    churn = dict(dropout_prob=0.2, absent_prob=0.3)
    payload = tlat.payload_bytes(4417, 8)
    assert payload == jlat.payload_bytes(4417, 8)
    assert tlat.payload_bytes(4417) == jlat.payload_bytes(4417)
    t = tlat.LatencyModel(tbase.LatencyConfig(**kw), 3, payload,
                          churn=tbase.ChurnConfig(**churn))
    j = jlat.LatencyModel(jbase.LatencyConfig(**kw), 3, payload,
                          churn=jbase.ChurnConfig(**churn))
    n_win = np.array([26269.0, 4309.0, 277.0, 100.0])
    slots = np.array([4, 0, 7, 2])
    for r in range(3):
        np.testing.assert_array_equal(t.times(r, n_win, 2, slots),
                                      j.times(r, n_win, 2, slots))
        np.testing.assert_array_equal(t.times(r, n_win, 1),
                                      j.times(r, n_win, 1))
        np.testing.assert_array_equal(t.dropouts(r, slots, 1),
                                      j.dropouts(r, slots, 1))
        np.testing.assert_array_equal(t.available(r, slots),
                                      j.available(r, slots))
        np.testing.assert_array_equal(t.reupload_times(r, slots, 2),
                                      j.reupload_times(r, slots, 2))
    assert tlat.link_budget(4417, 10, 3, 8) == jlat.link_budget(4417, 10, 3,
                                                                8)


# ------------------------------------------------------------------ privacy
@pytest.mark.parametrize("clip,noise", [(0.0, 0.0), (1.0, 0.0), (1.0, 1.1)])
def test_accountant_is_equal(clip, noise):
    """The identity stack's disabled accountant (eps = inf, the training
    slice's), and an enabled one over five rounds."""
    tt = tbase.TransformConfig(clip_norm=clip, noise_multiplier=noise)
    jt = jbase.TransformConfig(clip_norm=clip, noise_multiplier=noise)
    ta = tpriv.make_accountant(tt, tbase.PrivacyConfig(), 0.3)
    ja = jpriv.make_accountant(jt, jbase.PrivacyConfig(), 0.3)
    for _ in range(5):
        ta.observe_cohort(4)
        ja.observe_cohort(4)
        ta.step()
        ja.step()
        assert ta.epsilon() == ja.epsilon()
    assert ta.report() == ja.report()
    assert ta.state_dict() == ja.state_dict()
    assert tpriv.format_report(ta.report()) == jpriv.format_report(
        ja.report())
    for order in (2, 8, 64):
        assert tpriv.rdp_sampled_gaussian(0.3, 1.1, order) == \
            jpriv.rdp_sampled_gaussian(0.3, 1.1, order)


# ----------------------------------------------------------- losses, metrics
def _pred_target(seed, shape=(3, 16, 4)):
    r = np.random.default_rng(seed)
    target = (r.random(shape) + 0.5).astype(np.float32)
    pred = (target + 0.1 * r.normal(size=shape)).astype(np.float32)
    target[0, 0, 0], pred[0, 0, 0] = 1e-4, 2e-3  # below MAPE_EPS
    return pred, target


@pytest.mark.parametrize("beta", [1.0, 1.5, 2.0])
def test_losses_match_jax(beta):
    p, y = _pred_target(int(beta * 10))
    tp, ty = torch.from_numpy(p), torch.from_numpy(y)
    np.testing.assert_allclose(
        tloss.horizon_weights(4, beta).numpy(),
        np.asarray(jloss.horizon_weights(4, beta)), rtol=1e-6)
    for name in ("mse", "ew_mse"):
        want = float(jloss.make_loss(name, beta)(jnp.asarray(p),
                                                 jnp.asarray(y)))
        fn = tloss.make_loss(name, beta)
        np.testing.assert_allclose(float(fn(tp, ty)), want, rtol=1e-6)
        # dim=(-2, -1): one loss per client, each the JAX loss of its slice
        per = fn(tp, ty, dim=(-2, -1)).numpy()
        np.testing.assert_allclose(per, [float(jloss.make_loss(name, beta)(
            jnp.asarray(p[m]), jnp.asarray(y[m]))) for m in range(3)],
            rtol=1e-6)
    assert tloss.make_loss("ew_mse", beta) is tloss.make_loss("ew_mse", beta)
    with pytest.raises(ValueError):
        tloss.make_loss("mae")


def test_metrics_match_jax():
    p, y = _pred_target(3)
    tp, ty = torch.from_numpy(p), torch.from_numpy(y)
    jp, jy = jnp.asarray(p), jnp.asarray(y)
    assert tloss.MAPE_EPS == jloss.MAPE_EPS
    # accuracy is 100 - MAPE (in %), so MAPE's rtol 1e-6 is an error of
    # 1e-6 * MAPE <= 1e-4 points in it; the sums run in another order
    for name, atol in (("rmse", 0), ("mape", 0), ("accuracy", 1e-4),
                       ("per_horizon_accuracy", 1e-4)):
        got = getattr(tloss, name)(tp, ty).numpy()
        want = np.asarray(getattr(jloss, name)(jp, jy))
        assert (want > 0).all() and (want < 100).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    # clipped accuracy at both ends
    for scale in (1e-3, 1e3):
        np.testing.assert_allclose(
            tloss.accuracy(ty * scale, ty).numpy(),
            np.asarray(jloss.accuracy(jy * scale, jy)), rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------ server update
def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"layers": [{"wx": f(1, 32), "wh": f(8, 32), "b": f(32)}],
            "head": {"w": f(8, 4), "b": f(4)}}


@pytest.mark.parametrize("kw", [
    dict(name="fedavg"), dict(name="fedavg", lr=0.7),
    dict(name="fedavg_weighted", momentum=0.9, lr=0.5),
    dict(name="fedprox", lr=1.0), dict(name="fedadam", lr=0.05),
    dict(name="fedyogi", lr=0.05, eps=1e-2),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_server_update_matches_jax_over_three_steps(kw):
    tcfg, jcfg = tbase.ServerOptConfig(**kw), jbase.ServerOptConfig(**kw)
    w = _tree(0)
    tw = jax.tree.map(torch.from_numpy, w)
    jw = jax.tree.map(jnp.asarray, w)
    ts, js = tsopt.init_server_state(tw), jsopt.init_server_state(jw)
    for step in range(3):
        agg = jax.tree.map(lambda a, d: a - d, w, _tree(step + 1, 0.1))
        t_agg = jax.tree.map(torch.from_numpy, agg)
        tw, ts = tsopt.server_update(tw, t_agg, ts, tcfg)
        jw, js = jsopt.server_update(jw, jax.tree.map(jnp.asarray, agg), js,
                                     jcfg)
        if kw.get("lr", 1.0) == 1.0 and not kw.get("momentum"):
            assert tw is t_agg                  # exact Alg. 1: w <- w_agg
        # rtol 1e-6 of each leaf's scale: where a moment's update cancels
        # (0.9 m + g near 0), XLA's fused multiply-add and torch's separate
        # rounding differ by an ulp of the terms, not of the result
        for a, b in ((tw, jw), (ts.m, js.m), (ts.v, js.v)):
            jax.tree.map(lambda x, y: np.testing.assert_allclose(
                x.numpy(), np.asarray(y), rtol=1e-6,
                atol=1e-6 * float(np.abs(np.asarray(y)).max())), a, b)
        assert ts.t == int(js.t) == step + 1
        w = jax.tree.map(lambda x: x.numpy(), tw)
    assert tsopt.uses_weighted_aggregation(tcfg) == \
        jsopt.uses_weighted_aggregation(jcfg)
    assert tsopt.SERVER_OPTS == jsopt.SERVER_OPTS
