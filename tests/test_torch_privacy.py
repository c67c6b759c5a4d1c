"""The port's privacy pipeline (``repro_torch/core/{transforms,secure_agg,
fedavg}.py``) against the JAX package on the CPU.

Inputs are made with numpy from a seed; JAX makes the initial params and
they cross as numpy arrays.  The PRNG replays ``jax.random`` bit for bit
(``tests/test_torch_prng.py``), so the port draws the reference's noise,
rounding and masks from the same keys.  Tolerances:

* ``L2Clip``: rtol 1e-6 (the norm's sum order differs);
* ``GaussianNoise``: the ``normal`` bound, 5e-5 * sigma absolute;
* adaptive and ring ``StochasticQuantize``, ring masks: bit-equal;
* float masks: rtol 1e-5 / atol 1e-5 * mask_std (the normal bound, and
  the order in which each client's pair masks are summed);
* rounds through ``RoundEngine.step`` against a live JAX
  ``RoundEngine.step`` (clip + noise, float masking), 2 rounds: the
  local-update tolerances, loss rtol 1e-5, params rtol 1e-4 / atol 1e-5;
* the transform -> aggregate stage of quantizing stacks, fed the
  reference's own local models: bit-equal to the reference's stage run op
  by op (under ``jax.jit`` XLA multiplies by a constant's reciprocal where
  the source divides, which can move one rounding; the port divides);
  adaptive quantization after DP noise: within one grid step, since the
  noise sets the max-abs scale;
* epsilon: rel 1e-9.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.configs.base import ForecasterConfig as JForecasterConfig  # noqa: E402
from repro.configs.base import SecureAggConfig as JSecureAggConfig  # noqa: E402
from repro.configs.base import TransformConfig as JTransformConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import fedavg as jfed  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.core import secure_agg as jsa  # noqa: E402
from repro.core import server_opt as jso  # noqa: E402
from repro.core import transforms as jtr  # noqa: E402
from repro.core.client import local_update as jlocal_update  # noqa: E402
from repro.data import synthetic, windows  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch.configs.base import (FLConfig, ForecasterConfig,  # noqa: E402
                                      SecureAggConfig, TransformConfig)
from repro_torch.core import fedavg, losses, prng  # noqa: E402
from repro_torch.core import secure_agg as tsa  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.models.layers import (sorted_leaves,  # noqa: E402
                                       tree_from_numpy)

CPU = "cpu"
JCFG, CFG = JForecasterConfig(hidden_dim=8), ForecasterConfig(hidden_dim=8)
RK = 7                                   # round-key seed of the stage tests


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """Numpy leaves in ``jax.tree.flatten``'s order, from either package."""
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in sorted_leaves(tree)]


def _equal(got, want):
    for g, w in zip(_leaves(got), _leaves(_np(want))):
        np.testing.assert_array_equal(g, w)


def _close(got, want, rtol, atol):
    for g, w in zip(_leaves(got), _leaves(_np(want))):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _deltas(seed, m, scale=1.0, integer=False):
    """A client-stacked delta tree in both packages."""
    r = np.random.default_rng(seed)
    d = {"wx": r.normal(size=(m, 4, 3)) * scale,
         "b": r.normal(size=(m, 5)) * scale}
    if integer:
        d = {k: np.round(v) for k, v in d.items()}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    return jax.tree.map(jnp.asarray, d), tree_from_numpy(d)


def _keys(m, seed=RK):
    """Per-client keys fold_in(PRNGKey(seed), slot) in both packages."""
    return (jax.vmap(jax.random.fold_in, (None, 0))(
                jax.random.PRNGKey(seed), jnp.arange(m)),
            prng.fold_in(prng.PRNGKey(seed), torch.arange(m)))


def _cohort(w):
    w = np.asarray(w, np.float32)
    return jnp.asarray(w), torch.from_numpy(w)


def _both_stacks(**kw):
    """The stack of one config in both packages."""
    sec = kw.pop("secure", None)
    return (jtr.make_stack(JTransformConfig(**kw),
                           None if sec is None else JSecureAggConfig(**sec)),
            ttr.make_stack(TransformConfig(**kw),
                           None if sec is None else SecureAggConfig(**sec)))


def _apply(stacks, deltas, w, m):
    """Both stacks on the same deltas, keys, cohort and round key."""
    (js, ts), (jd, td), (jw, tw), (jk, tk) = stacks, deltas, _cohort(w), \
        _keys(m)
    jrk, trk = jax.random.PRNGKey(RK + 1), prng.PRNGKey(RK + 1)
    want = jfed.apply_stack(js, jd, jk, w_full=jw, round_key=jrk)
    got = fedavg.apply_stack(ts, td, tk, w_full=tw, round_key=trk)
    return got, want


# ------------------------------------------------------------ the stack
def test_ring_helpers_match_jax():
    assert ttr.RING_NOISE_TAIL_SIGMAS == jtr.RING_NOISE_TAIL_SIGMAS
    for bits, cohort, head in ((8, 100, 2.0), (8, 3, 0.0), (6, 10, 4.0),
                               (4, 2, 0.0)):
        assert ttr.ring_levels(bits, cohort, head) == \
            jtr.ring_levels(bits, cohort, head)
        assert ttr.ring_scale(bits, 0.7, cohort, head) == \
            jtr.ring_scale(bits, 0.7, cohort, head)
    assert ttr.ring_levels(8, 100, 2.0) == 9         # the phase-7 ring
    with pytest.raises(ValueError, match="ring"):
        ttr.ring_levels(4, 10, 0.0)
    x = np.arange(-700, 700, dtype=np.float32)
    for bits in (4, 8):
        np.testing.assert_array_equal(
            ttr.ring_wrap(torch.from_numpy(x), bits).numpy(),
            np.asarray(jtr.ring_wrap(jnp.asarray(x), bits)))


@pytest.mark.parametrize("kw", [
    dict(), dict(clip_norm=1.0), dict(clip_norm=1.0, noise_multiplier=0.5),
    dict(noise_multiplier=0.5), dict(quantize_bits=8),
    dict(quantize_bits=6, quantize_ring=True),
    dict(clip_norm=1.0, noise_multiplier=0.5, quantize_bits=8,
         secure=dict(enabled=True)),
    dict(clip_norm=2.0, secure=dict(enabled=True, mask_std=3.0)),
])
def test_make_stack_matches_jax(kw):
    js, ts = _both_stacks(**kw)
    assert [(type(t).__name__, t.tag, getattr(t, "__dict__", {}))
            for t in ts.transforms] == \
        [(type(t).__name__, t.tag, getattr(t, "__dict__", {}))
         for t in js.transforms]
    for prop in ("is_identity", "needs_cohort", "ring_spec", "pre_weighted"):
        assert getattr(ts, prop) == getattr(js, prop), prop


@pytest.mark.parametrize("kind", ["clip", "noise", "quantize", "ring"])
def test_each_transform_matches_jax(kind):
    m = 5
    jd, td = _deltas(3, m, scale=0.4)
    for k in td:                       # one client inside the clip ball
        td[k][1] *= 1e-3
        jd = dict(jd, **{k: jd[k].at[1].multiply(1e-3)})
    td["wx"][4] = 0.0                  # an all-zero leaf quantizes to zero
    jd = dict(jd, wx=jd["wx"].at[4].set(0.0))
    w = [3.0, 1.0, 0.0, 7.0, 2.0]
    if kind == "clip":
        stacks = _both_stacks(clip_norm=0.5)
    elif kind == "noise":
        stacks = _both_stacks(noise_multiplier=0.7)
    elif kind == "quantize":
        stacks = _both_stacks(quantize_bits=8)
    else:
        stacks = (jtr.TransformStack((jtr.StochasticQuantize(
                      6, ring=True, sensitivity=0.5, noise_headroom=2.0),)),
                  ttr.TransformStack((ttr.StochasticQuantize(
                      6, ring=True, sensitivity=0.5, noise_headroom=2.0),)))
    got, want = _apply(stacks, (jd, td), w, m)
    if kind == "clip":
        _close(got, want, rtol=1e-6, atol=0)
        norms = ttr.global_l2_norm(got).numpy()
        assert norms.max() <= 0.5 * (1 + 1e-6) and norms[1] < 0.5
    elif kind == "noise":
        _close(got, want, rtol=1e-6, atol=0.7 * 5e-5)
    else:
        _equal(got, want)
    if kind == "ring":                 # integers, each within its cap
        for g in _leaves(got):
            np.testing.assert_array_equal(g, np.round(g))
        assert np.all(_leaves(got)[0][2] == 0)       # weight 0: no share


def test_stack_streams_by_tag_and_occurrence():
    """A repeated stage draws from fold_in(fold_in(key, tag), occurrence):
    two quantizers in a row, then the same with clipping in front (a
    stage without randomness shifts no stream)."""
    m = 3
    jd, td = _deltas(4, m, scale=0.2)
    for extra in ((), (0.3,)):
        js = jtr.TransformStack(tuple(jtr.L2Clip(c) for c in extra) + (
            jtr.StochasticQuantize(8), jtr.StochasticQuantize(4)))
        ts = ttr.TransformStack(tuple(ttr.L2Clip(c) for c in extra) + (
            ttr.StochasticQuantize(8), ttr.StochasticQuantize(4)))
        got, want = _apply((js, ts), (jd, td), [1.0] * m, m)
        if extra:
            _close(got, want, rtol=1e-6, atol=0)
        else:
            _equal(got, want)


def test_cohort_stack_requires_context():
    _, ts = _both_stacks(secure=dict(enabled=True))
    _, td = _deltas(0, 2)
    _, tk = _keys(2)
    with pytest.raises(ValueError, match="cohort"):
        ts(td, tk)
    with pytest.raises(ValueError, match="round_key"):
        fedavg.apply_stack(ts, td, tk, w_full=torch.ones(2))


# ----------------------------------------------------------- the masker
def test_ring_masks_are_the_references_bit_for_bit():
    m = 6
    w = [3.0, 1.0, 0.0, 7.0, 2.0, 0.0]          # two weight-0 pads
    deltas = _deltas(5, m, scale=20.0, integer=True)
    masker = (jtr.TransformStack((jsa.PairwiseMasker(bits=8),)),
              ttr.TransformStack((tsa.PairwiseMasker(bits=8),)))
    got, want = _apply(masker, deltas, w, m)
    _equal(got, want)
    for g in _leaves(got):
        np.testing.assert_array_equal(g[[2, 5]], 0.0)   # pads upload zero
        assert g.min() >= -128 and g.max() < 128


def test_float_masks_within_their_bound():
    m = 6
    w = [3.0, 1.0, 0.0, 7.0, 2.0, 5.0]
    got, want = _apply(_both_stacks(secure=dict(enabled=True, mask_std=4.0)),
                       _deltas(6, m), w, m)
    _close(got, want, rtol=1e-5, atol=4.0 * 1e-5)


def test_masks_cancel_and_pads_upload_zero():
    """The reference's own invariants, inside the port: each upload is the
    weighted contribution under a full-strength mask whatever its weight,
    pads upload zero, and the unweighted sum of uploads is the clear
    weighted sum (float tolerance on the float path)."""
    m = 6
    _, td = _deltas(0, m)
    w = torch.tensor([3.0, 1.0, 0.0, 7.0, 2.0, 0.0])
    _, ts = _both_stacks(secure=dict(enabled=True, mask_std=4.0))
    masked = fedavg.apply_stack(ts, td, torch.zeros((m, 2), dtype=torch.int64),
                                w_full=w, round_key=prng.PRNGKey(7))
    rows = []
    for k in td:
        wk = w.reshape((-1,) + (1,) * (td[k].dim() - 1))
        rows.append((masked[k] - wk * td[k]).reshape(m, -1))
        assert torch.equal(masked[k][[2, 5]], torch.zeros_like(masked[k][:2]))
    rms = torch.cat(rows, 1)[[0, 1, 3, 4]].square().mean(1).sqrt()
    sigma = 4.0 * math.sqrt(3.0)                 # 3 real partners each
    assert bool(((rms > 0.6 * sigma) & (rms < 1.6 * sigma)).all())
    sums_c, _ = fedavg._weighted_sums(td, w)
    for k in td:
        torch.testing.assert_close(masked[k].sum(0), sums_c[k], rtol=1e-4,
                                   atol=1e-4)


def test_pair_masks_are_antisymmetric_and_replayable():
    masker = tsa.PairwiseMasker(mask_std=3.0)
    zero = {"w": torch.zeros((2, 4, 4)), "b": torch.zeros((2, 2))}
    ctx = tsa.CohortContext(torch.arange(2), torch.ones(2), prng.PRNGKey(3))
    out = masker(zero, None, ctx)
    for k in zero:
        torch.testing.assert_close(out[k][0], -out[k][1], rtol=1e-6,
                                   atol=1e-7)
    assert float(out["w"].abs().max()) > 1.0
    again = masker(zero, None, ctx)
    assert all(torch.equal(out[k], again[k]) for k in zero)
    other = masker(zero, None, ctx._replace(round_key=prng.PRNGKey(4)))
    assert not torch.equal(out["w"], other["w"])


@pytest.mark.parametrize("bits", [0, 8])
def test_mask_contribution_replays_the_mask_exactly(bits):
    """``mask_contribution`` replays a slot's mask bit for bit; on the ring
    it is the reference's, and subtracting it (in the ring) recovers the
    clear integers."""
    m = 4
    w = [2.0, 0.0, 1.0, 5.0]
    masker = tsa.PairwiseMasker(mask_std=2.0, bits=bits)
    _, td = _deltas(8, m, scale=9.0, integer=True)
    ctx = tsa.CohortContext(torch.arange(m), torch.tensor(w),
                            prng.PRNGKey(11))
    up = masker(td, None, ctx)
    zero = masker({k: torch.zeros_like(v) for k, v in td.items()}, None, ctx)
    like = {k: v[0] for k, v in td.items()}
    for slot in range(m):
        mc = tsa.mask_contribution(masker, like, slot, w, prng.PRNGKey(11))
        for k in td:
            assert torch.equal(mc[k], zero[k][slot])
            if bits and w[slot] > 0:
                assert torch.equal(ttr.ring_wrap(up[k][slot] - mc[k], bits),
                                   td[k][slot])
    if bits:
        jmasker = jsa.PairwiseMasker(mask_std=2.0, bits=bits)
        jlike = {k: jnp.asarray(v.numpy()) for k, v in like.items()}
        for slot in range(m):
            _equal(tsa.mask_contribution(masker, like, slot, w,
                                         prng.PRNGKey(11)),
                   jsa.mask_contribution(jmasker, jlike, slot,
                                         jnp.asarray(w),
                                         jax.random.PRNGKey(11)))


def test_a_masked_upload_is_uniform_over_the_ring():
    n = 1 << 15
    masker = tsa.PairwiseMasker(bits=8)
    q = {"w": torch.full((1, n), 37.0)}          # a constant secret
    ctx = tsa.CohortContext(torch.tensor([0]), torch.ones(2),
                            prng.PRNGKey(123))
    v = masker(q, None, ctx)["w"][0].numpy()
    assert v.min() >= -128 and v.max() < 128
    counts = np.bincount(v.astype(np.int64) + 128, minlength=256)
    assert counts.min() > 0.5 * n / 256 and counts.max() < 2.0 * n / 256
    assert counts.std() / (n / 256) < 0.2


# -------------------------------------------------------------- rounds
@pytest.fixture(scope="module")
def fl_data():
    """4 CA clients x 12 days, 3 local steps of 16; JAX-made params."""
    series = synthetic.generate_buildings("CA", list(range(4)), days=12)
    data = windows.batched_client_windows(series, JCFG.lookback,
                                          JCFG.horizon)
    bidx = np.random.default_rng(0).integers(
        0, data["x_train"].shape[1], size=(4, 3, 16))
    params = jfc.init_forecaster(jax.random.PRNGKey(0), JCFG)
    return params, data["x_train"], data["y_train"], bidx


def _engines(kw):
    kw = dict(kw, loss="mse", lr=0.05, seed=3)
    return (jfed.RoundEngine(JCFG, JFLConfig(**kw),
                             loss=jloss.make_loss("mse")),
            fedavg.RoundEngine(CFG, FLConfig(**kw),
                               loss=losses.make_loss("mse"), device=CPU))


def test_round_keys_match_jax():
    je, te = _engines(dict(dp_clip=1.0, dp_noise=0.5, secure_agg=True,
                           quantize_bits=8))
    for t, stream in ((0, 0), (3, 2)):
        assert te.base_round_key(t, stream) == tuple(
            np.asarray(je.base_round_key(t, stream)).tolist())
        np.testing.assert_array_equal(te.round_keys(t, 5, stream).numpy(),
                                      np.asarray(je.round_keys(t, 5, stream)))
        for g in (0, 2):
            assert te.rekey_key(t, stream, g) == tuple(
                np.asarray(je.rekey_key(t, stream, g)).tolist())


COUNTS = np.asarray([17.0, 5.0, 29.0, 11.0], np.float32)


@pytest.mark.parametrize("kw", [
    dict(dp_clip=1.0, dp_noise=0.5),
    dict(dp_clip=1.0, dp_noise=0.5, secure_agg=True, secure_mask_std=2.0),
    dict(dp_clip=0.5, secure_agg=True, server_opt="fedavg_weighted"),
])
def test_rounds_match_a_live_jax_round_engine(fl_data, kw):
    params, x, y, bidx = fl_data
    je, te = _engines(kw)
    jp, js = params, jso.init_server_state(params)
    tp, ts = te.init(params=_np(params))
    for t in range(2):
        jp, js, jl = je.step(jp, js, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(bidx), COUNTS, round_idx=t,
                             stream=1)
        tp, ts, tl = te.step(tp, ts, x, y, bidx, COUNTS, round_idx=t,
                             stream=1)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _close(tp, jp, rtol=1e-4, atol=1e-5)


def test_ring_masked_round_equals_clear_bitwise(fl_data):
    """The reference's tentpole pin, in the port: a ring-masked round
    equals the ring-clear round bit for bit, while the uploads themselves
    are ring noise."""
    params, x, y, bidx = fl_data
    kw = dict(dp_clip=1.0, dp_noise=0.5, quantize_bits=8)
    _, e_clear = _engines(dict(kw, quantize_ring=True))
    _, e_mask = _engines(dict(kw, secure_agg=True))
    w = np.asarray([17.0, 0.0, 29.0, 11.0], np.float32)      # one pad
    outs = []
    for e in (e_clear, e_mask):
        p, s = e.init(params=_np(params))
        p, s, l = e.step(p, s, x, y, bidx, w, round_idx=1, stream=2)
        outs.append((p, l))
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(sorted_leaves(outs[0][0]), sorted_leaves(outs[1][0])):
        assert torch.equal(a, b)
    d = tree_from_numpy({"w": np.random.default_rng(1).normal(
        size=(4, 50)).astype(np.float32) * 0.05})
    keys = e_mask.round_keys(1, 4, 2)
    ctx = dict(w_full=(torch.from_numpy(w) > 0).float(),
               round_key=e_mask.base_round_key(1, 2))
    clear = fedavg.apply_stack(e_clear.stack, d, keys, **ctx)["w"]
    masked = fedavg.apply_stack(e_mask.stack, d, keys, **ctx)["w"]
    assert float((masked - clear).abs().max()) > 8.0
    assert torch.equal(masked, masked.round())
    assert torch.equal(ttr.ring_wrap(masked.sum(0), 8),
                       ttr.ring_wrap(clear.sum(0), 8))


def _reference_stage(monkeypatch, je, params, locals_, client_loss, w,
                     keys, rk):
    """The reference's transform -> aggregate stage, op by op, fed the
    given local models: ``_pipeline_body`` with its local update replaced
    by one that hands each client its local model back."""
    monkeypatch.setattr(jfed, "local_update",
                        lambda p, lx, ly, *a: (lx, ly))
    return jfed._pipeline_body(
        params, locals_, client_loss, None, w, keys, jnp.float32(0.05),
        jnp.float32(0.0), cfg=JCFG, loss=je.loss, cell_impl="jnp",
        tcfg=je.transform, agg=jagg.LocalAggregator(), scfg=je.secure,
        round_key=rk)


@pytest.mark.parametrize("kw", [
    dict(quantize_bits=8),
    dict(dp_clip=0.05, quantize_bits=8, quantize_ring=True),
    dict(dp_clip=1.0, dp_noise=0.5, quantize_bits=8, secure_agg=True),
    dict(quantize_bits=6, secure_agg=True, server_opt="fedavg_weighted"),
    dict(dp_clip=1.0, dp_noise=0.5, quantize_bits=8),
])
def test_quantizing_stage_on_the_references_local_models(fl_data,
                                                        monkeypatch, kw):
    params, x, y, bidx = fl_data
    je, te = _engines(kw)
    jlocals, jcl = jax.vmap(jlocal_update, in_axes=(
        None, 0, 0, 0, None, None, None, None, None))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(bidx),
        jnp.float32(0.05), JCFG, je.loss, "jnp", jnp.float32(0.0))
    w = COUNTS.copy()
    w[1] = 0.0                                          # a pad
    w = w if te.weighted else (w > 0).astype(np.float32)
    want, wl = _reference_stage(monkeypatch, je, params, jlocals, jcl,
                                jnp.asarray(w), je.round_keys(1, 4, 2),
                                je.base_round_key(1, 2))
    got, gl = fedavg.transform_and_aggregate(
        tree_from_numpy(_np(params)), tree_from_numpy(_np(jlocals)),
        torch.from_numpy(np.array(jcl)), torch.from_numpy(w),
        te.round_keys(1, 4, 2), te.stack, te.base_round_key(1, 2))
    assert float(gl) == float(wl)
    if kw.get("dp_noise") and not te.stack.ring_spec:
        # the noise sets each leaf's max-abs scale, so a scale may differ in
        # its last bit and a rounding may flip: one grid step of the leaf
        tl = tree_from_numpy(_np(jlocals))
        deltas = ttr.TransformStack(te.stack.transforms[:-1])(
            jax.tree.map(lambda a, b: a - b, tl,
                         tree_from_numpy(_np(params))),
            te.round_keys(1, 4, 2))
        for g, v, d in zip(_leaves(got), _leaves(_np(want)),
                           sorted_leaves(deltas)):
            step = float(d.abs().max()) / 127.0
            assert np.abs(g - v).max() <= step
        return
    _equal(got, want)


# ------------------------------------------------------------ accounting
@pytest.mark.parametrize("kw,mode", [
    (dict(dp_clip=1.0, dp_noise=0.8), "per-client"),
    (dict(dp_clip=1.0, dp_noise=0.8, quantize_bits=8, secure_agg=True),
     "central:secure-agg"),
    (dict(dp_clip=1.0, dp_noise=0.8, secure_agg=True), "per-client"),
    (dict(dp_clip=1.0, dp_noise=0.8, quantize_bits=8, secure_agg=True,
          server_opt="fedavg_weighted"), "per-client"),
])
def test_accountant_matches_jax(kw, mode):
    je, te = _engines(kw)
    for e in (je, te):
        e.attach_accountant(20, 6)
        for n in (6, 6, 5):
            e.accountant.observe_cohort(n)
            e.accountant.step()
    jr, tr = je.accountant.report(), te.accountant.report()
    assert tr["mode"] == jr["mode"] == mode
    assert set(tr) == set(jr)
    for k in jr:
        if isinstance(jr[k], float):
            assert tr[k] == pytest.approx(jr[k], rel=1e-9), k
        else:
            assert tr[k] == jr[k], k
    assert getattr(te.accountant, "central_fallback_reason", None) == \
        getattr(je.accountant, "central_fallback_reason", None)


def test_training_epsilon_and_history_match_jax():
    """run_federated_training with clip + noise + 8-bit quantize + secure
    aggregation (central accountant): epsilon per round at rel 1e-9, the
    loss history and params at the training tolerances."""
    series = synthetic.generate_buildings("CA", list(range(6)), days=6)
    kw = dict(n_clients=6, clients_per_round=3, rounds=2, n_clusters=0,
              batch_size=32, lr=0.05, seed=0, dp_clip=1.0, dp_noise=0.8,
              quantize_bits=8, secure_agg=True)
    want = jfed.run_federated_training(series, JCFG, JFLConfig(**kw))[-1]
    init = _np(jfc.init_forecaster(jax.random.fold_in(
        jax.random.PRNGKey(0), 0), JCFG))
    got = fedavg.run_federated_training(series, CFG, FLConfig(**kw),
                                        init_params=init, device=CPU)[-1]
    assert got.privacy["mode"] == want.privacy["mode"] == "central:secure-agg"
    np.testing.assert_allclose(got.eps_history, want.eps_history, rtol=1e-9)
    assert np.isfinite(got.eps_history).all()
    assert got.privacy["epsilon"] == pytest.approx(want.privacy["epsilon"],
                                                   rel=1e-9)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-4)
    _close(got.params, want.params, rtol=1e-3, atol=1e-5)
