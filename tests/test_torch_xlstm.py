"""The port's xLSTM blocks (``repro_torch/models/xlstm.py``) against the JAX
package's, from the same JAX-made params, in fp32 at 2e-4 of the
reference's largest |value|: the chunkwise mLSTM forward (S a multiple of
the chunk and not: ``i_raw`` padded with -1e9) and its (C, n) state, the
recurrent mLSTM decode continuing from JAX's state and from the port's,
the sLSTM scan and decode (``m`` starts at -1e9; the up-projection's GELU
is the tanh form, ``jax.nn.gelu``'s default)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.layers import tree_from_numpy  # noqa: E402

B = 2


def _cfgs():
    return (jreg.get_config("xlstm-1.3b").reduced(),
            treg.get_config("xlstm-1.3b").reduced())


def _params(init_j, init_t, seed):
    jcfg, tcfg = _cfgs()
    jp = init_j(jax.random.PRNGKey(seed), jcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    mine = init_t(torch.Generator().manual_seed(seed), tcfg)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(cfg, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _close(t, j, tol=2e-4):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.isfinite(t).all()
    assert float(np.abs(t - j).max()) <= tol * float(np.abs(j).max())


@pytest.mark.parametrize("S", [64, 45], ids=["chunks2", "padded"])
def test_mlstm_forward_then_decode_matches_jax(S):
    jcfg, tcfg, jp, tp = _params(jx.init_mlstm, tx.init_mlstm, 1)
    x = _x(jcfg, S, S)
    want, jst = jx.mlstm_forward(jp, jnp.asarray(x), jcfg)
    got, st = tx.mlstm_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(st["C"], jst["C"])
    _close(st["n"], jst["n"])
    # a second prefill from that state, then recurrent steps
    x2 = _x(jcfg, S, S + 1)
    want, jst = jx.mlstm_forward(jp, jnp.asarray(x2), jcfg, state=jst)
    got, st = tx.mlstm_forward(tp, torch.from_numpy(x2), tcfg, state=st)
    _close(got, want)
    r = np.random.default_rng(S)
    for _ in range(3):
        xt = r.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, jst = jx.mlstm_decode(jp, jnp.asarray(xt), jst, jcfg)
        got, st = tx.mlstm_decode(tp, torch.from_numpy(xt), st, tcfg)
        _close(got, want)
        _close(st["C"], jst["C"])
        _close(st["n"], jst["n"])


def test_mlstm_gates_match_jax():
    jcfg, tcfg, jp, tp = _params(jx.init_mlstm, tx.init_mlstm, 2)
    _, d_m, _, _ = jx._mdims(jcfg)
    # pre-activations large enough that the i~ clamp at ICLAMP bites
    a = np.random.default_rng(2).normal(size=(B, 5, d_m)).astype(
        np.float32) * 30
    for t, j in zip(tx._mlstm_qkvg(tp, torch.from_numpy(a), tcfg),
                    jx._mlstm_qkvg(jp, jnp.asarray(a), jcfg)):
        _close(t, j, 1e-5)
    i_raw = tx._mlstm_qkvg(tp, torch.from_numpy(a), tcfg)[3]
    assert float(i_raw.max()) == tx.ICLAMP == jx.ICLAMP


def test_slstm_forward_then_decode_matches_jax():
    jcfg, tcfg, jp, tp = _params(jx.init_slstm, tx.init_slstm, 3)
    # a non-zero gate bias, so the stabiliser m moves off its start
    jp = dict(jp, b=jnp.asarray(np.random.default_rng(3).normal(
        size=jp["b"].shape), jnp.float32))
    tp = dict(tp, b=torch.from_numpy(np.array(jp["b"])))
    x = _x(jcfg, 23, 3)
    want, jst = jx.slstm_forward(jp, jnp.asarray(x), jcfg)
    got, st = tx.slstm_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    for k in ("c", "n", "h", "m"):
        _close(st[k], jst[k])
    r = np.random.default_rng(4)
    for _ in range(3):
        xt = r.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, jst = jx.slstm_decode(jp, jnp.asarray(xt), jst, jcfg)
        got, st = tx.slstm_decode(tp, torch.from_numpy(xt), st, tcfg)
        _close(got, want)
    js, ts = jx.init_slstm_state(jcfg, B), tx.init_slstm_state(tcfg, B)
    jm, tm = jx.init_mlstm_state(jcfg, B), tx.init_mlstm_state(tcfg, B)
    for j, t in ((js, ts), (jm, tm)):
        for k in j:
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))
    assert float(ts["m"][0, 0, 0]) == -1e9
