"""The port's Mamba2 SSD block (``repro_torch/models/ssm.py``) against the
JAX package's, from the same JAX-made params, in fp32 at 2e-4 of the
reference's largest |value|: the chunked forward with S a multiple of the
chunk and not (identity padding), from a zero and from a given state, its
final SSM and conv states, decode steps that continue from them, and the
pieces (``_split_proj``, ``_conv``, ``_conv_step``, ``_heads``: the group
to head broadcast is ``repeat_interleave``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.layers import tree_from_numpy  # noqa: E402

B = 2


def _setup(seed=0):
    jcfg = jreg.get_config("zamba2-7b").reduced()
    tcfg = treg.get_config("zamba2-7b").reduced()
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    # non-trivial decays and skips: a_log, dt_bias, d_skip drawn
    r = np.random.default_rng(seed)
    jp = dict(jp)
    nh = jp["a_log"].shape[0]
    jp["a_log"] = jnp.asarray(r.normal(size=nh) * 0.5, jnp.float32)
    jp["dt_bias"] = jnp.asarray(r.normal(size=nh) - 1.0, jnp.float32)
    jp["d_skip"] = jnp.asarray(r.normal(size=nh), jnp.float32)
    jp["conv_b"] = jnp.asarray(r.normal(size=jp["conv_b"].shape) * 0.1,
                               jnp.float32)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _x(cfg, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _close(t, j, tol=2e-4):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.isfinite(t).all()
    assert float(np.abs(t - j).max()) <= tol * float(np.abs(j).max())


def test_ssm_pieces_match_jax():
    jcfg, tcfg, jp, tp = _setup(1)
    s = jcfg.ssm
    width = jp["in_proj"].shape[1]
    z = np.random.default_rng(1).normal(size=(B, 9, width)).astype(
        np.float32)
    jparts = jssm._split_proj(jnp.asarray(z), jcfg)
    tparts = tssm._split_proj(torch.from_numpy(z), tcfg)
    for t, j in zip(tparts, jparts):
        _close(t, j, 0)
    xbc, dt = np.array(jparts[1]), np.array(jparts[2])
    _close(tssm._conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"]),
           jssm._conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"]), 1e-6)
    state = xbc[:, :s.conv_width - 1]
    for t, j in zip(tssm._conv_step(torch.from_numpy(xbc[:, 5]),
                                    torch.from_numpy(state), tp["conv_w"],
                                    tp["conv_b"]),
                    jssm._conv_step(jnp.asarray(xbc[:, 5]),
                                    jnp.asarray(state), jp["conv_w"],
                                    jp["conv_b"])):
        _close(t, j, 1e-6)
    for t, j in zip(tssm._heads(torch.from_numpy(xbc), torch.from_numpy(dt),
                                tp, tcfg),
                    jssm._heads(jnp.asarray(xbc), jnp.asarray(dt), jp,
                                jcfg)):
        _close(t, j, 1e-6)


@pytest.mark.parametrize("S", [64, 50, 7], ids=["chunks2", "padded",
                                                "one-short-chunk"])
def test_ssm_forward_matches_jax(S):
    jcfg, tcfg, jp, tp = _setup(2)
    x = _x(jcfg, S, S)
    want, jst = jssm.ssm_forward(jp, jnp.asarray(x), jcfg)
    got, st = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(st["ssm"], jst["ssm"])
    _close(st["conv"], jst["conv"])
    # continuing from that state
    x2 = _x(jcfg, S, S + 1)
    want, _ = jssm.ssm_forward(jp, jnp.asarray(x2), jcfg, state=jst)
    got, _ = tssm.ssm_forward(tp, torch.from_numpy(x2), tcfg, state=st)
    _close(got, want)


def test_ssm_decode_matches_jax_after_a_prefill():
    jcfg, tcfg, jp, tp = _setup(3)
    x = _x(jcfg, 37, 3)
    _, jst = jssm.ssm_forward(jp, jnp.asarray(x), jcfg)
    _, st = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    r = np.random.default_rng(4)
    for _ in range(4):
        xt = r.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, jst = jssm.ssm_decode(jp, jnp.asarray(xt), jst, jcfg)
        got, st = tssm.ssm_decode(tp, torch.from_numpy(xt), st, tcfg)
        _close(got, want)
        _close(st["ssm"], jst["ssm"])
        _close(st["conv"], jst["conv"])
    jz = jssm.init_ssm_state(jcfg, B, jnp.float32)
    tz = tssm.init_ssm_state(tcfg, B, torch.float32)
    for k in jz:
        assert tz[k].shape == jz[k].shape and tz[k].dtype == torch.float32
    p = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
