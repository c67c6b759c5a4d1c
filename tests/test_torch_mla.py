"""The port's MLA (``repro_torch/models/attention.py``: ``init_mla``,
``_mla_q``, ``_mla_ckv``, ``mla_forward``, ``mla_decode``,
``init_mla_cache``) against the JAX package's, from the same JAX-made
params, in fp32 at 2e-4 of the reference's largest |value|: the
non-absorbed forward, its filled latent cache, and absorbed decode steps
after it, with and without a window.  MLA never reaches the flash kernel
(q's head dim is not v's), on either ``attn_impl``; ``_causal_attend``
still refuses the mismatch on the kernel route for any other caller."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.layers import tree_from_numpy  # noqa: E402

B, S = 2, 40


def _setup(seed=0):
    jcfg = jreg.get_config("deepseek-v3-671b").reduced()
    tcfg = treg.get_config("deepseek-v3-671b").reduced()
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _close(t, j, tol=2e-4):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.isfinite(t).all()
    assert float(np.abs(t - j).max()) <= tol * float(np.abs(j).max())


def test_init_mla_layout():
    jcfg, tcfg, jp, _, _ = _setup()
    tp = tattn.init_mla(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    jc = jattn.init_mla_cache(jcfg, B, S, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, B, S, torch.float32)
    for k in jc:
        assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_mla_projections_match_jax():
    jcfg, tcfg, jp, tp, x = _setup(1)
    m = jcfg.mla
    pos = np.arange(S)[None, :]
    jq = jattn._mla_q(jp, jnp.asarray(x), m, jcfg.n_heads, jnp.asarray(pos),
                      jcfg.norm_eps)
    tq = tattn._mla_q(tp, torch.from_numpy(x), tcfg.mla, tcfg.n_heads,
                      torch.from_numpy(pos), tcfg.norm_eps)
    jc = jattn._mla_ckv(jp, jnp.asarray(x), m, jnp.asarray(pos),
                        jcfg.norm_eps)
    tc = tattn._mla_ckv(tp, torch.from_numpy(x), tcfg.mla,
                        torch.from_numpy(pos), tcfg.norm_eps)
    for t, j in zip(tq + tc, jq + jc):
        _close(t, j)


@pytest.mark.parametrize("window", [0, 8], ids=["full", "window8"])
def test_mla_forward_then_decode_matches_jax(window):
    jcfg, tcfg, jp, tp, x = _setup(2)
    W = S + 3
    jc = jattn.init_mla_cache(jcfg, B, W, jnp.float32)
    want, jc = jattn.mla_forward(jp, jnp.asarray(x), jcfg, cache=jc,
                                 window=window)
    tc = tattn.init_mla_cache(tcfg, B, W, torch.float32)
    ops.reset_launch_counts()
    # mla_forward has no attn_impl: either route of a model takes it so
    got, tc2 = tattn.mla_forward(tp, torch.from_numpy(x), tcfg, cache=tc,
                                 window=window)
    assert tc2 is tc and ops.launch_counts()["flash_attention"] == 0
    _close(got, want)
    for k in ("c_kv", "k_rope", "pos_ids"):
        _close(tc[k], jc[k], 1e-5)
    r = np.random.default_rng(3)
    for pos in range(S, W):
        xt = r.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        want, jc = jattn.mla_decode(jp, jnp.asarray(xt), jc, jnp.int32(pos),
                                    jcfg, window=window)
        got, tc = tattn.mla_decode(tp, torch.from_numpy(xt), tc, pos, tcfg,
                                   window=window)
        _close(got, want)
        for k in ("c_kv", "k_rope"):
            _close(tc[k], jc[k], 1e-5)


def test_kernel_route_still_refuses_mismatched_head_dims():
    q = torch.zeros(1, 8, 2, 48)
    k = torch.zeros(1, 8, 2, 48)
    v = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="one head dim"):
        tattn._causal_attend(q, k, v, 48 ** -0.5, 0, torch.float32,
                             attn_impl="kernel")
    out = tattn._causal_attend(q, k, v, 48 ** -0.5, 0, torch.float32,
                               attn_impl="torch")
    assert out.shape == (1, 8, 2, 32)
