"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's, from the same JAX-made params and the same inputs, in fp32:
the output within 2e-4 of the reference's largest |value|, the aux loss at
rtol 1e-5, and the routing decisions (experts, capacity positions, kept
slots) equal; ties broken as ``jax.lax.top_k`` breaks them (lower index
first); ``_choose_group`` and ``capacity`` equal over a sweep."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import tree_from_numpy  # noqa: E402

TOL = 2e-4


def _cfgs(arch, **moe_kw):
    j, t = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    if moe_kw:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe_kw))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe_kw))
    return j, t


def _jax_positions(experts, E, C):
    """The reference's capacity positions, as ``moe_ffn`` computes them
    (``src/repro/models/moe.py:92-97``)."""
    G, S, k = experts.shape
    onehot = jax.nn.one_hot(experts, E, dtype=jnp.int32)
    flat = onehot.reshape(G, S * k, E)
    pos_in_e = jnp.cumsum(flat, axis=1) - 1
    pos = jnp.sum(flat * pos_in_e, axis=-1).reshape(G, S, k)
    return pos, pos < C


def _close(t, j, tol=TOL):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape and np.isfinite(t).all()
    assert float(np.abs(t - j).max()) <= tol * float(np.abs(j).max())


# dbrx: 4 experts top-2, no shared; deepseek: + 1 shared expert; a
# capacity factor of 0.5 drops slots; group_size 48 splits 2 x 40 tokens
# into groups of 40 (the largest divisor of 80 below 48)
CASES = [("dbrx-132b", {}), ("deepseek-v3-671b", {}),
         ("dbrx-132b", {"capacity_factor": 0.5}),
         ("deepseek-v3-671b", {"group_size": 48, "capacity_factor": 0.75})]


@pytest.mark.parametrize("arch,moe_kw", CASES,
                         ids=["dbrx", "deepseek", "dbrx-drops",
                              "deepseek-groups"])
def test_moe_ffn_matches_jax(arch, moe_kw):
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(7).normal(
        size=(2, 40, jcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    e = jcfg.moe
    gsz = jmoe._choose_group(80, min(e.group_size, 80))
    assert tmoe._choose_group(80, min(e.group_size, 80)) == gsz
    xg = x.reshape(80 // gsz, gsz, -1)
    jg, je, ja = jmoe._route(jp["router"], jnp.asarray(xg), e)
    tg, te, ta = tmoe._route(tp["router"], torch.from_numpy(xg), e)
    assert np.array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg, 1e-6)
    C = jmoe.capacity(e, gsz)
    assert tmoe.capacity(e, gsz) == C
    jpos, jkeep = _jax_positions(je, e.n_experts, C)
    tpos, tkeep = tmoe._positions(te, e.n_experts, C)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    if moe_kw.get("capacity_factor", 1.25) < 1:
        assert not bool(tkeep.all())                  # some slots dropped


def test_top_k_ties_take_the_lower_index_first():
    """A zero router makes every probability equal: jax.lax.top_k keeps
    experts 0..k-1 in index order, and so must the port."""
    jcfg, tcfg = _cfgs("dbrx-132b")
    E, k = jcfg.moe.n_experts, jcfg.moe.top_k
    x = np.random.default_rng(0).normal(size=(1, 6, jcfg.d_model)
                                        ).astype(np.float32)
    zero = np.zeros((jcfg.d_model, E), np.float32)
    _, je, _ = jmoe._route(jnp.asarray(zero), jnp.asarray(x), jcfg.moe)
    _, te, _ = tmoe._route(torch.from_numpy(zero), torch.from_numpy(x),
                           tcfg.moe)
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert te[0, 0].tolist() == list(range(k))
    # ties among the top values only: experts 1 and 3 equal and largest
    probs = torch.tensor([[[0.1, 0.3, 0.2, 0.3]]])
    _, idx = tmoe._top_k(probs, 3)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[[1, 3, 2]]]


@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 80, 4096, 4099])
def test_group_and_capacity_match_jax(tokens):
    for arch in ("dbrx-132b", "deepseek-v3-671b"):
        jm = jreg.get_config(arch).moe
        tm = treg.get_config(arch).moe
        g = jmoe._choose_group(tokens, min(jm.group_size, tokens))
        assert tmoe._choose_group(tokens, min(tm.group_size, tokens)) == g
        assert tmoe.capacity(tm, g) == jmoe.capacity(jm, g)


def test_init_moe_layout_and_scales():
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg,
                       dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}
    assert tp["router"].dtype == torch.float32          # router in fp32
    assert tp["moe_w_in"].dtype == torch.bfloat16
    e = tcfg.moe
    for key, fan_in in (("moe_w_in", tcfg.d_model),
                        ("moe_w_out", e.d_ff_expert)):
        std = float(tp[key].float().std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.05, (key, std)
    # expert by expert: the experts are distinct draws
    assert not torch.equal(tp["moe_w_in"][0], tp["moe_w_in"][1])
