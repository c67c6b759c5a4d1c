"""The port's optimizers and schedules against the JAX package's.

Over 3 updates of a random tree with 1-D, 2-D and stacked 3-D leaves (the
shapes the LM trees hold: norms, matrices, layer stacks), each optimizer's
updates and state are held against ``repro.optim`` at rtol 1e-5 / atol
1e-7; the schedules at 1e-7.  ``update_in_place`` (leaf by leaf, into the
params and state tensors) is held to the functional update bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"norm": (7,), "w": (5, 6), "stack": {"w": (3, 4, 5), "b": (3, 6)}}
OPTS = {
    "sgd": lambda m: m.sgd(),
    "sgd_momentum": lambda m: m.sgd(momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(momentum=0.9, nesterov=True),
    "adam": lambda m: m.adam(),
    "adamw": lambda m: m.adamw(),
    "adafactor": lambda m: m.adafactor(),
}


def _rand_tree(rng, scale=1.0):
    def one(shape):
        if isinstance(shape, dict):
            return {k: one(v) for k, v in shape.items()}
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return one(SHAPES)


def _to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _flat_state(state):
    """The tensors of an optimizer state in order (None entries dropped)."""
    out = []
    for s in state:
        if isinstance(s, dict):
            for leaf in tree_leaves(s):
                out.extend(x for x in (leaf if isinstance(leaf, (tuple, list))
                                       else (leaf,)) if x is not None)
        else:
            out.append(s)
    return out


def _jax_flat_state(state, params):
    out = []
    for s in state:
        if isinstance(s, dict):
            for leaf in _sorted_like(s, params):
                out.extend(x for x in (leaf if isinstance(leaf, tuple)
                                       else (leaf,)) if x is not None)
        else:
            out.append(s)
    return out


def _sorted_like(tree, like):
    """Leaves of a JAX-side tree in the port tree's (insertion) order."""
    if isinstance(like, dict):
        return [x for k in like for x in _sorted_like(tree[k], like[k])]
    return [tree]


@pytest.mark.parametrize("name", list(OPTS))
def test_three_updates_match_jax(name):
    rng = np.random.default_rng(0)
    p0 = _rand_tree(rng)
    jopt, topt = OPTS[name](joptim), OPTS[name](toptim)
    jp, tp = jax.tree.map(jnp.asarray, p0), _to_torch(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _rand_tree(rng, scale=10.0 ** (step - 1))
        lr = 1e-2 * (step + 1)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(lr))
        tu, ts = topt.update(_to_torch(g), ts, tp, lr)
        for a, b in zip(tree_leaves(tu), _sorted_like(ju, p0)):
            _close(a, b)
        jsf, tsf = _jax_flat_state(js, p0), _flat_state(ts)
        assert len(jsf) == len(tsf)
        for a, b in zip(tsf, jsf):
            assert a.dtype == (torch.int32 if a.dim() == 0 else
                               torch.float32)
            _close(a, b)
        jp = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        tp = tree_map(lambda p, u: p + u.to(p.dtype), tp, tu)
    for a, b in zip(tree_leaves(tp), _sorted_like(jp, p0)):
        _close(a, b)


@pytest.mark.parametrize("name", list(OPTS))
def test_update_in_place_equals_the_functional_update(name):
    rng = np.random.default_rng(1)
    opt = OPTS[name](toptim)
    p_fun = _to_torch(_rand_tree(rng))
    p_in = tree_map(torch.clone, p_fun)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    leaves_in = tree_leaves(p_in)
    for _ in range(3):
        g = _to_torch(_rand_tree(rng))
        u, s_fun = opt.update(g, s_fun, p_fun, 3e-2)
        p_fun = tree_map(lambda p, d: p + d.to(p.dtype), p_fun, u)
        s_in = toptim.update_in_place(opt, g, s_in, p_in, 3e-2)
    # the params are the same tensors, written in place
    assert all(a is b for a, b in zip(tree_leaves(p_in), leaves_in))
    for a, b in zip(tree_leaves(p_in), tree_leaves(p_fun)):
        assert torch.equal(a, b)
    for a, b in zip(_flat_state(s_in), _flat_state(s_fun)):
        assert torch.equal(a, b)


def test_adam_keeps_fp32_moments_for_bf16_params():
    p = {"w": torch.ones((4, 3), dtype=torch.bfloat16)}
    opt = toptim.adam()
    m, v, t = opt.init(p)
    assert m["w"].dtype == v["w"].dtype == torch.float32
    u, (m, v, t) = opt.update({"w": torch.full((4, 3), 0.5,
                                               dtype=torch.bfloat16)},
                              (m, v, t), p, 1e-3)
    assert u["w"].dtype == torch.bfloat16 and m["w"].dtype == torch.float32
    assert int(t) == 1


def test_adafactor_factor_shapes_cover_stacked_leaves():
    p = _to_torch(_rand_tree(np.random.default_rng(2)))
    factors, t = toptim.adafactor().init(p)
    assert factors["stack"]["w"][0].shape == (3, 4)
    assert factors["stack"]["w"][1].shape == (3, 5)
    assert factors["w"][0].shape == (5,) and factors["w"][1].shape == (6,)
    assert factors["norm"][0].shape == (7,) and factors["norm"][1] is None


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.warmup_cosine(1e-3, 10, 100),
    lambda m: m.warmup_cosine(2e-2, 0, 50, floor=0.0),
], ids=["constant", "warmup_cosine", "cosine_no_warmup"])
def test_schedules_match_jax(make):
    jf, tf = make(joptim), make(toptim)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 130]:
        a = float(tf(step))
        b = float(jf(step))
        assert abs(a - b) <= 1e-7, (step, a, b)
    steps = torch.arange(0, 120, dtype=torch.float32)
    np.testing.assert_allclose(tf(steps).numpy(),
                               np.asarray(jf(jnp.arange(0, 120,
                                                        dtype=jnp.float32))),
                               rtol=0, atol=1e-7)
