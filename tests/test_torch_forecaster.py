"""The port's forecaster against the JAX package's, from the same weights.

JAX makes the parameters (torch cannot replay ``jax.random``); they cross
as numpy arrays through ``params_from_numpy``.  The port's forward runs its
default ``cell_impl="kernel"`` path (the plain cells on the CPU) and its
``"torch"`` path; both are held to JAX ``forecast(..., "jnp")`` and
``forecast(..., "pallas")`` (interpret mode) at rtol/atol 1e-5, the
tolerance ``tests/test_kernels.py`` pins the two JAX paths to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ForecasterConfig as JaxForecasterConfig  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(cfg: JaxForecasterConfig, seed: int):
    return jfc.init_forecaster(jax.random.PRNGKey(seed), cfg)


@pytest.mark.parametrize("B", [16, 256])
@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forecast_matches_jax(cell, n_layers, B):
    kw = dict(cell=cell, hidden_dim=64, n_layers=n_layers)
    jcfg, cfg = JaxForecasterConfig(**kw), ForecasterConfig(**kw)
    jparams = _jax_params(jcfg, n_layers)
    params = forecaster.params_from_numpy(jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(B + n_layers).normal(
        size=(B, cfg.lookback, 1)).astype(np.float32)
    y_jnp = np.asarray(jfc.forecast(jparams, jnp.asarray(x), jcfg, "jnp"))
    y_pallas = np.asarray(jfc.forecast(jparams, jnp.asarray(x), jcfg,
                                       "pallas"))
    xt = torch.from_numpy(x)
    for impl in forecaster.CELL_IMPLS:
        y = forecaster.forecast(params, xt, cfg, impl).numpy()
        assert y.shape == (B, cfg.horizon)
        np.testing.assert_allclose(y, y_jnp, **TOL)
        np.testing.assert_allclose(y, y_pallas, **TOL)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_route_calls_the_layer_once_per_layer(cell, n_layers,
                                                     monkeypatch):
    """cell_impl="kernel" runs each layer in one call of the layer wrapper
    (one launch on the card), fed the contiguous time-major sequence; the
    plain route never calls it."""
    cfg = ForecasterConfig(cell=cell, hidden_dim=16, n_layers=n_layers)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(6, cfg.lookback, 1)).astype(np.float32))
    name = f"{cell}_layer"
    real, calls = getattr(forecaster, name), []

    def counted(x_seq, *args):
        calls.append((tuple(x_seq.shape), x_seq.is_contiguous()))
        return real(x_seq, *args)

    monkeypatch.setattr(forecaster, name, counted)
    y = forecaster.forecast(params, x, cfg, "kernel")
    assert calls == [((cfg.lookback, 6, 1), True)] + \
        [((cfg.lookback, 6, 16), True)] * (n_layers - 1)
    np.testing.assert_array_equal(
        y.numpy(), forecaster.forecast(params, x, cfg, "torch").numpy())
    assert len(calls) == n_layers


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_params_round_trip_and_layout(cell):
    """params_to_numpy inverts params_from_numpy leaf for leaf, and the
    port's template/init trees have the JAX tree's keys and shapes."""
    kw = dict(cell=cell, hidden_dim=16, n_layers=2)
    jcfg, cfg = JaxForecasterConfig(**kw), ForecasterConfig(**kw)
    jnp_tree = jax.tree.map(np.asarray, _jax_params(jcfg, 3))
    back = forecaster.params_to_numpy(forecaster.params_from_numpy(jnp_tree))
    for a, b in zip(jax.tree.leaves(jnp_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    shapes = jax.tree.map(np.shape, jnp_tree)
    for tree in (forecaster.param_template(cfg),
                 forecaster.init_forecaster(torch.Generator().manual_seed(0),
                                            cfg)):
        assert jax.tree.map(lambda t: tuple(t.shape), tree) == shapes
    assert cfg.num_params() == jcfg.num_params() == sum(
        a.size for a in jax.tree.leaves(jnp_tree))


def test_bf16_leaves_cross_exactly():
    """A JAX bf16 leaf (an ml_dtypes array on the host) arrives as a torch
    bf16 tensor with the same bits; params_to_numpy widens it exactly."""
    cfg = JaxForecasterConfig(hidden_dim=8)
    jtree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                         _jax_params(cfg, 4))
    params = forecaster.params_from_numpy(jtree)
    wh = params["layers"][0]["wh"]
    assert wh.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wh.view(torch.int16).numpy(),
        jtree["layers"][0]["wh"].view(np.int16))
    np.testing.assert_array_equal(
        forecaster.params_to_numpy(params)["layers"][0]["wh"],
        jtree["layers"][0]["wh"].astype(np.float32))


def test_module_forward_equals_forecast():
    cfg = ForecasterConfig(cell="gru", hidden_dim=16, n_layers=2)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(1), cfg)
    model = forecaster.Forecaster(cfg, params)
    assert sorted(n for n, _ in model.named_parameters()) == [
        "head.b", "head.w", "layers.0.b", "layers.0.wh", "layers.0.wx",
        "layers.1.b", "layers.1.wh", "layers.1.wx"]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(5, cfg.lookback, 1)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(),
                                      forecaster.forecast(params, x,
                                                          cfg).numpy())
    with pytest.raises(ValueError, match="cell_impl"):
        forecaster.forecast(params, x, cfg, "pallas")
