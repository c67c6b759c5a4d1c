"""The port's package surface against the reference's: every public name of
``repro.<package>`` is importable from ``repro_torch.<package>`` except the
JAX-only ones, listed once in ``repro_torch.JAX_ONLY``; every module of
``src/repro/`` has its counterpart file; and the two rounds the reference
exports beside ``pipeline_round`` (``fedavg_round``, ``engine_round``)
match the live JAX functions from the same JAX-made params, at the
reference's own tolerances (``tests/test_pallas_parity.py``: loss rtol
1e-5, params rtol 1e-4 / atol 1e-5).
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs.base import ForecasterConfig as JForecasterConfig  # noqa: E402
from repro.core import fedavg as jfed  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.core import fedavg, losses  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("core", "configs", "data", "serving", "sharding")


def _public(mod):
    names = getattr(mod, "__all__", None)
    return set(names if names is not None
               else [n for n in dir(mod) if not n.startswith("_")])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_package_names_cover_the_reference(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    jax_only = set(repro_torch.JAX_ONLY.get(pkg, ()))
    missing = sorted(n for n in _public(ref) - jax_only
                     if not hasattr(port, n))
    assert missing == []
    # the listed names really are the reference's, and really absent here
    assert jax_only <= _public(ref)
    assert not any(hasattr(port, n) for n in jax_only)


def test_from_imports_of_the_reference_names_work():
    from repro_torch.configs import (AggregationConfig,  # noqa: F401
                                     TransformConfig, all_configs)
    from repro_torch.core import (RoundEngine, engine_round,  # noqa: F401
                                  fedavg_round, make_loss, server_update)
    from repro_torch.data import (ragged_minibatch_indices,  # noqa: F401
                                  sample_clients)
    from repro_torch.serving import (dequantize_params,  # noqa: F401
                                     quantize_params)
    assert RoundEngine is fedavg.RoundEngine
    assert len(all_configs()) == 10


def test_every_reference_module_has_a_counterpart():
    ref_root = REPO / "src" / "repro"
    port_root = REPO / "src" / "repro_torch"
    jax_only = {k for k in repro_torch.JAX_ONLY if "." in k}
    missing = []
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root)
        dotted = ".".join(rel.with_suffix("").parts)
        if dotted in jax_only:
            continue
        if not (port_root / rel).exists():
            missing.append(str(rel))
    assert missing == []


@pytest.mark.parametrize("first", ["repro_torch.serving", "repro_torch.core",
                                   "repro_torch.analysis.cli"])
def test_import_order_is_free_of_cycles(first):
    """``core`` re-exports ``fedavg``, which imports ``serving``, which
    imports ``core.prng``: any package may be imported first."""
    code = (f"import {first}, repro_torch.core as c, repro_torch.serving; "
            "print(c.RoundEngine.__name__, c.fedavg_round.__name__)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["RoundEngine", "fedavg_round"]


# ------------------------------------------------ the two rounds vs JAX
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol), got, want)


def _round_data(M=4, n_win=30, steps=5, B=6, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((M, n_win, 8, 1)).astype(np.float32)
    y = r.random((M, n_win, 4)).astype(np.float32)
    bidx = r.integers(0, n_win, (M, steps, B))
    w = r.integers(1, 50, (M,)).astype(np.float32)
    return x, y, bidx, w


def _params(jcfg, seed):
    return _np(jfc.init_forecaster(jax.random.fold_in(
        jax.random.PRNGKey(seed), 0), jcfg))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fedavg_round_matches_jax(cell):
    kw = dict(cell=cell, hidden_dim=8)
    jcfg, cfg = JForecasterConfig(**kw), ForecasterConfig(**kw)
    params = _params(jcfg, 11)
    x, y, bidx, _ = _round_data()
    loss = "ew_mse"
    jw, jl = jfed.fedavg_round(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(bidx), 0.05, jcfg,
                               jloss.make_loss(loss, 2.0), "jnp")
    w, lo = fedavg.fedavg_round(forecaster.params_from_numpy(params),
                                torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(bidx), 0.05, cfg,
                                losses.make_loss(loss, 2.0))
    np.testing.assert_allclose(float(lo), float(jl), rtol=1e-5)
    _close(w, _np(jw), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_engine_round_matches_jax(prox_mu):
    jcfg, cfg = JForecasterConfig(hidden_dim=8), ForecasterConfig(
        hidden_dim=8)
    params = _params(jcfg, 12)
    x, y, bidx, w = _round_data(seed=1)
    jw, jl = jfed.engine_round(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(bidx), jnp.asarray(w), 0.05,
                               prox_mu, jcfg, jloss.make_loss("mse"), "jnp")
    got, lo = fedavg.engine_round(forecaster.params_from_numpy(params),
                                  torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(bidx),
                                  torch.from_numpy(w), 0.05, prox_mu, cfg,
                                  losses.make_loss("mse"))
    np.testing.assert_allclose(float(lo), float(jl), rtol=1e-5)
    _close(got, _np(jw), rtol=1e-4, atol=1e-5)
