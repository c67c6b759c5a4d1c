"""The rule that chooses the local update's route, the cache of graphed
step sets, and the graphed step's arithmetic, on the CPU
(``core/client.py``).  The card's own tests, the captures and replays, are
``tests/test_torch_step_graph.py``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_step_graph_rule.py
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ForecasterConfig
from repro_torch.core import client, losses
from repro_torch.kernels import gru_cell, lstm_cell
from repro_torch.models import forecaster
from repro_torch.models.layers import tree_leaves, tree_map

CUDA = torch.device("cuda")
MSE = losses.make_loss("mse")
EW2 = losses.make_loss("ew_mse", 2.0)


class _Watch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _no_sets():
    """No cached set before or after a test, and one intra-op thread: the
    suite runs in several worker processes at once, and torch's thread
    pool in each of them would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    client.clear_step_graphs()
    yield
    client.clear_step_graphs()
    torch.set_num_threads(n)


def _inputs(m=3, n_win=40, steps=5, b=8, lookback=8, horizon=4, seed=3,
            input_dim=1):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(
        r.random((m, n_win, lookback, input_dim)).astype(np.float32))
    y = torch.from_numpy(r.random((m, n_win, horizon)).astype(np.float32))
    bidx = torch.from_numpy(r.integers(0, n_win, (m, steps, b)))
    return x, y, bidx


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_rule_engages_on_the_card_kernel_route(device):
    assert client.graphs_engage(torch.device(device), "kernel")


@pytest.mark.parametrize("device,cell_impl", [
    ("cpu", "kernel"),                                     # the CPU
    ("cuda", "torch"),                                     # the plain route
    ("cpu", "torch"),
], ids=["cpu", "torch_route", "cpu_torch_route"])
def test_rule_keeps_the_eager_loop(device, cell_impl):
    assert not client.graphs_engage(torch.device(device), cell_impl)


def test_rule_keeps_the_eager_loop_under_a_dispatch_mode():
    """A replay dispatches no op, so a mode that follows ops (flcheck's
    taint tracer and host-read guard, a FLOP counter) gets the eager
    loop."""
    with _Watch():
        assert not client.graphs_engage(CUDA, "kernel")
    assert client.graphs_engage(CUDA, "kernel")


def test_cpu_update_makes_no_set():
    cfg = ForecasterConfig(hidden_dim=8)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(1),
                                        cfg)
    x, y, bidx = _inputs()
    client.local_update(params, x, y, bidx, 0.05, cfg, MSE)
    assert not client._sets


# ------------------------------------------------------------- the cache key
_CFG = ForecasterConfig(hidden_dim=8)


def _key(cfg=_CFG, loss=MSE, dtype=torch.float32, device="cpu", **kw):
    x, y, bidx = _inputs(**kw)
    return client.step_shape(x.to(device, dtype), y.to(device, dtype),
                             bidx, cfg, loss)


@pytest.mark.parametrize("field,kw", [
    ("cell", {"cfg": ForecasterConfig(hidden_dim=8, cell="gru")}),
    ("n_layers", {"cfg": ForecasterConfig(hidden_dim=8, n_layers=2)}),
    ("I", {"input_dim": 2}),
    ("H", {"cfg": ForecasterConfig(hidden_dim=16)}),
    ("L", {"lookback": 6}),
    ("horizon", {"horizon": 2}),
    ("M", {"m": 4}),
    ("n_win", {"n_win": 41}),
    ("B", {"b": 16}),
    ("dtype", {"dtype": torch.bfloat16}),
    ("device", {"device": "meta"}),
    ("loss", {"loss": EW2}),
    ("loss", {"loss": losses.make_loss("ew_mse", 3.0)}),
])
def test_key_changes_with_each_field(field, kw):
    base, other = _key(), _key(**kw)
    assert base != other
    assert [f for f in client.StepShape._fields
            if getattr(base, f) != getattr(other, f)] == [field]


def test_key_follows_the_tf32_switch(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    off = _key()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    on = _key()
    assert off != on and off._replace(tf32=True) == on


def test_key_ignores_the_steps_and_the_data():
    """One set serves rounds of any length and any values."""
    assert _key(steps=9, seed=1) == _key(steps=20, seed=2)


# ---------------------------------------------------------- the bounded LRU
def test_cache_is_a_bounded_lru():
    params = forecaster.init_forecaster(torch.Generator().manual_seed(1),
                                        _CFG)
    keys = [_key(m=m) for m in range(1, client.GRAPH_SETS + 3)]
    first = client.step_graphs(keys[0], params)
    for k in keys[1:client.GRAPH_SETS]:
        client.step_graphs(k, params)
    assert client.step_graphs(keys[0], params) is first   # now most recent
    for k in keys[client.GRAPH_SETS:]:
        client.step_graphs(k, params)
        assert len(client._sets) == client.GRAPH_SETS
    # keys[1] and keys[2] went, the least recently used
    assert list(client._sets) == (keys[3:client.GRAPH_SETS] + [keys[0]]
                                  + keys[client.GRAPH_SETS:])
    assert client.step_graphs(keys[0], params) is first
    client.clear_step_graphs()
    assert not client._sets


# ------------------------------------------------- the graphed step's arithmetic
@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("lstm", 2),
                                           ("gru", 1), ("gru", 2)])
def test_static_step_bit_equal_to_the_eager_loop(cell, n_layers, prox_mu):
    """What a replay runs (``StepGraphs._eager_step``), from the static
    buffers, on the CPU, where both call the same plain layer and BPTT:
    two rounds of losses and params bit-equal to the eager loop's."""
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers, hidden_dim=16)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(2),
                                        cfg)
    for rnd in range(2):
        x, y, bidx = _inputs(seed=10 + rnd)
        want, want_loss = client.local_update(params, x, y, bidx, 0.05, cfg,
                                              EW2, "kernel", prox_mu)
        gs = client.step_graphs(client.step_shape(x, y, bidx, cfg, EW2),
                                params)
        gs.load(params, x, y, 0.05, prox_mu)
        per_step = []
        for s in range(bidx.shape[1]):
            gs.idx.copy_(bidx[:, s])
            gs._eager_step()
            per_step.append(gs.loss.clone())
        assert torch.equal(torch.stack(per_step).mean(0), want_loss)
        for a, b in zip(tree_leaves(gs.local), tree_leaves(want)):
            assert torch.equal(a, b)
        params = {"layers": [{k: v.mean(0) for k, v in p.items()}
                             for p in want["layers"]],
                  "head": {k: v.mean(0) for k, v in want["head"].items()}}


# ------------------------------------------- the kernel route's eager step
@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("lstm", 2),
                                           ("gru", 1), ("gru", 2)])
def test_kernel_step_matches_the_plain_step(cell, n_layers, prox_mu):
    """One eager step on the kernel route (forward, head VJP, BPTT) against
    the plain route's (autograd through the plain cells), from the same
    client-stacked params, batch and anchor: each client's loss and the
    new params within 1e-6."""
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers, hidden_dim=16)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(4),
                                        cfg)
    x, y, bidx = _inputs(seed=21)
    rows = torch.arange(x.shape[0])[:, None]
    batch = {"x": x[rows, bidx[:, 0]], "y": y[rows, bidx[:, 0]]}
    g = torch.Generator().manual_seed(6)
    stacked = tree_map(lambda w: w + 0.01 * torch.randn(
        (x.shape[0],) + w.shape, generator=g), params)
    got = {impl: client.sgd_step(stacked, batch, 0.05, cfg, EW2, impl,
                                 anchor=params, prox_mu=prox_mu)
           for impl in ("kernel", "torch")}
    (k_new, k_loss), (p_new, p_loss) = got["kernel"], got["torch"]
    torch.testing.assert_close(k_loss, p_loss, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(k_new), tree_leaves(p_new)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert not any(t.requires_grad for t in tree_leaves(k_new) + [k_loss])


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_route_training_reaches_no_layer_function(monkeypatch, cell):
    """The local update on the kernel route calls the layer and its BPTT
    itself: with the layers' autograd Functions made to raise, it still
    runs, and matches the plain route.  On the CPU the wrappers never take
    the Functions, so the layer calls are watched as well: none is one
    that autograd records, the call a wrapper hands its Function on the
    card."""
    def refuse(*a, **kw):
        raise AssertionError("training reached a layer's autograd Function")

    def watched(layer):
        def call(*args, **kw):
            if torch.is_grad_enabled() and any(t.requires_grad
                                               for t in args):
                refuse()
            return layer(*args, **kw)
        return call

    monkeypatch.setattr(lstm_cell.LSTMLayer, "apply", refuse)
    monkeypatch.setattr(gru_cell.GRULayer, "apply", refuse)
    for name in ("lstm_layer", "gru_layer"):
        monkeypatch.setattr(forecaster, name,
                            watched(getattr(forecaster, name)))
    cfg = ForecasterConfig(cell=cell, n_layers=2, hidden_dim=8)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(5),
                                        cfg)
    x, y, bidx = _inputs(steps=3)
    got, loss = client.local_update(params, x, y, bidx, 0.05, cfg, MSE,
                                    "kernel", 0.01)
    want, want_loss = client.local_update(params, x, y, bidx, 0.05, cfg,
                                          MSE, "torch", 0.01)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
