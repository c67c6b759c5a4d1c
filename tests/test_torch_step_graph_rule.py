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
from repro_torch.kernels import ref
from repro_torch.models import forecaster
from repro_torch.models.layers import tree_leaves

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
def _plain_kernels(monkeypatch, cell):
    """The eager route's layer stood in by an autograd Function of the
    plain layer and its BPTT (``kernels/ref.py``), as ``LSTMLayer`` /
    ``GRULayer`` pair the kernels on the card; the static step's calls
    (``out=``, ``*_layer_bptt``) take the same two on the CPU."""
    lstm = cell == "lstm"
    fwd = ref.lstm_layer_ref if lstm else ref.gru_layer_ref
    bwd = ref.lstm_layer_bptt_ref if lstm else ref.gru_layer_bptt_ref
    layer = getattr(forecaster, f"{cell}_layer")

    class Layer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            got = fwd(*args)
            ctx.save_for_backward(*args, got[0] if lstm else got)
            return got

        @staticmethod
        def backward(ctx, *g):
            return bwd(*ctx.saved_tensors, *(t.contiguous() for t in g),
                       ctx.needs_input_grad)

    monkeypatch.setattr(forecaster, f"{cell}_layer",
                        lambda *a, out=None: Layer.apply(*a) if out is None
                        else layer(*a, out=out))


@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("lstm", 2),
                                           ("gru", 1), ("gru", 2)])
def test_static_step_bit_equal_to_the_eager_loop(monkeypatch, cell,
                                                 n_layers, prox_mu):
    """What a replay runs (``StepGraphs._eager_step``), from the static
    buffers, with the kernels stood in on the CPU: two rounds of losses
    and params bit-equal to the eager loop's."""
    _plain_kernels(monkeypatch, cell)
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
