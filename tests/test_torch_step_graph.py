"""The graphed local step on the card (``core/client.py::StepGraphs``):
bit-equal to the eager kernel loop, one capture a shape, params that
outlive the next round's replays, and the hand-written launches counted
as on the eager route.  Every test needs a CUDA device and skips without
one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_step_graph.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.analysis import recompile  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.core import client, losses  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

M, N_WIN, STEPS, B = 5, 300, 20, 64
LOSS = losses.make_loss("ew_mse", 2.0)
# at 0.05 the 2-layer GRU diverges on these uniform random windows on
# every route, the CPU's plain layers and the JAX package's too (first-round
# losses above 1e15, nan in the second); at 0.01 every configuration stays
# finite
LR = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed step captures CUDA "
                    "graphs around the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    client.clear_step_graphs()
    yield torch.device("cuda")
    client.clear_step_graphs()


def _round(dev, seed, m=M):
    """Seeded x, y and minibatch schedule of one round on ``dev``."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.random((m, N_WIN, 8, 1)).astype(np.float32))
    y = torch.from_numpy(r.random((m, N_WIN, 4)).astype(np.float32))
    bidx = torch.from_numpy(r.integers(0, N_WIN, (m, STEPS, B)))
    return x.to(dev), y.to(dev), bidx.to(dev)


def _params(cfg, dev):
    return tree_map(lambda t: t.to(dev), forecaster.init_forecaster(
        torch.Generator().manual_seed(2), cfg))


def _eager(monkeypatch, *args):
    """local_update on the eager kernel loop, the graphed route ruled
    out."""
    with monkeypatch.context() as m:
        m.setattr(client, "graphs_engage", lambda *a: False)
        return client.local_update(*args)


def _mean(local):
    return tree_map(lambda t: t.mean(0), local)


@pytest.mark.parametrize("prox_mu", [0.0, 0.01])
@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("lstm", 2),
                                           ("gru", 1), ("gru", 2)])
def test_graphed_update_bit_equal_to_the_eager_kernel_loop(
        cuda, monkeypatch, cell, n_layers, prox_mu):
    """Two rounds in a row (new x and y, the next round from the mean of
    the last one's locals) on both routes: losses and params bit-equal,
    with no autograd history on the graphed route's, as on the eager
    route's."""
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers)
    p_eager = p_graph = _params(cfg, cuda)
    for rnd in range(2):
        x, y, bidx = _round(cuda, 10 + rnd)
        args = (x, y, bidx, LR, cfg, LOSS, "kernel", prox_mu)
        assert client.graphs_engage(cuda, "kernel")
        e_loc, e_loss = _eager(monkeypatch, p_eager, *args)
        g_loc, g_loss = client.local_update(p_graph, *args)
        assert torch.is_grad_enabled()
        assert not any(t.requires_grad for t in tree_leaves(g_loc) + [g_loss])
        assert bool(torch.isfinite(e_loss).all()), (rnd, e_loss)
        assert torch.equal(g_loss, e_loss), (rnd, g_loss, e_loss)
        for a, b in zip(tree_leaves(g_loc), tree_leaves(e_loc)):
            assert torch.equal(a, b), (rnd, (a - b).abs().max())
        p_eager, p_graph = _mean(e_loc), _mean(g_loc)


def test_one_capture_a_shape(cuda):
    """A second round of a shape captures nothing (flcheck's probe); a new
    M captures its three graphs once, one ``fl.step_graph.capture``
    event."""
    cfg = ForecasterConfig()
    params = _params(cfg, cuda)
    counter = recompile._CaptureCounter()
    with counter.active(), tracing.recording():
        seen = []
        for m, seed in ((M, 1), (M, 2), (M + 3, 3), (M + 3, 4)):
            x, y, bidx = _round(cuda, seed, m)
            tracing.clear()
            client.local_update(params, x, y, bidx, LR, cfg, LOSS)
            snap = tracing.snapshot()["counters"]
            seen.append((recompile.probe(counter)["captures"],
                         snap.get("fl.step_graph.capture", [0])[0],
                         snap.get("fl.step_graph", [0])[0]))
    assert seen == [(3, 1, STEPS - 1), (3, 0, STEPS), (6, 1, STEPS - 1),
                    (6, 0, STEPS)]


def test_returned_params_outlive_the_next_round(cuda):
    """The locals a round returns are not the static buffers: the next
    round's replays leave them as they were."""
    cfg = ForecasterConfig()
    params = _params(cfg, cuda)
    x, y, bidx = _round(cuda, 1)
    loc, loss = client.local_update(params, x, y, bidx, LR, cfg, LOSS)
    kept = [t.clone() for t in tree_leaves(loc)] + [loss.clone()]
    x, y, bidx = _round(cuda, 2)
    again, _ = client.local_update(params, x, y, bidx, LR, cfg, LOSS)
    for a, b in zip(tree_leaves(loc) + [loss], kept):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(loc),
                                                     tree_leaves(again)))


@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("gru", 2)])
def test_launches_counted_as_on_the_eager_route(cuda, cell, n_layers):
    """One layer launch and one BPTT launch a layer a step, the capturing
    round and a replaying one alike."""
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers)
    params = _params(cfg, cuda)
    for seed in (1, 2):
        x, y, bidx = _round(cuda, seed)
        ops.reset_launch_counts()
        client.local_update(params, x, y, bidx, LR, cfg, LOSS)
        counts = ops.launch_counts()
        assert counts[f"{cell}_cell"] == STEPS * n_layers
        assert counts[f"{cell}_bptt"] == STEPS * n_layers
        assert sum(counts.values()) == 2 * STEPS * n_layers
