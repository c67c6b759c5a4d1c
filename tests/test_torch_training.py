"""The port's federated training (the paper's Algorithm 1) against the JAX
package, on the CPU, from the same initial weights.

JAX makes the initial params with its own keying
(``jax.random.fold_in(PRNGKey(seed), cluster id)``, as
``src/repro/core/fedavg.py`` does) and they cross as numpy arrays through
``run_federated_training(init_params=...)``; client selection, holdout,
minibatch indices and k-means replay from the same numpy streams, so the
two runs see the same data in the same order.  Tolerances: the plain
layers with a client axis at 1e-5; ``local_update`` at the reference's own
(``tests/test_pallas_parity.py``: loss rtol 1e-5, params rtol 1e-4 /
atol 1e-5); the training loss history at rtol 1e-4 and the final params at
rtol 1e-3 / atol 1e-5; held-out metrics from equal params at rtol 1e-5.
On the CPU every kernel wrapper computes the plain version; the card tests
are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.configs.base import ForecasterConfig as JForecasterConfig  # noqa: E402
from repro.core import fedavg as jfed  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.core.client import local_update as jlocal_update  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch.configs.base import FLConfig, ForecasterConfig  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.client import local_update  # noqa: E402
from repro_torch.kernels import _cuda, gru_cell, lstm_cell, ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_init(jcfg, seed, cid):
    """The reference's per-cluster init (``fedavg.py``: fold_in, cid -1 ->
    0), as numpy."""
    return _np(jfc.init_forecaster(
        jax.random.fold_in(jax.random.PRNGKey(seed), max(cid, 0)), jcfg))


def _close(got, want, rtol, atol):
    """Every leaf of the port's tree (tensors or numpy) against JAX's."""
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        np.asarray(g.detach() if isinstance(g, torch.Tensor) else g),
        np.asarray(w), rtol=rtol, atol=atol), got, want)


# ------------------------------------------------- layers with a client axis
@pytest.mark.parametrize("M,T,B,I,H", [(1, 8, 5, 1, 8), (3, 8, 7, 1, 16),
                                       (4, 3, 2, 16, 16)])
def test_plain_layers_with_a_client_axis_are_a_loop_over_clients(M, T, B, I,
                                                                 H):
    g = torch.Generator().manual_seed(M * 100 + I)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3  # noqa: E731
    x, h, c = r(M, T, B, I), r(M, B, H), r(M, B, H)
    lw = (r(M, I, 4 * H), r(M, H, 4 * H), r(M, 4 * H))
    gw = (r(M, I, 3 * H), r(M, H, 3 * H), r(M, 3 * H))
    h_seq, c_T = ref.lstm_layer_ref(x, h, c, *lw)
    g_seq = ref.gru_layer_ref(x, h, *gw)
    assert h_seq.shape == g_seq.shape == (M, T, B, H)
    for m in range(M):
        hm, cm = ref.lstm_layer_ref(x[m], h[m], c[m], *(w[m] for w in lw))
        torch.testing.assert_close(h_seq[m], hm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c_T[m], cm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            g_seq[m], ref.gru_layer_ref(x[m], h[m], *(w[m] for w in gw)),
            rtol=1e-5, atol=1e-5)
    # and the CPU wrappers compute exactly the plain layers
    assert torch.equal(ops.lstm_layer(x, h, c, *lw)[0], h_seq)
    assert torch.equal(ops.gru_layer(x, h, *gw), g_seq)


@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("gru", 2)])
def test_stacked_forecast_matches_vmapped_jax(cell, n_layers):
    """``forecast`` with client-stacked params and x (M, B, L, 1) against
    ``jax.vmap(forecaster.forecast)`` over clients, both routes."""
    kw = dict(cell=cell, hidden_dim=16, n_layers=n_layers)
    jcfg, cfg = JForecasterConfig(**kw), ForecasterConfig(**kw)
    M, B = 3, 9
    jstacked = jax.tree.map(lambda *ls: jnp.stack(ls), *[
        jfc.init_forecaster(jax.random.PRNGKey(m), jcfg) for m in range(M)])
    x = np.random.default_rng(4).random((M, B, 8, 1)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p, xx: jfc.forecast(p, xx, jcfg))(
        jstacked, jnp.asarray(x)))
    params = forecaster.params_from_numpy(_np(jstacked))
    for impl in forecaster.CELL_IMPLS:
        got = forecaster.forecast(params, _t(x), cfg, impl)
        assert got.shape == (M, B, cfg.horizon)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the autograd wiring
def _grads(fn, args, needs):
    leaves = [a.clone().requires_grad_(n) for a, n in zip(args, needs)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    w = torch.Generator().manual_seed(9)
    loss = sum((o * torch.randn(o.shape, generator=w)).sum() for o in outs)
    wanted = [t for t, n in zip(leaves, needs) if n]
    return [o.detach() for o in outs], torch.autograd.grad(loss, wanted)


@pytest.mark.parametrize("M", [0, 3])
def test_autograd_functions_match_autograd_through_the_plain_layer(
        M, monkeypatch):
    """LSTMLayer / GRULayer (the kernels' autograd ops) against autograd
    through the plain layer.  On the CPU the forward launch is replaced by
    the plain layer and the backward launch by the plain BPTT, so this
    checks the wiring: the saved inputs and output, the outputs' gradients
    in, one gradient per input that needs it (None for a zero h0 that does
    not), and the x_seq gradient a second layer needs."""
    monkeypatch.setattr(lstm_cell, "_launch", ref.lstm_layer_ref)
    monkeypatch.setattr(gru_cell, "_launch", ref.gru_layer_ref)
    monkeypatch.setattr(lstm_cell, "_launch_bptt", ref.lstm_layer_bptt_ref)
    monkeypatch.setattr(gru_cell, "_launch_bptt", ref.gru_layer_bptt_ref)
    lead = (M,) if M else ()
    T, B, I, H = 5, 4, 3, 8
    g = torch.Generator().manual_seed(M)
    r = lambda *s: torch.randn(lead + s, generator=g) * 0.3  # noqa: E731
    x, h, c = r(T, B, I), torch.zeros(lead + (B, H)), r(B, H)
    for fn, plain, args, needs in (
            (lstm_cell.LSTMLayer.apply, ref.lstm_layer_ref,
             (x, h, c, r(I, 4 * H), r(H, 4 * H), r(4 * H)),
             (True, False, True, True, True, True)),
            (gru_cell.GRULayer.apply, ref.gru_layer_ref,
             (x, h, r(I, 3 * H), r(H, 3 * H), r(3 * H)),
             (True, False, True, False, True))):
        outs, grads = _grads(fn, args, needs)
        want_outs, want_grads = _grads(plain, args, needs)
        assert len(grads) == sum(needs)
        for a, b in zip(outs + list(grads), want_outs + list(want_grads)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    # through two GRU layers: the second feeds on the first's h_seq
    w1 = (r(I, 3 * H), r(H, 3 * H), r(3 * H))
    w2 = (r(H, 3 * H), r(H, 3 * H), r(3 * H))

    def two(fn):
        def f(x_seq, *w):
            return fn(fn(x_seq, h, *w[:3]), h, *w[3:])
        return f

    args, needs = (x, *w1, *w2), (True,) * 7
    (_, grads), (_, want) = (_grads(two(gru_cell.GRULayer.apply), args,
                                    needs),
                             _grads(two(ref.gru_layer_ref), args, needs))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M", [0, 3])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_bptt_matches_autograd_through_the_plain_layer(cell, M):
    """``ref.lstm_layer_bptt_ref`` / ``ref.gru_layer_bptt_ref``, the plain
    versions of the BPTT kernels, walked step by step from the saved
    h_seq, against autograd through the plain layer (``ref.plain_vjp``) at
    rtol / atol 1e-6, with and without the client axis; an input that
    needs no gradient gets None."""
    lead = (M,) if M else ()
    T, B, I, H = 5, 4, 3, 8
    G = 4 if cell == "lstm" else 3
    g = torch.Generator().manual_seed(M + G)
    r = lambda *s: torch.randn(lead + s, generator=g) * 0.3  # noqa: E731
    x, h, c = r(T, B, I), r(B, H), r(B, H)
    w = (r(I, G * H), r(H, G * H), r(G * H))
    g_h = r(T, B, H) * 3
    if cell == "lstm":
        args, cot = (x, h, c, *w), (g_h, r(B, H) * 3)
        h_seq = ref.lstm_layer_ref(*args)[0]
        fn, bptt = ref.lstm_layer_ref, ref.lstm_layer_bptt_ref
    else:
        args, cot = (x, h, *w), (g_h,)
        h_seq = ref.gru_layer_ref(*args)
        fn, bptt = ref.gru_layer_ref, ref.gru_layer_bptt_ref
    for needs in ((True,) * len(args), (False, False) + (True,) * (len(args)
                                                                 - 2)):
        got = bptt(*args, h_seq, *cot, needs)
        want = ref.plain_vjp(fn, args, needs, cot)
        assert len(got) == len(args)
        for a, b, n in zip(got, want, needs):
            if not n:
                assert a is None and b is None
                continue
            assert a.shape == b.shape and a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_never_launch(monkeypatch):
    """CPU tensors take the plain layer even where autograd records."""
    def refuse(*a):
        raise AssertionError("launched on CPU tensors")

    monkeypatch.setattr(lstm_cell, "_launch", refuse)
    monkeypatch.setattr(gru_cell, "_launch", refuse)
    x = torch.zeros(2, 8, 4, 1, requires_grad=True)
    h = torch.zeros(2, 4, 8)
    lw = [torch.zeros(2, 1, 32), torch.zeros(2, 8, 32), torch.zeros(2, 32)]
    gw = [torch.zeros(2, 1, 24), torch.zeros(2, 8, 24), torch.zeros(2, 24)]
    ops.lstm_layer(x, h, h, *lw)[0].sum().backward()
    ops.gru_layer(x, h, *gw).sum().backward()


def test_client_axis_dims_and_plan():
    """cell_dims takes (M, T, B, I) with (M, B, H); cell_plan spreads one
    wave over M x ceil(B / rows) x cluster blocks: 4 rows a block at the
    training shape (M=100, B=64), the serving plans unchanged at M=1."""
    z = torch.zeros
    for name in ("lstm_cell", "gru_cell"):
        assert _cuda.cell_dims(name, z(100, 8, 64, 1), z(100, 64, 64)) == \
            (8, 64, 1, 64)
        with pytest.raises(ValueError, match="outside the kernel's range"):
            _cuda.cell_dims(name, z(0, 8, 64, 1), z(0, 64, 64))
        with pytest.raises(ValueError, match="4-D"):
            _cuda.cell_dims(name, z(3, 8, 64, 1), z(64, 64))
        assert _cuda.cell_plan(name, 64, 1, 64, 4, 132, M=100) == \
            (1, 4, 2, 4, 512)
        assert _cuda.cell_plan(name, 256, 1, 64, 4, 132, M=1) == \
            _cuda.cell_plan(name, 256, 1, 64, 4, 132) == (1, 2, 2, 4, 256)
    assert _cuda.cell_plan("gru_cell", 64, 64, 64, 4, 132, M=100) == \
        (1, 4, 2, 4, 512)


# ------------------------------------------------------------- local update
def _client_data(M, n_win=40, steps=6, B=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((M, n_win, 8, 1)).astype(np.float32)
    y = r.random((M, n_win, 4)).astype(np.float32)
    bidx = r.integers(0, n_win, (M, steps, B))
    return x, y, bidx


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("gru", 2)])
def test_local_update_matches_vmapped_jax(cell, n_layers, prox_mu):
    """All M = 3 clients at once against ``jax.vmap(local_update)`` of the
    reference (``cell_impl="jnp"``), FedProx on and off."""
    kw = dict(cell=cell, hidden_dim=8, n_layers=n_layers)
    jcfg, cfg = JForecasterConfig(**kw), ForecasterConfig(**kw)
    params = _jax_init(jcfg, 3, 0)
    x, y, bidx = _client_data(3)
    jloc, jl = jax.vmap(jlocal_update, in_axes=(None, 0, 0, 0, None, None,
                                                None, None, None))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(bidx), 0.05, jcfg, jloss.make_loss("ew_mse", 2.0),
        "jnp", prox_mu)
    loc, lo = local_update(forecaster.params_from_numpy(params), _t(x),
                           _t(y), _t(bidx), 0.05, cfg,
                           losses.make_loss("ew_mse", 2.0), "kernel",
                           prox_mu)
    assert lo.shape == (3,)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jl), rtol=1e-5)
    _close(loc, _np(jloc), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_local_update_matches_jax_pallas_cells(cell):
    """One client against the reference's ``cell_impl="pallas"`` (the Pallas
    cells in interpret mode, their custom_vjp backward)."""
    jcfg, cfg = JForecasterConfig(cell=cell, hidden_dim=8), \
        ForecasterConfig(cell=cell, hidden_dim=8)
    params = _jax_init(jcfg, 5, 0)
    x, y, bidx = _client_data(1, steps=3, seed=1)
    loss = jloss.make_loss("mse")
    jp, jl = jlocal_update(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(x[0]), jnp.asarray(y[0]),
                           jnp.asarray(bidx[0]), 0.05, jcfg, loss, "pallas")
    loc, lo = local_update(forecaster.params_from_numpy(params), _t(x),
                           _t(y), _t(bidx), 0.05, cfg,
                           losses.make_loss("mse"))
    np.testing.assert_allclose(float(lo[0]), float(jl), rtol=1e-5)
    _close(jax.tree.map(lambda t: t[0], loc), _np(jp), rtol=1e-4, atol=1e-5)


def test_fedprox_term_turns_a_non_finite_delta_into_nan_as_jax_does():
    """prox_mu = 0 still adds ``0 * (w - anchor)``: a forget-gate bias of
    +inf keeps the forward finite (the gate saturates, its gradient is 0),
    but ``inf - inf`` in the proximal term is NaN, in the port as in
    ``jax.vmap(local_update)``; NaN where the reference has NaN, the rest
    at the local-update tolerances."""
    jcfg, cfg = JForecasterConfig(hidden_dim=8), ForecasterConfig(hidden_dim=8)
    params = jax.tree.map(np.array, _jax_init(jcfg, 3, 0))
    params["layers"][0]["b"][jcfg.hidden_dim] = np.inf
    x, y, bidx = _client_data(2, steps=4)
    jloc, jl = jax.vmap(jlocal_update, in_axes=(None, 0, 0, 0, None, None,
                                                None, None, None))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(bidx), 0.05, jcfg, jloss.make_loss("mse"), "jnp", 0.0)
    loc, lo = local_update(forecaster.params_from_numpy(params), _t(x),
                           _t(y), _t(bidx), 0.05, cfg,
                           losses.make_loss("mse"), "kernel", 0.0)
    assert np.isnan(np.asarray(jl)).all()
    np.testing.assert_allclose(lo.numpy(), np.asarray(jl), rtol=1e-5)
    _close(loc, _np(jloc), rtol=1e-4, atol=1e-5)      # NaN where JAX has


@pytest.mark.parametrize("lr,diverges", [(0.05, True), (0.02, False)])
def test_gru2_building_6_from_the_ports_init_in_jax(tmp_path, lr, diverges):
    """The open GRU-2 question: the port's seed-0 init of the 2-layer GRU,
    carried through the ``.npz`` format into the JAX ``RoundEngine.step``
    for building 6's first round of the phase-6 configuration (20 CA
    buildings x 60 days, 68 local steps of 64, ew_mse beta 2).  At lr 0.05
    the reference diverges too (its loss and params go non-finite), as the
    port does; at 0.02 both train.  The divergence belongs to that init
    and lr, not to the port, so the lr cut stands."""
    from repro import checkpoint as jck
    from repro_torch import checkpoint as tck
    from repro_torch.data import partition
    from repro_torch.models.layers import seeded_generator, tree_leaves

    kw = dict(n_clients=20, clients_per_round=20, local_epochs=1,
              batch_size=64, rounds=1, lr=lr, loss="ew_mse", beta=2.0,
              n_clusters=0, seed=0, cluster_days=45)
    jcfg = JForecasterConfig(cell="gru", n_layers=2)
    cfg = ForecasterConfig(cell="gru", n_layers=2)
    series = synthetic.generate_buildings("CA", list(range(20)), days=60)
    prov = fedavg._as_provider(series, cfg)
    steps = partition.local_steps(prov.n_win_max, 64, 1)
    holdout_rng, rng = fedavg._seed_rngs(0)
    train_ids, _ = partition.holdout_clients(holdout_rng, 20, 0.0)
    te = fedavg.RoundEngine(cfg, FLConfig(**kw), device=CPU)
    counts = prov.train_counts.astype(np.float32)
    sel = te.select(rng, train_ids, 20, 0, counts[train_ids])
    bidx = partition.ragged_minibatch_indices(rng, counts[sel], steps, 64)
    x, y, w = prov.round_batch(sel)
    i = slice(int(np.flatnonzero(sel == 6)[0]), None)
    i = slice(i.start, i.start + 1)                   # building 6 alone
    init = forecaster.init_forecaster(seeded_generator(0, 0), cfg)
    tck.save(tmp_path / "gru2", init)
    flat, _ = jck.load_arrays(tmp_path / "gru2.npz")
    jp = jck.unflatten_like(jfc.init_forecaster(jax.random.PRNGKey(0),
                                                jcfg), flat)
    je = jfed.RoundEngine(jcfg, JFLConfig(**kw))
    from repro.core import server_opt as jso
    jp, _, jl = je.step(jp, jso.init_server_state(jp), jnp.asarray(x[i]),
                        jnp.asarray(y[i]), jnp.asarray(bidx[i]), w[i],
                        round_idx=0)
    tp, ts = te.init(params=init)
    tp, _, tl = te.step(tp, ts, x[i], y[i], bidx[i], w[i], round_idx=0)
    jfinite = bool(np.isfinite(float(jl))) and all(
        np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(jp))
    tfinite = bool(np.isfinite(float(tl))) and all(
        torch.isfinite(t).all() for t in tree_leaves(tp))
    assert jfinite == tfinite == (not diverges)
    if not diverges:
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


# ----------------------------------------------------- federated training
def _fl_pair(n_clients, days, kw, hidden=8):
    jcfg, cfg = JForecasterConfig(hidden_dim=hidden), \
        ForecasterConfig(hidden_dim=hidden)
    series = synthetic.generate_buildings("CA", list(range(n_clients)),
                                          days=days)
    want = jfed.run_federated_training(series, jcfg, JFLConfig(**kw))
    init = {cid: _jax_init(jcfg, kw.get("seed", 0), cid) for cid in want}
    got = fedavg.run_federated_training(series, cfg, FLConfig(**kw),
                                        init_params=init, device=CPU)
    return want, got, jcfg, cfg


def _same_run(want, got):
    assert got.keys() == want.keys()
    for cid in want:
        w, g = want[cid], got[cid]
        np.testing.assert_allclose(g.loss_history, w.loss_history, rtol=1e-4)
        _close(g.params, _np(w.params), rtol=1e-3, atol=1e-5)
        np.testing.assert_array_equal(g.sim_times, w.sim_times)
        np.testing.assert_array_equal(g.eps_history, w.eps_history)
        assert g.privacy == w.privacy
        for k in ("cluster_centroids", "cluster_assignments",
                  "heldout_clients"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert all(isinstance(v, np.ndarray) for v in
                   jax.tree.leaves(g.params))
    return max(float(np.max(np.abs(g.loss_history - w.loss_history)
                            / np.abs(w.loss_history)))
               for g, w in ((got[c], want[c]) for c in want))


def test_federated_training_matches_jax():
    """Plain FedAvg, no clusters: 5 clients, 4 per round, 3 rounds."""
    kw = dict(n_clients=5, clients_per_round=4, rounds=3, n_clusters=0,
              lr=0.05, batch_size=16)
    want, got, _, _ = _fl_pair(5, 4, kw)
    assert list(got) == [-1] and len(got[-1].loss_history) == 3
    _same_run(want, got)


def test_clustered_training_with_holdout_and_fedadam_matches_jax():
    """k-means into 2 clusters over the training clients, a quarter held
    out, fedadam on the server; then both packages score 3 unseen buildings
    with the port's trained params."""
    kw = dict(n_clients=8, clients_per_round=8, rounds=3, n_clusters=2,
              cluster_days=3, holdout_frac=0.25, server_opt="fedadam",
              server_lr=0.05, lr=0.05, batch_size=16)
    want, got, jcfg, cfg = _fl_pair(8, 4, kw)
    assert len(got) == 2 and len(got[0].heldout_clients) == 2
    _same_run(want, got)
    unseen = synthetic.generate_buildings("FLO", [900, 901, 902], days=5)
    for res in got.values():
        w = jfed.evaluate_unseen_clients(jax.tree.map(jnp.asarray,
                                                      res.params),
                                         unseen, jcfg)
        g = fedavg.evaluate_unseen_clients(res.params, unseen, cfg,
                                           device=CPU)
        for k in ("rmse", "mape", "accuracy", "per_horizon_accuracy"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)


@pytest.mark.slow
def test_quickstart_workload_matches_jax():
    """``examples/quickstart.py``: 12 CA buildings, 60 days, H=32, 20
    rounds, ew_mse beta 2, no clusters, lr 0.05."""
    kw = dict(n_clients=12, clients_per_round=12, rounds=20, loss="ew_mse",
              beta=2.0, n_clusters=0, lr=0.05)
    want, got, _, _ = _fl_pair(12, 60, kw, hidden=32)
    _same_run(want, got)


def test_aggregation_and_result_readouts_match_jax():
    r = np.random.default_rng(6)
    stacked = {"layers": [{"wx": r.normal(size=(5, 1, 32)).astype(np.float32),
                           "b": r.normal(size=(5, 32)).astype(np.float32)}]}
    w = np.array([3.0, 0.0, 1.0, 2.5, 7.0], np.float32)
    tstacked = jax.tree.map(torch.from_numpy, stacked)
    jstacked = jax.tree.map(jnp.asarray, stacked)
    _close(fedavg.fedavg_aggregate(tstacked),
           jfed.fedavg_aggregate(jstacked), rtol=1e-6, atol=0)
    _close(fedavg.weighted_aggregate(tstacked, torch.from_numpy(w)),
           jfed.weighted_aggregate(jstacked, jnp.asarray(w)), rtol=1e-6,
           atol=1e-7)
    hist = np.array([0.5, np.nan, 0.2, 0.1, np.nan])
    sim = np.arange(1.0, 6.0)
    t, j = fedavg.FLResult({}, hist, sim_times=sim), \
        jfed.FLResult({}, hist, sim_times=sim)
    for target in (0.3, 0.1, 0.05):
        np.testing.assert_array_equal(fedavg.time_to_target(t, target),
                                      jfed.time_to_target(j, target))
    assert fedavg.final_loss(t) == jfed.final_loss(j) == 0.1


def test_evaluate_global_matches_jax():
    jcfg, cfg = JForecasterConfig(hidden_dim=8), ForecasterConfig(hidden_dim=8)
    params = _jax_init(jcfg, 1, 0)
    r = np.random.default_rng(2)
    x = r.random((700, 8, 1)).astype(np.float32)     # 700: padded batches
    y = r.random((700, 4)).astype(np.float32)
    stats = (r.random((700, 1)) * 3, 4 + r.random((700, 1)) * 10)
    for st in (None, stats):
        w = jfed.evaluate_global(jax.tree.map(jnp.asarray, params), x, y,
                                 jcfg, stats=st, batch=256)
        g = fedavg.evaluate_global(params, x, y, cfg, stats=st, batch=256,
                                   device=CPU)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)


# ---------------------------------------------------- entry points, refusals
def test_train_cli_on_cpu(capsys):
    out = ttrain.main(["--device", "cpu", "--clients", "4", "--rounds", "2",
                       "--days", "4", "--heldout", "2", "--batch-size",
                       "32", "--hidden", "8"])
    assert out["rounds"] == 2 and out["clients_per_round"] == 4
    assert out["local_steps_per_round"] == 9          # ceil(277 / 32)
    assert 0 <= out["heldout"]["accuracy"] <= 100
    assert out["launches_train"]["lstm_cell"] == 0    # plain on the CPU
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("{") and '"wall_s_per_round"' in last
    out = ttrain.main(["--device", "cpu", "--clients", "6", "--rounds", "1",
                       "--days", "4", "--heldout", "3", "--clusters", "2",
                       "--cell", "gru", "--hidden", "8"])
    assert out["clusters"] == 2


@pytest.mark.parametrize("kw,item", [
    (dict(aggregation="hierarchical"), "A9"),
    (dict(mode="semi_sync"), "A10"), (dict(absent_prob=0.1), "A10"),
])
def test_unported_stages_raise_naming_their_roadmap_item(kw, item):
    """A9 and A10 are ported: what the engine refused naming them now
    builds as the reference's engine does, and hierarchical aggregation
    without a mesh raises the reference's ValueError."""
    if item == "A9":
        for engine in (lambda: jfed.RoundEngine(JForecasterConfig(),
                                                JFLConfig(**kw)),
                       lambda: fedavg.RoundEngine(ForecasterConfig(),
                                                  FLConfig(**kw),
                                                  device=CPU)):
            with pytest.raises(ValueError, match="requires a mesh"):
                engine()
        return
    j = jfed.RoundEngine(JForecasterConfig(), JFLConfig(**kw))
    t = fedavg.RoundEngine(ForecasterConfig(), FLConfig(**kw), device=CPU)
    assert (t.dispatch_m(8, 5), t.buffer_k, t.sim_time) == \
        (j.dispatch_m(8, 5), j.buffer_k, j.sim_time)


def test_unported_driver_options_raise(tmp_path):
    """A mesh and a checkpoint path, once refused, now run: on a one-rank
    mesh, writing a checkpoint, the run equals the plain one bit for
    bit."""
    from repro_torch import checkpoint
    from repro_torch.core import aggregation
    series = synthetic.generate_buildings("CA", [0, 1], days=2)
    kw = dict(n_clients=2, clients_per_round=2, rounds=2, n_clusters=0,
              batch_size=32)
    cfg = ForecasterConfig(hidden_dim=8)
    plain = fedavg.run_federated_training(series, cfg, FLConfig(**kw),
                                          device=CPU)[-1]
    ck = tmp_path / "ck"
    got = fedavg.run_federated_training(series, cfg, FLConfig(**kw),
                                        mesh=aggregation.make_mesh(),
                                        checkpoint_path=ck, device=CPU)[-1]
    np.testing.assert_array_equal(got.loss_history, plain.loss_history)
    jax.tree.map(np.testing.assert_array_equal, got.params, plain.params)
    assert checkpoint.generation(ck) == 2


def test_training_entry_points_default_to_the_card(monkeypatch):
    """device=None means CUDA: without a card nothing trains on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    series = synthetic.generate_buildings("CA", [0, 1], days=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedavg.RoundEngine(ForecasterConfig(), FLConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        fedavg.run_federated_training(series, ForecasterConfig(),
                                      FLConfig(n_clusters=0, rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        fedavg.evaluate_global(forecaster.params_to_numpy(
            forecaster.init_forecaster(torch.Generator().manual_seed(0),
                                       ForecasterConfig())),
            np.zeros((4, 8, 1), np.float32), np.zeros((4, 4), np.float32),
            ForecasterConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--clients", "2", "--rounds", "1", "--days", "2"])
