"""The port's aggregation topologies (``repro_torch/core/aggregation.py``)
and the rank-sharded round of ``core/fedavg.py`` against the JAX package
and against the port's own local round, on the CPU.

A mesh here is ``torch.distributed`` ranks: the multi-rank tests spawn
gloo ranks through ``torch.multiprocessing`` (``tests/_torch_dist_workers
.py``), each with a file rendezvous in the test's temporary directory, an
init timeout of 60 s and a join with a time limit, so a hang fails in
seconds.  Four ranks run each round once for every case (one spawn per
module); the tests read what they wrote.

Round inputs are the reference's mesh padding: 4 real clients cycled up to
8 slots, the duplicates at weight 0 (``tests/test_pipeline_api.py``'s
hierarchical test).  Tolerances:

* one rank (no process group, or a gloo group of one): bit-equal to the
  local round;
* flat over 4 ranks and hierarchical 2 x 2 against the local round: the
  reference's hier == flat pin, loss rtol 1e-6, params rtol 1e-6 /
  atol 1e-7 (``tests/test_pipeline_api.py:281-282``);
* against the JAX engine fed the same padded arrays: the local-update
  tolerances, loss rtol 1e-5, params rtol 1e-4 / atol 1e-5
  (``tests/test_pallas_parity.py:43-46``);
* ring-masked rounds: params bit-equal across local, flat and
  hierarchical, and equal to the ring-clear round (integer sums);
* run_federated_training on a mesh (selection padded to it): the training
  tolerances of ``tests/test_torch_training.py`` (loss rtol 1e-4, params
  rtol 1e-3 / atol 1e-5) against JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _torch_dist_workers as workers  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.configs.base import ForecasterConfig as JForecasterConfig  # noqa: E402
from repro.core import fedavg as jfed  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.core import server_opt as jso  # noqa: E402
from repro.data import synthetic, windows  # noqa: E402
from repro.models import forecaster as jfc  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import (AggregationConfig, FLConfig,  # noqa: E402
                                      ForecasterConfig)
from repro_torch.core import aggregation, fedavg, losses  # noqa: E402
from repro_torch.models.layers import sorted_leaves  # noqa: E402

CPU = "cpu"
FCFG_KW = dict(hidden_dim=8)
JCFG, CFG = JForecasterConfig(**FCFG_KW), ForecasterConfig(**FCFG_KW)
BASE = dict(n_clients=4, clients_per_round=8, rounds=1, n_clusters=0,
            loss="mse", lr=0.05, seed=3)
CASES = {
    "identity": BASE,
    "clip": dict(BASE, dp_clip=0.5, server_opt="fedavg_weighted"),
    "ring_masked": dict(BASE, dp_clip=1.0, dp_noise=0.5, quantize_bits=8,
                        secure_agg=True),
    "ring_clear": dict(BASE, dp_clip=1.0, dp_noise=0.5, quantize_bits=8,
                       quantize_ring=True),
}
TRAIN = dict(n_clients=6, clients_per_round=3, rounds=2, n_clusters=0,
             batch_size=32, lr=0.05, seed=0)          # 3 -> 4 on 4 ranks
TOPOLOGIES = ("flat", "hierarchical")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in sorted_leaves(tree)]


def _close(got, want, rtol, atol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _equal(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def padded():
    """4 CA clients x 12 days cycled to 8 slots, weight 0 on the copies;
    3 local steps of 16; JAX-made params (numpy)."""
    series = synthetic.generate_buildings("CA", list(range(4)), days=12)
    data = windows.batched_client_windows(series, JCFG.lookback,
                                          JCFG.horizon)
    idx = np.resize(np.arange(4), 8)
    bidx = np.random.default_rng(0).integers(
        0, data["x_train"].shape[1], size=(4, 3, 16))
    counts = np.asarray([17.0, 5.0, 29.0, 11.0, 0, 0, 0, 0], np.float32)
    params = _np(jfc.init_forecaster(jax.random.PRNGKey(0), JCFG))
    return (params, data["x_train"][idx], data["y_train"][idx], bidx[idx],
            counts)


def _port_round(kw, padded, mesh=None, **extra):
    params, x, y, bidx, counts = padded
    e = fedavg.RoundEngine(CFG, FLConfig(**kw, **extra), mesh=mesh,
                           loss=losses.make_loss("mse"), device=CPU)
    p, s = e.init(params=params)
    p, s, loss = e.step(p, s, x, y, bidx, counts, round_idx=1, stream=2)
    return p, float(loss)


def _train_series():
    return synthetic.generate_buildings("CA", list(range(6)), days=6)


def _train_init():
    return _np(jfc.init_forecaster(jax.random.fold_in(
        jax.random.PRNGKey(TRAIN["seed"]), 0), JCFG))


@pytest.fixture(scope="module")
def four_ranks(padded, tmp_path_factory):
    """Every case on 4 gloo ranks, flat and hierarchical 2 x 2, and
    run_federated_training on a 2-round run whose 3-client selection pads to 4: rank ->
    {case/topology: {"params", "loss"}} (flat views)."""
    cases = {k: {"cfg": v} for k, v in CASES.items()}
    cases["train"] = {"cfg": TRAIN, "series": _train_series(),
                      "init": _train_init()}
    params, x, y, bidx, counts = padded
    files = workers.spawn(workers.sync_rounds, 4,
                          tmp_path_factory.mktemp("ranks4"), FCFG_KW, cases,
                          2, params, x, y, bidx, counts)
    out = []
    for f in files:
        flat, _ = checkpoint.load_arrays(f)
        out.append(flat)
    return out


def _params_at(flat, prefix):
    """The forecaster's param tree stored under ``prefix`` (numpy)."""
    return {"layers": [{k: flat[f"{prefix}layers/0/{k}"].numpy()
                        for k in ("b", "wh", "wx")}],
            "head": {k: flat[f"{prefix}head/{k}"].numpy() for k in ("b", "w")}}


def _rank_result(flat, key):
    return _params_at(flat, f"{key}/params/"), flat[f"{key}/loss"].numpy()


# ------------------------------------------------------ mesh and validation
def test_make_mesh_without_a_process_group_is_one_rank():
    assert not dist.is_initialized()
    flat = aggregation.make_mesh()
    assert flat.axis_names == ("clients",) and flat.shape == {"clients": 1}
    assert (flat.size, flat.index, flat.distributed) == (1, 0, False)
    hier = aggregation.make_mesh(FLConfig(aggregation="hierarchical"))
    assert hier.axis_names == ("region", "clients")
    assert hier.shape == {"region": 1, "clients": 1}
    x = torch.arange(4.0)
    assert aggregation.make_aggregator("hierarchical", hier).reduce(x) is x
    with pytest.raises(ValueError, match="does not divide"):
        aggregation.make_mesh(AggregationConfig(kind="hierarchical",
                                                n_regions=2))


def test_make_aggregator_validates_axes_eagerly():
    flat = aggregation.make_mesh()
    hier = aggregation.make_mesh(AggregationConfig(kind="hierarchical"))
    assert isinstance(aggregation.make_aggregator(None),
                      aggregation.LocalAggregator)
    assert isinstance(aggregation.make_aggregator("hierarchical"),
                      aggregation.LocalAggregator)
    assert isinstance(aggregation.make_aggregator(FLConfig(), flat),
                      aggregation.FlatAggregator)
    assert aggregation.make_aggregator(
        AggregationConfig(kind="hierarchical"), hier).mesh_axes == \
        ("region", "clients")
    with pytest.raises(ValueError, match="mesh axes"):
        aggregation.make_aggregator("flat", hier)
    with pytest.raises(ValueError, match="mesh axes"):
        aggregation.make_aggregator("hierarchical", flat)


def test_hierarchical_engine_needs_a_mesh():
    kw = dict(BASE, aggregation="hierarchical")
    with pytest.raises(ValueError, match="requires a mesh"):
        fedavg.RoundEngine(CFG, FLConfig(**kw), device=CPU)
    fedavg.RoundEngine(CFG, FLConfig(**kw), device=CPU,
                       mesh=aggregation.make_mesh(FLConfig(**kw)))


def test_a_block_that_does_not_split_raises(padded, monkeypatch):
    mesh = aggregation.make_mesh()
    monkeypatch.setattr(mesh, "shape", {"clients": 3})
    monkeypatch.setattr(mesh, "coords", {"clients": 0})
    with pytest.raises(ValueError, match="do not split"):
        _port_round(BASE, padded, mesh=mesh)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_one_rank_mesh_equals_the_local_round_bitwise(padded, tmp_path, case,
                                                      topo):
    """A mesh of one rank, without a process group and on a gloo group of
    one (the collective runs), gives the local round bit for bit."""
    want_p, want_l = _port_round(CASES[case], padded)
    acfg = AggregationConfig(kind=topo)
    got = [_port_round(CASES[case], padded, aggregation.make_mesh(acfg),
                       aggregation=topo)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = aggregation.make_mesh(acfg)
        assert mesh.distributed and mesh.size == 1
        got.append(_port_round(CASES[case], padded, mesh, aggregation=topo))
    finally:
        dist.destroy_process_group()
    for p, loss in got:
        _equal(p, want_p)
        assert loss == want_l


# -------------------------------------------------------------- four ranks
@pytest.mark.parametrize("case", ["identity", "clip"])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_four_ranks_match_the_local_round(padded, four_ranks, case, topo):
    want_p, want_l = _port_round(CASES[case], padded)
    results = [_rank_result(f, f"{case}/{topo}") for f in four_ranks]
    for p, loss in results:
        np.testing.assert_allclose(loss[0], want_l, rtol=1e-6)
        _close(p, want_p, rtol=1e-6, atol=1e-7)
    for p, loss in results[1:]:               # every rank holds one model
        _equal(p, results[0][0])
        assert loss[0] == results[0][1][0]


@pytest.mark.parametrize("case", ["identity", "clip"])
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_four_ranks_match_the_jax_engine(padded, four_ranks, case, topo):
    params, x, y, bidx, counts = padded
    je = jfed.RoundEngine(JCFG, JFLConfig(**CASES[case]),
                          loss=jloss.make_loss("mse"))
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, jl = je.step(jp, jso.init_server_state(jp), jnp.asarray(x),
                        jnp.asarray(y), jnp.asarray(bidx), counts,
                        round_idx=1, stream=2)
    p, loss = _rank_result(four_ranks[0], f"{case}/{topo}")
    np.testing.assert_allclose(loss[0], float(jl), rtol=1e-5)
    _close(p, _np(jp), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_ring_masked_rounds_are_bit_equal_across_topologies(padded,
                                                            four_ranks,
                                                            topo):
    """The pairwise masks of the 8-slot cohort cancel whichever rank holds
    each end of a pair: the 4-rank round equals the local one and the
    ring-clear one bit for bit."""
    local_p, local_l = _port_round(CASES["ring_masked"], padded)
    clear_p, _ = _port_round(CASES["ring_clear"], padded)
    _equal(local_p, clear_p)
    for f in four_ranks:
        p, loss = _rank_result(f, f"ring_masked/{topo}")
        _equal(p, local_p)
        _equal(_rank_result(f, f"ring_clear/{topo}")[0], local_p)
        np.testing.assert_allclose(loss[0], local_l, rtol=1e-6)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_training_on_four_ranks_pads_the_selection(four_ranks, topo):
    """run_federated_training on 4 ranks: 3 clients a round padded to 4
    with a weight-0 copy (hierarchical: it builds the 2 x 2 mesh
    itself); the same run as without a mesh and as the JAX package's."""
    series, init = _train_series(), _train_init()
    local = fedavg.run_federated_training(series, CFG, FLConfig(**TRAIN),
                                          init_params=init, device=CPU)[-1]
    want = jfed.run_federated_training(series, JCFG, JFLConfig(**TRAIN))[-1]
    for f in four_ranks:
        p, hist = _rank_result(f, f"train/{topo}")
        np.testing.assert_allclose(hist, local.loss_history, rtol=1e-6)
        _close(p, local.params, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(hist, want.loss_history, rtol=1e-4)
        _close(p, want.params, rtol=1e-3, atol=1e-5)


# ------------------------------------------------------ semi-sync, 2 ranks
SEMI = dict(BASE, mode="semi_sync", over_select=1.0, buffer_k=2,
            staleness_alpha=0.5, stragglers="lognormal",
            straggler_jitter=1.0)


def test_semi_sync_on_two_ranks_holds_equal_buffers(padded, tmp_path):
    """Each rank computes its half of the dispatch and one all_gather
    gives both the whole: after 3 rounds the ranks hold the same pending
    buffer and params bit for bit, and the local engine's losses."""
    params, x, y, bidx, counts = padded
    files = workers.spawn(workers.semi_sync_rounds, 2, tmp_path, FCFG_KW,
                          SEMI, 3, params, x, y, bidx, counts)
    (f0, m0), (f1, m1) = (checkpoint.load_arrays(f) for f in files)
    assert m0["n_pending"] == m1["n_pending"] > 0
    assert sorted(f0) == sorted(f1)
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k
    e = fedavg.RoundEngine(CFG, FLConfig(**SEMI), device=CPU,
                           loss=losses.make_loss("mse"))
    p, s = e.init(params=params)
    hist = []
    for t in range(3):
        p, s, loss = e.step(p, s, x, y, bidx, counts, round_idx=t)
        hist.append(float(loss))
    assert len(e.async_state.pending) == m0["n_pending"]
    assert e.async_state.late_folds > 0
    np.testing.assert_allclose(f0["loss"].numpy(), hist, rtol=1e-6)
    _close(_params_at(f0, "params/"), p, rtol=1e-6, atol=1e-7)
    for i, pend in enumerate(e.async_state.pending):     # the same buffer
        np.testing.assert_array_equal(
            f0[f"async/pending/{i}/delta/head/w"].numpy(),
            pend.delta["head"]["w"])
