"""Rank programs for the port's multi-process tests
(``tests/test_torch_aggregation.py``, ``tests/test_torch_local_sgd.py``):
each runs in a process spawned by :func:`spawn`, joins a gloo process
group through a file in the test's temporary directory, runs its part of
a round engine (or a cross-pod sync) on the CPU and writes
what it computed to ``<out_dir>/rank<r>.npz`` (``repro_torch.checkpoint``
format).  This module imports no JAX, so a spawned rank starts quickly.
"""
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch import checkpoint
from repro_torch.configs.base import (AggregationConfig, FLConfig,
                                      ForecasterConfig)
from repro_torch.core import aggregation, fedavg, losses

INIT_TIMEOUT_S = 60


def spawn(fn, world: int, tmp_dir, *args, timeout_s: float = 120.0):
    """Run ``fn(rank, world, init_file, out_dir, *args)`` in ``world``
    spawned processes and join them within ``timeout_s``; a rank that
    fails raises here, and ranks still running at the limit are killed and
    the call raises ``TimeoutError``.  Returns each rank's output file."""
    out_dir = str(tmp_dir)
    init = os.path.join(out_dir, "pg_init")
    ctx = tmp.start_processes(fn, args=(world, init, out_dir, *args),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.05)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks did not finish within "
                               f"{timeout_s} s")
    return [os.path.join(out_dir, f"rank{r}.npz") for r in range(world)]


def _join(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))


def sync_rounds(rank, world, init, out_dir, fcfg_kw, cases, n_regions,
                params, x, y, bidx, counts):
    """Every case of ``cases`` (name -> {"cfg": FLConfig kwargs}) on a
    flat mesh of every rank and on the (n_regions, world / n_regions)
    hierarchical mesh: one round from ``params`` on the same padded round
    inputs, or, where the case has a ``"series"``, the whole
    ``run_federated_training`` run from its ``"init"`` params."""
    _join(rank, world, init)
    try:
        fcfg = ForecasterConfig(**fcfg_kw)
        meshes = {"flat": aggregation.make_mesh(AggregationConfig()),
                  "hierarchical": aggregation.make_mesh(AggregationConfig(
                      kind="hierarchical", n_regions=n_regions))}
        out = {}
        for name, case in cases.items():
            kw = dict(case["cfg"])
            series = case.get("series")
            for topo, mesh in meshes.items():
                flcfg = FLConfig(**kw, aggregation=topo,
                                 n_regions=n_regions if topo != "flat"
                                 else 0)
                if series is not None:
                    # the whole run: the selection padded to the mesh, and
                    # the hierarchical mesh built by the run itself
                    res = fedavg.run_federated_training(
                        series, fcfg, flcfg, init_params=case["init"],
                        mesh=mesh if topo == "flat" else None, device="cpu")
                    out[f"{name}/{topo}"] = {
                        "params": res[-1].params,
                        "loss": res[-1].loss_history}
                    continue
                e = fedavg.RoundEngine(fcfg, flcfg, mesh=mesh, device="cpu",
                                       loss=losses.make_loss("mse"))
                p, s = e.init(params=params)
                p, s, loss = e.step(p, s, x, y, bidx, counts, round_idx=1,
                                    stream=2)
                out[f"{name}/{topo}"] = {"params": p,
                                         "loss": np.asarray([float(loss)])}
        checkpoint.save(os.path.join(out_dir, f"rank{rank}.npz"), out)
    finally:
        dist.destroy_process_group()


def semi_sync_rounds(rank, world, init, out_dir, fcfg_kw, flcfg_kw, rounds,
                     params, x, y, bidx, counts):
    """``rounds`` semi-synchronous rounds on a flat mesh of every rank:
    each rank's losses, final params and pending buffer."""
    _join(rank, world, init)
    try:
        fcfg = ForecasterConfig(**fcfg_kw)
        e = fedavg.RoundEngine(fcfg, FLConfig(**flcfg_kw), device="cpu",
                               mesh=aggregation.make_mesh(),
                               loss=losses.make_loss("mse"))
        p, s = e.init(params=params)
        hist = []
        for t in range(rounds):
            p, s, loss = e.step(p, s, x, y, bidx, counts, round_idx=t)
            hist.append(float(loss))
        checkpoint.save(os.path.join(out_dir, f"rank{rank}.npz"),
                        {"params": p, "loss": np.asarray(hist),
                         "async": e.async_state.to_tree()},
                        metadata={"n_pending": len(e.async_state.pending)})
    finally:
        dist.destroy_process_group()


def outer_sync(rank, world, init, out_dir, anchor, locals_, cfg_kw):
    """``core/local_sgd.make_sharded_outer`` over the ranks, one pod a
    rank: from ``init_outer_state(anchor)``, one sync per entry of
    ``locals_`` (a list over syncs of each rank's pod params, numpy
    trees), this rank's ``locals_[s][rank]``; writes each sync's anchor
    and momentum."""
    from repro_torch.core import local_sgd
    from repro_torch.models.layers import tree_from_numpy

    _join(rank, world, init)
    try:
        sync = local_sgd.make_sharded_outer(
            dist.group.WORLD, local_sgd.LocalSGDConfig(**cfg_kw))
        state = local_sgd.init_outer_state(tree_from_numpy(anchor))
        out = {}
        for s, per_rank in enumerate(locals_):
            new_anchor, state = sync(tree_from_numpy(per_rank[rank]), state)
            out[f"sync{s}"] = {"anchor": new_anchor,
                               "momentum": state.momentum}
        checkpoint.save(os.path.join(out_dir, f"rank{rank}.npz"), out)
    finally:
        dist.destroy_process_group()


def sharded_lm(rank, world, init, out_dir, arch, params, batch, lr):
    """A ``.reduced()`` LM's forward and one train step (SGD) on a
    (2, world / 2) ``("data", "model")`` mesh under ``launch.mesh``'s
    rules: params laid out by ``pspec_tree``, the batch split over
    ``data``.  Rank 0 writes the gathered logits, loss, and updated
    params."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_from_numpy, tree_map
    from repro_torch.sharding import placements, use_rules
    from repro_torch.sharding.rules import P

    _join(rank, world, init)
    try:
        cfg = get_config(arch).reduced()
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        rules = mesh_mod.make_rules(mesh)
        p = tree_from_numpy(params)
        specs = rules.pspec_tree(p)
        dp = tree_map(lambda t, s: distribute_tensor(
            t, mesh, placements(s, mesh)), p, specs)
        db = {k: distribute_tensor(torch.from_numpy(v), mesh, placements(
            P("data"), mesh)) for k, v in batch.items()}
        opt = optim.sgd()
        step = tf.make_train_step(cfg, opt, dtype=torch.float32,
                                  microbatches=2)
        with use_rules(rules), implicit_replication():
            logits, _, _ = tf.forward(dp, db, cfg, dtype=torch.float32,
                                      remat=False, attn_impl="torch")
            logits = logits.full_tensor()
            dp, _, m = step(dp, opt.init(dp), db, lr)
            loss = m["loss"].full_tensor()
            new = tree_map(lambda t: t.full_tensor(), dp)
        if rank == 0:
            checkpoint.save(os.path.join(out_dir, f"rank{rank}.npz"),
                            {"logits": logits, "loss": loss, "params": new})
    finally:
        dist.destroy_process_group()


def split_ce_and_norms(rank, world, init, out_dir, ce, norms):
    """On a (2, world / 2) ``("data", "model")`` mesh under
    ``launch.mesh``'s rules: ``chunked_weighted_ce`` of ``ce``'s hidden
    states (batch split over data) under its head (laid out by
    ``pspec_tree``: the vocabulary split over model), its loss and the
    gradients of both; and ``rms_norm`` / ``layer_norm`` of ``norms``' x
    with d split over model (batch over data), each output, and the
    gradients of x and the norm's params under the weights ``r``.  Rank 0
    writes the gathered results."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers
    from repro_torch.sharding import placements, use_rules
    from repro_torch.sharding.rules import P

    _join(rank, world, init)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        rules = mesh_mod.make_rules(mesh)

        def lay(a, spec):
            return distribute_tensor(torch.from_numpy(a), mesh,
                                     placements(spec, mesh))
        h = lay(ce["h"], P("data", None, None)).requires_grad_(True)
        w = lay(ce["w_head"], rules.param_pspec(
            ("lm_head",), ce["w_head"].shape)).requires_grad_(True)
        out = {}
        with use_rules(rules), implicit_replication():
            loss = losses.chunked_weighted_ce(
                h, w, lay(ce["labels"], P("data", None)), ce["beta"],
                lay(ce["mask"], P("data", None)), chunk=ce["chunk"])
            gh, gw = torch.autograd.grad(loss, [h, w])
            out["ce"] = {"loss": loss.full_tensor(), "h": gh.full_tensor(),
                         "w_head": gw.full_tensor(),
                         "w_layout": np.asarray(
                             [isinstance(p, Shard) for p in w.placements])}
            split = P("data", None, "model")
            for name, fn, ps in (("rms", layers.rms_norm, ("scale",)),
                                 ("layer", layers.layer_norm,
                                  ("scale", "bias"))):
                x = lay(norms["x"], split).requires_grad_(True)
                args = [lay(norms[k], P(None)).requires_grad_(True)
                        for k in ps]
                y = fn(x, *args)
                loss = torch.sum(y * lay(norms["r"], split))
                grads = torch.autograd.grad(loss, [x, *args])
                out[name] = {"y": y.full_tensor(),
                             "y_split": np.asarray([
                                 isinstance(p, Shard) and p.dim == 2
                                 for p in y.placements]),
                             **{f"g_{k}": g.full_tensor() for k, g in
                                zip(("x",) + ps, grads)}}
        if rank == 0:
            checkpoint.save(os.path.join(out_dir, f"rank{rank}.npz"), out)
    finally:
        dist.destroy_process_group()


def _mask_after_reduce():
    """A broken round on the flat mesh: the deltas are summed over the
    ranks FIRST and clipped after.  The masks of a real masker would still
    cancel in the sum, so no numeric pin catches it; the taint proof
    must."""
    from repro_torch.analysis import taint
    from repro_torch.configs.base import TransformConfig
    from repro_torch.core import prng, transforms
    from repro_torch.models.layers import seeded_generator

    mesh = aggregation.make_mesh()
    stack = transforms.make_stack(TransformConfig(clip_norm=1.0))
    rank = dist.get_rank()
    g = seeded_generator(rank, 1)

    def broken(deltas, keys):
        deltas = taint.tag_private(deltas)
        summed = {k: mesh.all_reduce(v, "clients")
                  for k, v in deltas.items()}
        return stack(summed, keys)

    return taint.analyze(broken, frozenset({"clip"}),
                         {"w": torch.randn((1, 3), generator=g)},
                         prng.fold_in(prng.PRNGKey(rank), torch.arange(1)))


def taint_proofs(rank, world, init, out_dir, device):
    """This rank's taint reports of the mesh topologies: the flat round
    under the full stack and clip-only, the hierarchical 2 x 4 round under
    the full stack, and a round that reduces before it clips; pickled to
    ``<out_dir>/rank<r>.pkl``."""
    import pickle

    from repro_torch.analysis import taint

    _join(rank, world, init)
    try:
        cases = [("flat", taint.full_stack(), taint.secure()),
                 ("flat", taint.clip_only(), None),
                 ("hier", taint.full_stack(), taint.secure())]
        out = taint.mesh_proofs(cases, device) + [_mask_after_reduce()]
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
