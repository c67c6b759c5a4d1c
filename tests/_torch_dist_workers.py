"""Rank programs for the port's multi-process tests
(``tests/test_torch_aggregation.py``): each runs in a process spawned by
:func:`spawn`, joins a gloo process group through a file in the test's
temporary directory, runs its part of a round engine on the CPU and writes
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
