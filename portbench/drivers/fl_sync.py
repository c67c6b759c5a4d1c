"""Driver kind ``fl_sync``: synchronous federated training, the paper's
Algorithm 1, through ``repro_torch.core.fedavg.run_federated_training``.

Set-up makes the clients' series and the initial weights from the seed
and runs the first three rounds through the window's own call: one call
of one round (it builds the layer kernel and pays the first launches),
then one call of two rounds from its result.  Their wall fixes the rounds
R of the window, one call of R rounds from the third round's model, so
that the call lasts about ``--seconds``.  Each call has a seed of its own,
so every round draws other minibatch rows.

``train_windows_per_s`` counts every window of a real client that passes
through local SGD in the call (rounds x local steps x batch x clients)
over the call's wall.  After the window the plain reference follows the
three set-up rounds from the same weights, data and draws, and the
program's losses, its first pseudo-gradient and its change over the three
rounds are held to the reference's.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchlib import arith, compare, data, weights
from benchlib.harness import Outcome, settle
from benchlib.trace import (DeviceTrace, Spans, init_profiler,
                            layer_launches, patched, wrap_span)

def _ref():
    from benchlib.harness import BENCH, load_module
    return load_module(BENCH / "configs" / "forecaster_ref.py",
                       "portbench_forecaster_ref")


class Cell:
    """Sizes, data, initial weights and per-call seeds of one run."""

    def __init__(self, ctx):
        cfg, tr = ctx.config, ctx.traffic
        self.cfg, self.tr, self.device = cfg, tr, ctx.device
        self.n, self.m = tr["clients"], tr["clients_per_round"]
        self.batch, self.epochs = tr["batch_size"], tr["local_epochs"]
        T = tr["days"] * data.STEPS_PER_DAY
        self.n_win = data.train_windows(T, cfg["lookback"], cfg["horizon"])
        self.steps = data.local_steps(self.n_win, self.batch, self.epochs)
        self.series = data.generate_buildings(data.rng_for(ctx.seed, 1),
                                              self.n, tr["days"])
        self.p0 = weights.forecaster_params(ctx.seed, cfg, 1, ctx.device)[0]
        # call seeds: the first round, rounds two and three, the window
        self.seeds = [data.sub_seed(ctx.seed, 2, k) for k in range(3)]

    def windows_per_round(self) -> int:
        return self.steps * self.batch * min(self.m, self.n)

    def fcfg(self):
        from repro_torch.configs.base import ForecasterConfig
        c = self.cfg
        return ForecasterConfig(cell=c["cell"], input_dim=c["input_dim"],
                                hidden_dim=c["hidden_dim"],
                                n_layers=c["n_layers"],
                                lookback=c["lookback"], horizon=c["horizon"])

    def call(self, seed: int, rounds: int, init):
        """One ``run_federated_training`` call; returns its FLResult."""
        from repro_torch.configs.base import FLConfig
        from repro_torch.core import fedavg
        tr = self.tr
        flcfg = FLConfig(n_clients=self.n, clients_per_round=self.m,
                         local_epochs=self.epochs, batch_size=self.batch,
                         rounds=rounds, lr=tr["lr"], loss=tr["loss"],
                         beta=tr["beta"], n_clusters=tr["n_clusters"],
                         server_opt=tr["server_opt"], seed=seed)
        res = fedavg.run_federated_training(self.series, self.fcfg(), flcfg,
                                            init_params=init,
                                            device=self.device)
        return res[-1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_rounds(cell: Cell):
    """The set-up's rounds through the program: (losses of rounds 1-3,
    params after round 1, params after round 3, wall of rounds 2-3)."""
    ra = cell.call(cell.seeds[0], 1, weights.to_numpy(cell.p0))
    _sync(cell.device)
    t = time.perf_counter()
    rb = cell.call(cell.seeds[1], 2, ra.params)
    _sync(cell.device)
    wall = time.perf_counter() - t
    losses = list(ra.loss_history) + list(rb.loss_history)
    return losses, ra.params, rb.params, wall


def reference_rounds(cell: Cell, tf32: bool = False,
                     half_batch: bool = False):
    """The same three rounds through the plain reference: (losses, params
    after round 1, params after round 3), params as host numpy trees."""
    ref = _ref()
    cfg, tr = cell.cfg, cell.tr
    norm, _, _ = data.minmax(cell.series)
    norm = torch.as_tensor(norm, device=cell.device)
    draws = data.round_draws(cell.seeds[0], cell.n, cell.m, 1, cell.n_win,
                             cell.steps, cell.batch) + \
        data.round_draws(cell.seeds[1], cell.n, cell.m, 2, cell.n_win,
                         cell.steps, cell.batch)
    p = {"layers": [{k: v.clone() for k, v in l.items()}
                     for l in cell.p0["layers"]],
         "head": {k: v.clone() for k, v in cell.p0["head"].items()}}
    losses, trees = [], []
    with ref.precision(tf32):
        for sel, bidx in draws:
            p, loss = ref.fl_round(p, norm, sel, bidx, cfg, tr["lr"],
                                   tr["beta"], half_batch=half_batch)
            losses.append(loss)
            trees.append(weights.to_numpy(p))
    return losses, trees[0], trees[-1]


def _flat(tree):
    return [tree["layers"][l][k] for l in range(len(tree["layers"]))
            for k in ("wx", "wh", "b")] + [tree["head"]["w"],
                                           tree["head"]["b"]]


def readings(cell: Cell, got, ref) -> dict:
    """loss_gap, grad_gap, change_gap of (losses, P1, P3) against the
    reference's."""
    p0 = _flat(weights.to_numpy(cell.p0))
    g_ref = compare.leaf_norms(p0, _flat(ref[1]))
    keep = compare.moving_leaves(g_ref)
    return {
        "loss_gap": compare.loss_gap(got[0], ref[0]),
        "grad_gap": compare.norm_gap(compare.leaf_norms(p0, _flat(got[1])),
                                     g_ref, keep),
        "change_gap": compare.norm_gap(
            compare.leaf_norms(p0, _flat(got[2])),
            compare.leaf_norms(p0, _flat(ref[2])), keep),
    }


def _traced(ctx, R, spans, dtrace, stack):
    """In a traced run, spans around the program's layers, and the
    profiler over the window's last round (warmed over the one before)."""
    from repro_torch.core import fedavg, server_opt
    from repro_torch.data import windows
    init_profiler(ctx.device)
    done = [0]

    def step_wrap(fn):
        def wrapper(*a, **kw):
            t0 = time.time_ns()
            out = fn(*a, **kw)
            spans.add("round engine: step", t0, time.time_ns())
            done[0] += 1
            if done[0] == R - 2:
                _sync(ctx.device)
                dtrace.warm()
            elif done[0] == R - 1:
                dtrace.activate()
            elif done[0] == R:
                dtrace.close()
            return out
        return wrapper

    for cm in (
            patched(fedavg.RoundEngine, "step", step_wrap),
            patched(windows.ClientWindowProvider, "round_batch",
                    wrap_span(spans, "data: round_batch")),
            patched(fedavg, "local_update",
                    wrap_span(spans, "local update (host dispatch)")),
            patched(fedavg, "transform_and_aggregate",
                    wrap_span(spans, "aggregate")),
            patched(server_opt, "server_update",
                    wrap_span(spans, "server update")),
            layer_launches(dtrace)):
        stack.enter_context(cm)


def run(ctx) -> Outcome:
    marks = {"imports_s": time.perf_counter() - ctx.t_start}
    cell = Cell(ctx)
    marks["data_weights_s"] = time.perf_counter() - ctx.t_start
    losses, p1, p3, wall_b = program_rounds(cell)
    marks["checked_rounds_s"] = time.perf_counter() - ctx.t_start
    R = max(3 if ctx.trace else 1, round(ctx.seconds / (wall_b / 2)))

    spans = Spans()
    dtrace = DeviceTrace(ctx.device) if ctx.trace else None
    with contextlib.ExitStack() as stack:
        if dtrace is not None:
            _traced(ctx, R, spans, dtrace, stack)
        gc_objects = settle()
        setup_s = time.perf_counter() - ctx.t_start
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        t0 = time.perf_counter()
        res = cell.call(cell.seeds[2], R, p3)
        _sync(ctx.device)
        wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    window_losses = np.asarray(res.loss_history)
    del res
    traced = dtrace.finish(spans) if dtrace is not None else None

    n_windows = cell.windows_per_round() * R
    t_ref = time.perf_counter()
    ref = reference_rounds(cell)
    marks["reference_s"] = time.perf_counter() - t_ref
    r = readings(cell, (losses, p1, p3), ref)
    return Outcome(
        end_to_end={"train_windows_per_s": n_windows / wall},
        setup_s=setup_s, attempted=R,
        failed=int((~np.isfinite(window_losses)).sum()),
        checks=[(k, r[k], ctx.limits[k])
                for k in ("loss_gap", "grad_gap", "change_gap")],
        memory_peak_bytes=int(peak), trace=traced,
        records={"kind": "train", "rounds": R, "local_steps": cell.steps,
                 "window_s": wall,
                 "model_flops": (3 * arith.forward_flops_per_row(cell.cfg)
                                 * n_windows),
                 "spans": dict(spans.items), "trace": traced},
        notes={"rounds": R, "local_steps": cell.steps,
               "windows_per_round": cell.windows_per_round(),
               "window_s": wall, "setup_round_s": wall_b / 2,
               "set_up_losses": [float(v) for v in losses],
               "reference_losses": ref[0], "gc_objects": gc_objects,
               **marks})
