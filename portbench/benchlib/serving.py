"""What the serving drivers share: the deployment built from the seed,
the bookkeeping of answers, and the check against the reference.

The deployment is ``launch/serve.py``'s with ``--checkpoint --clusters``:
a ``ModelRegistry`` with one slot per cluster, a ``ClusterRouter`` over
k-means centroids of the consumers' daily summaries, and a
``ServingEngine`` over both, except that each slot's weights come from the
seed.  The engine runs with ``auto_flush=False``, its documented mode for
a harness that flushes itself: the drivers flush a slot whenever it has
requests queued, one slot after another, so the engine is work-conserving
without a timer of its own.

Each consumer has ``history_days`` of raw readings, sent once at first
contact in set-up (the engine routes the consumer and keeps its min-max
stats), and ``live_days`` more from which its requests' windows are cut.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import arith, compare, data, weights
from benchlib.harness import Outcome, settle
from benchlib.trace import (DeviceTrace, GcWatch, Spans, init_profiler,
                            layer_launches)

ID_BASE = 50_000       # unseen consumers: ids past the training population


class Deployment:
    def __init__(self, ctx):
        from repro_torch.configs.base import ForecasterConfig
        from repro_torch.serving import (ClusterRouter, ModelRegistry,
                                         ServingEngine)
        cfg, tr = ctx.config, ctx.traffic
        self.cfg, self.tr, self.device = cfg, tr, ctx.device
        self.L = cfg["lookback"]
        C, hd = tr["consumers"], tr["history_days"]
        series = data.generate_buildings(data.rng_for(ctx.seed, 1), C,
                                         hd + tr["live_days"])
        cut = hd * data.STEPS_PER_DAY
        self.history, self.live = series[:, :cut], series[:, cut:]
        self.lo, self.hi = self.history.min(1), self.history.max(1)
        self.ids = [ID_BASE + c for c in range(C)]
        self.n_offsets = self.live.shape[1] - self.L + 1
        z = data.daily_summary(self.history, hd)
        self.centroids = data.kmeans(z, tr["clusters"],
                                     data.rng_for(ctx.seed, 3))
        self.params = weights.forecaster_params(ctx.seed, cfg,
                                                tr["clusters"], ctx.device)
        fcfg = ForecasterConfig(cell=cfg["cell"], input_dim=cfg["input_dim"],
                                hidden_dim=cfg["hidden_dim"],
                                n_layers=cfg["n_layers"],
                                lookback=cfg["lookback"],
                                horizon=cfg["horizon"])
        self.registry = ModelRegistry(device=ctx.device)
        for k, p in enumerate(self.params):
            self.registry.publish(p, fcfg, slot=k, generation=1)
        self.engine = ServingEngine(
            self.registry, ClusterRouter(self.centroids),
            max_batch=tr["max_batch"], min_bucket=tr["min_bucket"],
            auto_flush=False, consumer_cache=max(100_000, 2 * C),
            device=ctx.device)
        self.slots = list(range(tr["clusters"]))
        self.engine.warmup()
        # first contact: every consumer's history and its first window
        for c in range(C):
            self.engine.submit(self.ids[c], self.live[c, :self.L],
                               history=self.history[c])
        self.engine.flush()
        sync(ctx.device)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Book:
    """Answers in order of their requests.

    The engine serves a slot's queue first in, first out, in chunks of at
    most ``max_batch``; each chunk's forecasts are views into one array.
    So each slot keeps the indices of its queued requests in order, and a
    flush's chunks take their heads.  The ends of every chunk are matched
    against the consumers the requests came from.  What the book keeps is
    numpy arrays and floats, which the interpreter's cyclic collector does
    not track, so the harness adds nothing to the collector's work.
    """

    def __init__(self, slots):
        self.fifo = {s: [] for s in slots}
        self.idx, self.pred, self.at = [], [], []
        self.mismatched = 0

    def served(self, slot, stats, t, consumer_of):
        q = self.fifo[slot]
        out = []
        for fs in stats:
            n = fs.n_requests
            idx, q[:n] = q[:n], []
            reqs = fs.requests
            if (reqs[0].consumer_id != consumer_of(idx[0])
                    or reqs[-1].consumer_id != consumer_of(idx[-1])):
                self.mismatched += n
                continue
            base = reqs[0].result.base
            self.pred.append(base[:n] if base is not None and
                             reqs[-1].result.base is base
                             else np.stack([r.result for r in reqs]))
            self.idx.append(np.array(idx, np.int64))
            self.at.append(t)
            out.extend(idx)
        return out

    def collect(self, n, horizon):
        """(forecasts (n, horizon), answered mask, done-at times)."""
        pred = np.full((n, horizon), np.nan, np.float32)
        done = np.full(n, np.nan)
        for idx, p, t in zip(self.idx, self.pred, self.at):
            pred[idx] = p
            done[idx] = t
        return pred, ~np.isnan(done), done


class EngineDelta:
    """EngineStats over the window."""

    def __init__(self, engine):
        s = engine.stats
        self.engine = engine
        self.start = (s.flushes, s.busy_s, s.requests, dict(s.by_bucket))

    def read(self):
        s = self.engine.stats
        f0, b0, r0, buckets0 = self.start
        padded = sum(b * (n - buckets0.get(b, 0))
                     for b, n in s.by_bucket.items())
        flushes = s.flushes - f0
        return {"flushes": flushes, "busy_s": s.busy_s - b0,
                "requests": s.requests - r0, "padded_rows": padded}


class Window:
    """A serving run's measured window: in a traced run the profiler over
    its last ``trace_seconds`` (warmed half a second before), the end of
    set-up, the peak memory, the engine's counters and the collector's
    pauses over the window."""

    def __init__(self, ctx, dep: Deployment):
        self.ctx, self.dep = ctx, dep
        self.spans, self.dtrace, self.marks = Spans(), None, []
        if ctx.trace:
            S = ctx.seconds
            init_profiler(ctx.device)
            self.dtrace = DeviceTrace(ctx.device)
            tw = min(ctx.traffic["trace_seconds"], 0.3 * S)
            self.marks = [(S - tw - 0.5, self.dtrace.warm),
                          (S - tw, self.dtrace.activate),
                          (S, self.dtrace.close)]

    def run(self, loop, *args):
        """Close set-up, then ``loop(*args, marks, spans, dtrace)``."""
        dev = self.ctx.device
        delta = EngineDelta(self.dep.engine)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.gc_objects = settle()
        self.setup_s = time.perf_counter() - self.ctx.t_start
        with GcWatch() as gcw, layer_launches(self.dtrace):
            out = loop(*args, self.marks, self.spans, self.dtrace)
        sync(dev)
        self.peak = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)
        self.engine = delta.read()
        self.traced = (self.dtrace.finish(self.spans)
                       if self.dtrace is not None else None)
        self.gc = gcw.summary()
        return out

    def outcome(self, end_to_end, cons, off, pred, answered, wall, notes):
        """Check every answer against the reference and hand back the
        run's Outcome."""
        gap, unanswered = check(self.dep, cons, off, pred, answered)
        eng = self.engine
        return Outcome(
            end_to_end=end_to_end, setup_s=self.setup_s,
            attempted=len(cons), failed=unanswered,
            checks=[("forecast_gap", gap, self.ctx.limits["forecast_gap"]),
                    ("unanswered", float(unanswered), 0.0)],
            memory_peak_bytes=int(self.peak), trace=self.traced,
            records={"kind": "serve", "window_s": wall, "engine": eng,
                     "model_flops": flops(self.dep, int(answered.sum())),
                     "trace": self.traced},
            notes={"requests": len(cons), **notes, "window_s": wall,
                   "flushes": eng["flushes"],
                   "fill": eng["requests"] / max(eng["padded_rows"], 1),
                   **self.gc, "gc_objects": self.gc_objects})


def check(dep: Deployment, cons, off, pred, answered, tf32=False):
    """forecast_gap over every answered request, and the count of requests
    that never got an answer."""
    want = reference(dep, cons[answered], off[answered], tf32)
    gap = compare.forecast_gap(pred[answered], want, dep.lo[cons[answered]],
                               dep.hi[cons[answered]])
    return gap, int((~answered).sum())


def reference(dep: Deployment, cons, off, tf32=False):
    """The plain reference's kWh forecasts of requests (consumer, offset)."""
    from benchlib.harness import BENCH, load_module
    ref = load_module(BENCH / "configs" / "forecaster_ref.py",
                      "portbench_forecaster_ref")
    dev = dep.device
    slot_of = data.nearest(data.daily_summary(dep.history,
                                              dep.tr["history_days"]),
                           dep.centroids)
    win = dep.live[cons[:, None], off[:, None] + np.arange(dep.L)]
    with ref.precision(tf32):
        out = ref.serve(dep.params, torch.as_tensor(win, device=dev),
                        torch.as_tensor(dep.lo[cons], device=dev),
                        torch.as_tensor(dep.hi[cons], device=dev),
                        torch.as_tensor(slot_of[cons], device=dev), dep.cfg)
    return out.cpu().numpy()


def flops(dep: Deployment, n_answered: int) -> int:
    return arith.forward_flops_per_row(dep.cfg) * n_answered

