"""The traced run's instruments: host spans around the program's layers,
and a profiler trace of the device over a sub-window at the end of the
measured window.

The profiler records only device activity (kernels, copies, fills), so
the host pays CUPTI's bookkeeping and not a record per host op.  It warms
up over the span before the sub-window (its start-up cost lands there)
and its results are read once the window has closed, so their reading
never stalls the measured loop.  Kineto puts device timestamps on the
host's wall clock (``time.time_ns``), which the host spans use too, so
each idle gap of the device can be set against what the host was doing.

The layer kernels are C entries launched through ``ctypes``; where the
trace lists none of them, their device time comes from CUDA events that a
wrapper around the launch records in the sub-window.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

LAYER_KERNELS = ("lstm_layer_kernel", "gru_layer_kernel")
CELL_OF = {"lstm_cell": "lstm", "gru_cell": "gru"}


class Spans:
    """Host spans (label, start ns, end ns) on the wall clock."""

    def __init__(self):
        self.items = defaultdict(list)

    def add(self, label, t0, t1):
        self.items[label].append((t0, t1))



@contextlib.contextmanager
def patched(obj, name, make):
    """Replace ``obj.name`` by ``make(original)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def wrap_span(spans: Spans, label: str):
    def make(fn):
        def wrapper(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                spans.add(label, t0, time.time_ns())
        return wrapper
    return make


@contextlib.contextmanager
def layer_launches(dtrace):
    """In a traced run, route the program's kernel launches through
    :meth:`DeviceTrace.launch_wrapper` for the block."""
    if dtrace is None:
        yield
        return
    from repro_torch.kernels import _cuda
    with patched(_cuda, "launch", dtrace.launch_wrapper):
        yield


def init_profiler(device):
    """Bring CUPTI up once in set-up: a first profiler start on the card
    takes seconds, which inside the window would stall the loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class GcWatch:
    """Pauses of the interpreter's cyclic garbage collector over a span
    (a note beside the metrics: a full collection stalls the host)."""

    def __init__(self):
        self.pauses = []          # (generation, seconds)
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def __enter__(self):
        import gc
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._cb)

    def summary(self):
        full = [d for g, d in self.pauses if g == 2]
        return {"gc_collections": len(self.pauses),
                "gc_full": len(full),
                "gc_full_max_ms": 1e3 * max(full, default=0.0),
                "gc_total_ms": 1e3 * sum(d for _, d in self.pauses)}


class DeviceTrace:
    """A profiler over one sub-window: :meth:`warm` starts it (its
    start-up is discarded), :meth:`activate` opens the sub-window,
    :meth:`close` ends it, :meth:`finish` stops the profiler after the
    measured window and reads the trace."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None
        self.active = False
        self.launches = []            # (cell, M, T, B, I, H, start ev, end ev)

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self.prof = profile(activities=[act],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.start()

    def activate(self):
        self._sync()
        self.prof.step()
        self.active = True
        self.t0 = time.time_ns()

    def close(self):
        self._sync()
        self.t1 = time.time_ns()
        self.active = False

    def launch_wrapper(self, fn):
        """Around ``repro_torch.kernels._cuda.launch``: in the sub-window,
        the layer launches' shapes and CUDA events around each."""
        import torch

        def wrapper(name, tensors, scalars):
            if not self.active or name not in CELL_OF:
                return fn(name, tensors, scalars)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(name, tensors, scalars)
            b.record()
            M, T, B, I, H = (int(v) for v in scalars[:5])
            self.launches.append((CELL_OF[name], M, T, B, I, H, a, b))
            return out
        return wrapper

    def finish(self, spans: Spans, top: int = 10):
        """Stop the profiler and reduce its trace over [t0, t1]: the
        union of device activity, the device ops that took most time, the
        idle gaps by the host span they fall in, and the layer kernels'
        device time and launch shapes."""
        from torch.autograd import DeviceType

        self.prof.stop()
        t0, t1 = self.t0, self.t1
        want = DeviceType.CUDA if self.device.type == "cuda" else None
        iv, by_name, layer_ns, layer_n = [], defaultdict(int), 0, 0
        for e in self.prof.profiler.kineto_results.events():
            if want is None or e.device_type() != want:
                continue
            s = e.start_ns()
            f = s + e.duration_ns()
            s, f = max(s, t0), min(f, t1)
            if f <= s:
                continue
            iv.append((s, f))
            name = e.name()
            by_name[name] += f - s
            if any(k in name for k in LAYER_KERNELS):
                layer_ns += f - s
                layer_n += 1
        busy, gaps = _union(iv, t0, t1)
        out = {
            "window_s": (t1 - t0) / 1e9,
            "busy_s": busy / 1e9,
            "device_ops": [[n[:120], v / 1e9] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": _label_gaps(gaps, spans, t0, t1)[:top],
            "layer_launches": [l[:6] for l in self.launches],
        }
        if layer_n:
            out["layer_kernel_s"], out["layer_kernel_source"] = \
                layer_ns / 1e9, "profiler"
        elif self.launches:
            out["layer_kernel_s"] = sum(
                a.elapsed_time(b) for *_, a, b in self.launches) / 1e3
            out["layer_kernel_source"] = "cuda_events"
        return out


def _union(iv, t0, t1):
    """(busy ns, gaps [(start, end)]) of intervals within [t0, t1]."""
    if not iv:
        return 0, [(t0, t1)]
    iv.sort()
    busy, gaps = 0, []
    cur_s, cur_f = iv[0]
    if cur_s > t0:
        gaps.append((t0, cur_s))
    for s, f in iv[1:]:
        if s > cur_f:
            busy += cur_f - cur_s
            gaps.append((cur_f, s))
            cur_s, cur_f = s, f
        else:
            cur_f = max(cur_f, f)
    busy += cur_f - cur_s
    if cur_f < t1:
        gaps.append((cur_f, t1))
    return busy, gaps


def _label_gaps(gaps, spans: Spans, t0, t1, other="host: driver / harness"):
    """Idle seconds summed by the innermost host span holding each gap's
    midpoint, largest first: [[label, seconds], ...]."""
    if not gaps:
        return []
    g = np.array(gaps, np.int64)
    mid, length = (g[:, 0] + g[:, 1]) // 2, g[:, 1] - g[:, 0]
    label = np.full(len(g), -1)
    best = np.full(len(g), np.iinfo(np.int64).max)
    names = []
    for li, (name, items) in enumerate(spans.items.items()):
        names.append(name)
        a = np.array([(s, f) for s, f in items if f >= t0 and s <= t1],
                     np.int64).reshape(-1, 2)
        if not len(a):
            continue
        a = a[np.argsort(a[:, 0])]
        j = np.searchsorted(a[:, 0], mid, side="right") - 1
        ok = j >= 0
        inside = np.zeros(len(g), bool)
        inside[ok] = mid[ok] < a[j[ok], 1]
        width = np.where(inside, a[np.maximum(j, 0), 1] - a[np.maximum(j, 0),
                                                             0], best)
        take = inside & (width < best)
        label[take], best[take] = li, width[take]
    out = defaultdict(int)
    for l, n in zip(label, length):
        out[names[l] if l >= 0 else other] += int(n)
    return [[k, v / 1e9]
            for k, v in sorted(out.items(), key=lambda kv: -kv[1])]
