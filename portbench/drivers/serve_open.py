"""Driver kind ``serve_open``: forecast serving under an open loop.

Requests arrive as a Poisson stream at the traffic file's fixed
``rate_per_s``, each from a consumer drawn uniformly, its window cut at a
drawn offset of the consumer's live readings.  A run sends exactly
rate x seconds requests: the exponential gaps are scaled so that the last
one falls at the window's end, so every seed offers the same work in
another order.  The loop submits every request that is due and flushes
one slot with queued requests after another; a request's latency runs
from when it was due to when its flush returned, and one never answered
counts as missing every limit.  ``serve_p95_ms`` is the 95th percentile
over all requests of the window (the 99th swings with whether a full
collection of the interpreter's garbage, a pause of some 200 ms that one
window in three meets, falls in the window; it is printed beside it).
"""
from __future__ import annotations

import time

import numpy as np

from benchlib import data
from benchlib.harness import Outcome
from benchlib.serving import Book, Deployment, Window

FLUSH_SPAN = "engine: flush (pack, copy, launches, read-back)"


def arrivals(ctx, dep: Deployment, rate: float, seconds: float):
    """(due times (n,), consumer (n,), window offset (n,)) of one run."""
    rng = data.rng_for(ctx.seed, 4)
    n = max(1, int(round(rate * seconds)))
    due = np.cumsum(rng.exponential(size=n))
    due *= seconds / due[-1]
    cons = rng.integers(len(dep.ids), size=n)
    off = rng.integers(dep.n_offsets, size=n)
    return due, cons, off


def stream(dep: Deployment, due, cons, off):
    """The requests as the loop sends them: (due times, consumer ids,
    windows (n, L))."""
    return (due.tolist(), [dep.ids[c] for c in cons],
            dep.live[cons[:, None], off[:, None] + np.arange(dep.L)])


def open_loop(dep: Deployment, reqs, marks=(), spans=None, dtrace=None):
    """Serve the stream; returns (Book, lateness samples, wall)."""
    eng = dep.engine
    submit, flush = eng.submit, eng.flush
    due_l, cid, win = reqs
    book = Book(dep.slots)
    fifo, K = book.fifo, len(dep.slots)
    marks = sorted(marks, key=lambda m: m[0])
    n, i, rr, late = len(due_l), 0, 0, []
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if marks and now >= marks[0][0]:
            marks.pop(0)[1]()
        if i < n and due_l[i] <= now:
            late.append(now - due_l[i])
            while i < n and due_l[i] <= now:
                fifo[submit(cid[i], win[i]).slot].append(i)
                i += 1
        for k in range(K):
            s = (rr + k) % K
            if fifo[s]:
                break
        else:
            if i >= n:
                break
            while time.perf_counter() - t0 < due_l[i]:
                pass
            continue
        rr = (s + 1) % K
        if dtrace is not None and dtrace.active:
            a = time.time_ns()
            stats = flush(s)
            spans.add(FLUSH_SPAN, a, time.time_ns())
        else:
            stats = flush(s)
        book.served(s, stats, time.perf_counter() - t0, cid.__getitem__)
    wall = time.perf_counter() - t0
    for _, action in marks:
        action()
    return book, late, wall


def run(ctx) -> Outcome:
    dep = Deployment(ctx)
    rate = ctx.traffic["rate_per_s"]
    due, cons, off = arrivals(ctx, dep, rate, ctx.seconds)
    reqs = stream(dep, due, cons, off)
    win = Window(ctx, dep)
    book, late, wall = win.run(open_loop, dep, reqs)
    pred, answered, done = book.collect(len(due), ctx.config["horizon"])
    # a request never answered misses every limit: it counts as waiting the
    # whole run, longer than any answered request did
    lat = np.where(answered, done - due, wall)
    pct = (50, 90, 95, 98, 99, 99.9)
    p = dict(zip(pct, np.percentile(lat, pct) * 1e3))
    return win.outcome(
        {"serve_p95_ms": float(p[95])}, cons, off, pred, answered, wall,
        {"offered_per_s": rate,
         **{f"p{k}_ms": float(v) for k, v in p.items()},
         "answered_per_s": float(answered.sum()) / wall,
         "lateness_p99_ms": (float(np.percentile(late, 99)) * 1e3
                             if late else 0.0),
         "lateness_max_ms": max(late, default=0.0) * 1e3})
