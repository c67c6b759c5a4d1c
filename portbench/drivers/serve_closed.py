"""Driver kind ``serve_closed``: forecast serving under a closed loop.

``in_flight`` consumers, drawn from the seed, each keep one request
outstanding: when its answer returns, the consumer sends its next window
(the next offset of its live readings).  The loop flushes one slot with
queued requests after another.  Issuing stops at ``--seconds``; the
requests still queued are served, and ``serve_forecasts_per_s`` is every
answer over the wall up to the last one.
"""
from __future__ import annotations

import time

import numpy as np

from benchlib import data
from benchlib.harness import Outcome
from benchlib.serving import Book, Deployment, Window

FLUSH_SPAN = "engine: flush (pack, copy, launches, read-back)"


def closed_loop(dep: Deployment, sessions, first_off, seconds, marks=(),
                spans=None, dtrace=None):
    """Returns (Book, consumer of each request, its offset, wall)."""
    eng = dep.engine
    submit, flush = eng.submit, eng.flush
    ids, live, L, n_off = dep.ids, dep.live, dep.L, dep.n_offsets
    book = Book(dep.slots)
    fifo, K = book.fifo, len(dep.slots)
    cons, offs, sess_of = [], [], []
    sent = [0] * len(sessions)
    marks = sorted(marks, key=lambda m: m[0])

    def issue(s):
        c = sessions[s]
        o = (first_off[s] + sent[s]) % n_off
        sent[s] += 1
        fifo[submit(ids[c], live[c, o:o + L]).slot].append(len(cons))
        cons.append(c)
        offs.append(o)
        sess_of.append(s)

    def consumer_of(j):
        return ids[cons[j]]

    t0 = time.perf_counter()
    for s in range(len(sessions)):
        issue(s)
    rr = 0
    while True:
        now = time.perf_counter() - t0
        if marks and now >= marks[0][0]:
            marks.pop(0)[1]()
        for k in range(K):
            s = (rr + k) % K
            if fifo[s]:
                break
        else:
            break
        rr = (s + 1) % K
        if dtrace is not None and dtrace.active:
            a = time.time_ns()
            stats = flush(s)
            spans.add(FLUSH_SPAN, a, time.time_ns())
        else:
            stats = flush(s)
        done = book.served(s, stats, time.perf_counter() - t0, consumer_of)
        if now < seconds:
            for j in done:
                issue(sess_of[j])
    wall = time.perf_counter() - t0
    for _, action in marks:
        action()
    return book, np.asarray(cons), np.asarray(offs), wall


def sessions(ctx, dep: Deployment):
    """The consumers in flight and each one's first window offset."""
    rng = data.rng_for(ctx.seed, 5)
    n = ctx.traffic["in_flight"]
    return (rng.choice(len(dep.ids), size=n, replace=False).tolist(),
            rng.integers(dep.n_offsets, size=n).tolist())


def run(ctx) -> Outcome:
    dep = Deployment(ctx)
    win = Window(ctx, dep)
    book, cons, off, wall = win.run(closed_loop, dep, *sessions(ctx, dep),
                                    ctx.seconds)
    pred, answered, _ = book.collect(len(cons), ctx.config["horizon"])
    return win.outcome(
        {"serve_forecasts_per_s": int(answered.sum()) / wall}, cons, off,
        pred, answered, wall, {})
