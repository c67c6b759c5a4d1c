"""The program's own spans and counters, kept in process memory.

A span record is ``(name, span_id, parent_id, t0_ns, t1_ns, attrs)``; a
counter is ``name -> [count, total_ns, max_ns]``.  Every timestamp is
``time.time_ns()``, the clock on which Kineto puts the card's events, so a
span can be set against a profiler trace of the device.

The tracer records while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``) and inside a
:func:`recording` block; otherwise it is off.  Off, :func:`span` returns one
shared null context that records nothing (a span opened inside it records
``parent_id=None``), and call sites that would pay even that on every
request guard with :func:`on`.  A recording session begins at the first
:func:`on` after the switch from off to on.  The records of the session
before are dropped then, counters because they cannot be clipped to a
window, so the buffer always holds the latest session.  The buffer is
bounded: past ``CAP`` spans a span is counted in ``dropped`` instead.
Nothing is written out: :func:`snapshot` hands the records over and
:func:`clear` empties them.

The tracer opens no profiler range (``record_function``, NVTX): a profile
that counts every CUDA-typed event as device work would count the range.
Spans nest on one stack: the program opens them from one thread.

Spans: ``fl.round`` (a round of ``run_federated_training``: ``cluster``,
``round``, ``clients``, ``local_steps``, ``windows``), ``fl.round_batch``
(``clients``), ``fl.upload`` (``bytes``), ``fl.local_step``,
``fl.backward``, ``fl.wait`` (the read of the round's loss), ``engine.flush``
(``slot``, ``rows``, ``bucket`` and the queue wait of its rows from submit
to the flush's start: ``wait_n``, ``wait_sum_ns``, ``wait_max_ns``) and its
child ``engine.forward``.  Counters: ``engine.submit``; ``layer.bptt`` (the
host time of a recurrent layer's backward launch, ``kernels/{lstm,gru}_cell
.py::_launch_bptt``, a counter because autograd runs a CUDA backward on its
own thread, where the span stack is not the program's); ``fl.step_graph``
(the host time of a local step that replayed its CUDA graphs,
``core/client.py``'s graphed route) and ``fl.step_graph.capture`` (the
host time of a step shape's first step: its eager run and the capture of
its three graphs).
"""
from __future__ import annotations

import contextlib
import itertools
import time

from torch.autograd import profiler as _profiler

CAP = 1 << 18

now = time.time_ns

_spans: list = []
_counters: dict = {}
_dropped = 0
_since_ns = 0               # when the latest session was noticed
_was_on = False
_forced = 0                 # depth of recording() blocks
_ids = itertools.count(1)
_open: list = []            # ids of the spans open now, innermost last


def on() -> bool:
    """Whether the tracer records now; notices the start of a session."""
    global _was_on
    is_on = _forced > 0 or _profiler._is_profiler_enabled
    if is_on is not _was_on:
        _was_on = is_on
        if is_on:
            _begin_session()
    return is_on


def _begin_session():
    global _since_ns
    clear()
    _since_ns = now()


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "attrs")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.id = name, attrs, next(_ids)

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        _open.pop()
        global _dropped
        if len(_spans) < CAP:
            _spans.append((self.name, self.id, self.parent, self.t0, t1,
                           self.attrs))
        else:
            _dropped += 1
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NULL = _Null()


def span(name: str, **attrs):
    """A context that records one span; :data:`NULL` (falsy) while off.
    Inside the block ``attrs`` may gain entries."""
    return _Span(name, attrs) if on() else NULL


def count(name: str, ns: int) -> None:
    """Add one event of ``ns`` nanoseconds to a counter (callers check
    :func:`on` first)."""
    c = _counters.get(name)
    if c is None:
        _counters[name] = [1, ns, ns]
    else:
        c[0] += 1
        c[1] += ns
        if ns > c[2]:
            c[2] = ns


@contextlib.contextmanager
def recording():
    """Record inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def snapshot() -> dict:
    """``{"spans": [...], "counters": {...}, "dropped": n, "since_ns": t}``
    of the latest session (``since_ns``: when it was noticed)."""
    return {"spans": list(_spans),
            "counters": {k: list(v) for k, v in _counters.items()},
            "dropped": _dropped, "since_ns": _since_ns}


def clear() -> None:
    global _dropped
    _spans.clear()
    _counters.clear()
    _dropped = 0


def under(spans, root: str) -> list:
    """The spans that lie under a recorded span named ``root``, at any
    depth, by their parent ids."""
    parent = {s[1]: s[2] for s in spans}
    name = {s[1]: s[0] for s in spans}
    out = []
    for s in spans:
        p = s[2]
        while p is not None and name.get(p) != root:
            p = parent.get(p)
        if p is not None:
            out.append(s)
    return out
