"""ms of a flush's host time outside its forward (packing the rows, writing
back the results): the program's ``engine.flush`` spans less their child
``engine.forward`` spans, over the flushes of the traced sub-window.

``repro_torch.tracing`` records from the profiler's start, which its first
check after it notices (``since_ns``), to the profiler's stop after the
window; the flushes that start within the traced sub-window's length of
``since_ns`` are read."""


def read(records):
    tr = records.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    snap = tracing.snapshot()
    end = snap["since_ns"] + tr["window_s"] * 1e9
    forward = {}
    for s in snap["spans"]:
        if s[0] == "engine.forward":
            forward[s[2]] = forward.get(s[2], 0) + s[4] - s[3]
    self_ns = [s[4] - s[3] - forward.get(s[1], 0) for s in snap["spans"]
               if s[0] == "engine.flush" and s[3] < end]
    return sum(self_ns) / 1e6 / len(self_ns) if self_ns else None
