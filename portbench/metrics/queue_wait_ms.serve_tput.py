"""ms a request waits in the engine's queue, from its submit to the start of
the flush that serves it, over the requests of the traced sub-window: the
``wait_*`` attributes of the program's ``engine.flush`` spans.

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
    n = total = 0
    for s in snap["spans"]:
        if s[0] == "engine.flush" and s[3] < end:
            n += s[5]["wait_n"]
            total += s[5]["wait_sum_ns"]
    return total / 1e6 / n if n else None
