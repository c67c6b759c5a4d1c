"""us a ``ServingEngine.submit``: the program's ``engine.submit`` counter,
which ``repro_torch.tracing`` keeps while the traced run's profiler
records (the last ``trace_seconds`` of the window, where every submit of
the recording falls)."""


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    c = tracing.snapshot()["counters"].get("engine.submit")
    return c[1] / 1e3 / c[0] if c else None
