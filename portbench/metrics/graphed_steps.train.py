"""Share of a round's local steps that replayed CUDA graphs: the
program's ``fl.step_graph`` counter (one event a replayed step,
``core/client.py``'s graphed route) over its ``fl.local_step`` spans under
its ``fl.round`` spans, both kept by ``repro_torch.tracing`` over the same
recording session (the traced run's last round).  1.0 when every step
replays; None on a program without the counter, or without steps."""


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    snap = tracing.snapshot()
    c = snap["counters"].get("fl.step_graph")
    n = sum(1 for s in tracing.under(snap["spans"], "fl.round")
            if s[0] == "fl.local_step")
    return c[0] / n if c and n else None
