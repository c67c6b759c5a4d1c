"""ms of host time a local step in ``torch.autograd.grad``: the program's
``fl.backward`` spans under its ``fl.round`` spans, which
``repro_torch.tracing`` records while the traced run's profiler does (the
window's last round)."""


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    got = [s[4] - s[3] for s in
           tracing.under(tracing.snapshot()["spans"], "fl.round")
           if s[0] == "fl.backward"]
    return sum(got) / 1e6 / len(got) if got else None
