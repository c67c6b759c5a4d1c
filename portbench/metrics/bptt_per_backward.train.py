"""BPTT launches a local step's backward: the program's ``layer.bptt``
counter (one count a launch of a recurrent layer's backward kernel,
``csrc/{lstm,gru}_bptt.cu``) over its ``fl.backward`` spans, both kept by
``repro_torch.tracing`` over the same recording session (the traced run's
last round).  One recurrent layer reads 1.0; a program whose layers have no
backward kernel keeps no such counter and reads None."""


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    snap = tracing.snapshot()
    c = snap["counters"].get("layer.bptt")
    n = sum(1 for s in snap["spans"] if s[0] == "fl.backward")
    return c[0] / n if c and n else None
