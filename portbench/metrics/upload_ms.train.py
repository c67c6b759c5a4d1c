"""ms a recorded round in the copy of the round's windows and minibatch
indices to the card (``RoundEngine._sync_step``): the program's
``fl.upload`` spans under its ``fl.round`` spans, which
``repro_torch.tracing`` records while the traced run's profiler does (the
window's last round)."""


def read(records):
    if not records.get("trace"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:             # a program without the tracer
        return None
    spans = tracing.snapshot()["spans"]
    rounds = sum(s[0] == "fl.round" for s in spans)
    if not rounds:
        return None
    return sum(s[4] - s[3] for s in tracing.under(spans, "fl.round")
               if s[0] == "fl.upload") / 1e6 / rounds
