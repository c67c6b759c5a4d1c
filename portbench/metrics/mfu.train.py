"""Model FLOPs (real rows) over the window's wall at the fp32 peak of
67e12."""
from benchlib import readers


def read(records):
    return readers.mfu_pct(records)
