"""EngineStats: real rows over padded rows of the window's flushes."""
from benchlib import readers


def read(records):
    return readers.bucket_fill_pct(records)
