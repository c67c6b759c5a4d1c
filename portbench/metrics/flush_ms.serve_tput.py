"""EngineStats.busy_s / flushes over the window: host wall of a flush's
forward, ending in .cpu()."""
from benchlib import readers


def read(records):
    return readers.flush_ms(records)
