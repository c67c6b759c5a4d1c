"""Share of the traced sub-window with no device activity."""
from benchlib import readers


def read(records):
    return readers.device_idle_pct(records)
