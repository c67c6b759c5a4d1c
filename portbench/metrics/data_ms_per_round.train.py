"""ms a round in ClientWindowProvider.round_batch (the data layer), from
a span around it."""
from benchlib import readers


def read(records):
    return readers.data_ms_per_round(records)
