"""ms a local step: the span around RoundEngine.step over the rounds'
local steps."""
from benchlib import readers


def read(records):
    return readers.local_step_ms(records)
