"""The recurrent layer kernel's share of its roofline bound (arith.py) in
the traced sub-window."""
from benchlib import readers


def read(records):
    return readers.layer_roofline_pct(records)
