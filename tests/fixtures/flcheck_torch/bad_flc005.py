"""Fixture: dtype hazards — triggers FLC005 and nothing else.

Scoped like FLC004: tests feed this under a pretend
``src/repro_torch/core/`` path.
"""
import torch


def promote(x):
    return x.double()                      # FLC005: fp64 on the device


def alloc(n):
    return torch.zeros((n,), dtype=torch.float64)     # FLC005: fp64 alloc


def wrap_prone(x, y):
    return x.to(torch.int8) + y            # FLC005: narrow-int arithmetic


def byte_sum(x, y):
    return x.char() * y                    # FLC005: narrow-int arithmetic
