"""Shared building blocks.  The serving slice needs only the dense init."""
from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, in_dim, out_dim, scale=None,
               dtype=torch.float32):
    """(in_dim, out_dim) normal weights times ``scale`` (default
    ``in_dim ** -0.5``), drawn on the CPU from ``generator``, so a seed
    gives the same weights whichever device they are later moved to."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32) * scale
    return w.to(dtype)
