"""LR schedules; the counterpart of ``src/repro/optim/schedules.py``.
Each maps a step (an int or a tensor) to a 0-d fp32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return f
