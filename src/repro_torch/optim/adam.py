"""Adam / AdamW with fp32 state whatever the param dtype; the counterpart
of ``src/repro/optim/adam.py``.  The step count is a 0-d int32 tensor on
the params' device, so the bias corrections never leave the device."""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim.sgd import Optimizer


def adam(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return (tree_map(zeros, params), tree_map(zeros, params),
                torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params, lr):
        m, v, t = state
        t = t + 1
        g32 = tree_map(lambda g: g.float(), grads)
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, m, g32)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, v, g32)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(mm, vv, p):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, m, v, params), (m, v, t)

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return adam(b1, b2, eps, weight_decay)
