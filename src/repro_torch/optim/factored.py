"""Adafactor-style factored second moment; the counterpart of
``src/repro/optim/factored.py``.

The second moment of a leaf with two or more axes is stored as a row
factor of shape ``p.shape[:-1]`` and a column factor of shape
``p.shape[:-2] + p.shape[-1:]`` (so a stacked (L, n, m) leaf keeps one
pair per layer) instead of the full shape; vectors keep a full second
moment.  There is no first moment and no fp32 master copy: updates are
applied in the param dtype, clipped to an RMS of ``clip_threshold``.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim.sgd import Optimizer


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.99) -> Optimizer:
    def init(params):
        def factor(p):
            if p.dim() >= 2:
                return (torch.zeros(p.shape[:-1], dtype=torch.float32,
                                    device=p.device),          # row factor
                        torch.zeros(p.shape[:-2] + p.shape[-1:],
                                    dtype=torch.float32, device=p.device))
            return (torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device), None)
        dev = tree_leaves(params)[0].device
        return (tree_map(factor, params),
                torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params, lr):
        factors, t = state
        t = t + 1

        def upd(g, f, p):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if p.dim() >= 2:
                vr, vc = f
                vr = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
                vc = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
                # rank-1 reconstruction of the second moment
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)
                                       [..., None], min=eps))
                u = g32 * torch.rsqrt(torch.clamp(denom, min=eps))
                nf = (vr, vc)
            else:
                v, _ = f
                v = decay * v + (1 - decay) * g2
                u = g32 * torch.rsqrt(torch.clamp(v, min=eps))
                nf = (v, None)
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr * u).to(p.dtype), nf

        outs = tree_map(upd, grads, factors, params)
        updates = tree_map(lambda _, o: o[0], grads, outs)
        new_f = tree_map(lambda _, o: o[1], grads, outs)
        return updates, (new_f, t)

    return Optimizer(init, update)
