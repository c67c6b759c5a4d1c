"""Fixture: Python branch on a tensor result — triggers FLC009 only.

The FLC009 rule is scoped to ``src/repro_torch/serving/``; tests feed this
file to the checker under a pretend path in that scope.  Both constructs
read the tensor's truth from the device: a blocking device->host sync on
every request (every loop trip) in eager serving code.
"""
import torch


def guard_nan(pred):
    if torch.isnan(pred).any():            # FLC009: if on a tensor result
        return torch.zeros_like(pred)
    return pred


def drain(pred, budget):
    while torch.sum(pred) > budget:        # FLC009: while on a tensor result
        pred = pred * 0.5
    return pred
