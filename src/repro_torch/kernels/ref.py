"""Plain PyTorch versions of the fused recurrent cells.

They are the correctness ground truth for the CUDA kernels (``csrc/``) and
what the kernel wrappers compute for tensors on the CPU.  Same layouts as
the JAX package: gates ``[i|f|g|o]`` (LSTM) and ``[z|r|h~]`` (GRU) along
the last axis of ``wx (I, G*H)`` / ``wh (H, G*H)``, one bias, no hidden
bias in the GRU.
"""
from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o]; wh: (H, 4H); b: (4H,)."""
    z = x @ wx + h @ wh + b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_cell_ref(x, h, wx, wh, b):
    """x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~]; wh: (H, 3H); b: (3H,)."""
    H = h.shape[-1]
    zx = x @ wx + b
    zh = h @ wh
    z = torch.sigmoid(zx[..., :H] + zh[..., :H])
    r = torch.sigmoid(zx[..., H:2 * H] + zh[..., H:2 * H])
    h_tilde = torch.tanh(zx[..., 2 * H:] + r * zh[..., 2 * H:])
    return z * h + (1.0 - z) * h_tilde
