"""Fused GRU cell: the wrapper around the CUDA kernel ``csrc/gru_cell.cu``.

Same fusion as the LSTM cell with three gates ``[z|r|h~]``; the reset gate
scales only the h part of the candidate, so the kernel keeps the x and h
sums of each gate apart.  Tensors on the CPU take the plain version
(:func:`repro_torch.kernels.ref.gru_cell_ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def gru_cell(x, h, wx, wh, b):
    """Fused GRU step.  x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~];
    wh: (H, 3H); b: (3H,).  Returns h' in the input dtype."""
    args = (x, h, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.gru_cell_ref(*args)
    B, I, H = _cuda.cell_dims("gru_cell", x, h)
    _cuda.check_inputs("gru_cell", args, [(B, I), (B, H), (I, 3 * H),
                                          (H, 3 * H), (3 * H,)])
    h_out = torch.empty_like(h)
    _cuda.launch("gru_cell", (*args, h_out), (B, I, H))
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_out
