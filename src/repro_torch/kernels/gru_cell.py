"""Fused GRU layer and cell: the wrappers around the CUDA kernel
``csrc/gru_cell.cu``.

Same scheme as the LSTM (``kernels/lstm_cell.py``) with three gates
``[z|r|h~]``; the reset gate scales only the h part of the candidate, so the
kernel keeps the x and h sums of each gate apart.  :func:`gru_layer` runs
the whole sequence in one launch, :func:`gru_cell` is its ``T = 1`` call.
Tensors on the CPU take the plain versions
(:func:`repro_torch.kernels.ref.gru_layer_ref`,
:func:`~repro_torch.kernels.ref.gru_cell_ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def gru_layer(x_seq, h0, wx, wh, b):
    """Fused GRU layer.  x_seq: (T, B, I) time-major; h0: (B, H);
    wx: (I, 3H) [z|r|h~]; wh: (H, 3H); b: (3H,).  Returns h_seq (T, B, H)
    in the input dtype."""
    args = (x_seq, h0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.gru_layer_ref(*args)
    T, B, I, H = _cuda.cell_dims("gru_cell", x_seq, h0)
    _cuda.check_inputs("gru_cell", args, [(T, B, I), (B, H), (I, 3 * H),
                                          (H, 3 * H), (3 * H,)])
    plan = _cuda.cell_plan("gru_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index))
    h_seq = torch.empty((T, B, H), dtype=h0.dtype, device=h0.device)
    _cuda.launch("gru_cell", (*args, h_seq), (T, B, I, H, *plan))
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_seq


def gru_cell(x, h, wx, wh, b):
    """Fused GRU step.  x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~];
    wh: (H, 3H); b: (3H,).  Returns h' in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, wx, wh, b)):
        return ref.gru_cell_ref(x, h, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"gru_cell: x must be 2-D, got {tuple(x.shape)}")
    return gru_layer(x.unsqueeze(0), h, wx, wh, b)[0]
