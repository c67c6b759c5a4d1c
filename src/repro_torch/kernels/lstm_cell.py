"""Fused LSTM layer and cell: the wrappers around the CUDA kernel
``csrc/lstm_cell.cu``.

The kernel runs the fused cell over a whole time-major sequence in one
launch (:func:`lstm_layer`): both matrix products and the four gates of
every step, with the weights brought into shared memory once and h and c
kept on chip between steps, so only each step's h and the last c are
written.  :func:`lstm_cell`, one step, is its ``T = 1`` call.  Tensors on
the CPU take the plain versions
(:func:`repro_torch.kernels.ref.lstm_layer_ref`,
:func:`~repro_torch.kernels.ref.lstm_cell_ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def lstm_layer(x_seq, h0, c0, wx, wh, b):
    """Fused LSTM layer.  x_seq: (T, B, I) time-major; h0, c0: (B, H);
    wx: (I, 4H) [i|f|g|o]; wh: (H, 4H); b: (4H,).  Returns (h_seq (T, B, H),
    c_T) in the input dtype."""
    args = (x_seq, h0, c0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.lstm_layer_ref(*args)
    T, B, I, H = _cuda.cell_dims("lstm_cell", x_seq, h0)
    _cuda.check_inputs("lstm_cell", args, [(T, B, I), (B, H), (B, H),
                                           (I, 4 * H), (H, 4 * H), (4 * H,)])
    plan = _cuda.cell_plan("lstm_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index))
    h_seq = torch.empty((T, B, H), dtype=h0.dtype, device=h0.device)
    c_out = torch.empty_like(c0)
    _cuda.launch("lstm_cell", (*args, h_seq, c_out), (T, B, I, H, *plan))
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_seq, c_out


def lstm_cell(x, h, c, wx, wh, b):
    """Fused LSTM step.  x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o];
    wh: (H, 4H); b: (4H,).  Returns (h', c') in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return ref.lstm_cell_ref(x, h, c, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"lstm_cell: x must be 2-D, got {tuple(x.shape)}")
    h_seq, c_out = lstm_layer(x.unsqueeze(0), h, c, wx, wh, b)
    return h_seq[0], c_out
