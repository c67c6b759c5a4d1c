"""Fused LSTM cell: the wrapper around the CUDA kernel ``csrc/lstm_cell.cu``.

The kernel fuses both matrix products and the four gates of one time step,
so the (B, 4H) pre-activation never reaches device memory; only h' and c'
are written.  Tensors on the CPU take the plain version
(:func:`repro_torch.kernels.ref.lstm_cell_ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def lstm_cell(x, h, c, wx, wh, b):
    """Fused LSTM step.  x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o];
    wh: (H, 4H); b: (4H,).  Returns (h', c') in the input dtype."""
    args = (x, h, c, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.lstm_cell_ref(*args)
    B, I, H = _cuda.cell_dims("lstm_cell", x, h)
    _cuda.check_inputs("lstm_cell", args, [(B, I), (B, H), (B, H),
                                           (I, 4 * H), (H, 4 * H), (4 * H,)])
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    _cuda.launch("lstm_cell", (*args, h_out, c_out), (B, I, H))
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_out, c_out
