"""Entry points that route model code through the CUDA kernels.

``lstm_layer_fused`` / ``gru_layer_fused`` (a whole time-major sequence, one
launch, for one weight set or for M clients stacked on a leading axis) and
``lstm_cell_fused`` / ``gru_cell_fused`` (one step, the layer kernel at
``T = 1``) take the forecaster's per-layer param dict ``{"wx", "wh", "b"}``;
``flash_attention`` takes (B, S, H, hd) q, k, v, as ``models/attention.py``
calls it.
On the CPU they compute the plain versions; on CUDA tensors they launch the
hand-written kernels (built at first use, see :mod:`._cuda`) or raise, with
no fallback.  The recurrent layers are differentiable on CUDA tensors: where
autograd records the call, it goes through a ``torch.autograd.Function``
(``lstm_cell.LSTMLayer``, ``gru_cell.GRULayer``) whose forward is the layer
kernel and whose backward is one launch of the BPTT kernel
(``lstm_bptt``, ``gru_bptt``): the VJP that ``src/repro/kernels/ops.py``
pairs the Pallas cells with, their oracle's.  Flash attention is forward
only: on a CUDA tensor that autograd would have to record, it raises.

``launch_counts`` / ``reset_launch_counts`` read and zero the per-kernel
launch counters, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gru_cell import gru_cell, gru_layer
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_layer

KERNELS = _cuda.KERNELS
build = _cuda.build


def lstm_layer_fused(x_seq, h0, c0, p):
    """(x_seq (T, B, I), h0, c0, layer params) -> (h_seq (T, B, H), c_T);
    with a leading client axis on every argument and param, per client."""
    return lstm_layer(x_seq, h0, c0, p["wx"], p["wh"], p["b"])


def gru_layer_fused(x_seq, h0, p):
    """(x_seq (T, B, I), h0, layer params) -> h_seq (T, B, H); with a
    leading client axis on every argument and param, per client."""
    return gru_layer(x_seq, h0, p["wx"], p["wh"], p["b"])


def lstm_cell_fused(x_t, h, c, p):
    """(x_t, h, c, layer params) -> (h', c'); gates [i|f|g|o] in wx/wh."""
    return lstm_cell(x_t, h, c, p["wx"], p["wh"], p["b"])


def gru_cell_fused(x_t, h, p):
    """(x_t, h, layer params) -> h'; gates [z|r|h~] in wx/wh."""
    return gru_cell(x_t, h, p["wx"], p["wh"], p["b"])


def launch_counts() -> Dict[str, int]:
    return {name: _cuda.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _cuda.LAUNCHES.clear()
