"""Fused GRU layer and cell: the wrappers around the CUDA kernel
``csrc/gru_cell.cu``.

Same scheme as the LSTM (``kernels/lstm_cell.py``) with three gates
``[z|r|h~]``; the reset gate scales only the h part of the candidate, so the
kernel keeps the x and h sums of each gate apart.  :func:`gru_layer` runs
the whole sequence in one launch, for one weight set or for M clients with
a leading client axis; :func:`gru_cell` is its ``T = 1`` call.

Tensors on the CPU take the plain versions
(:func:`repro_torch.kernels.ref.gru_layer_ref`,
:func:`~repro_torch.kernels.ref.gru_cell_ref`); CUDA tensors launch the
kernel or raise.  Where autograd records the call, the launch goes through
:class:`GRULayer`, whose backward is the VJP of the plain layer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def _launch(x_seq, h0, wx, wh, b):
    """One launch of the layer kernel on CUDA tensors (no autograd)."""
    args = (x_seq, h0, wx, wh, b)
    T, B, I, H = _cuda.cell_dims("gru_cell", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    _cuda.check_inputs("gru_cell", args, [
        lead + (T, B, I), lead + (B, H), lead + (I, 3 * H),
        lead + (H, 3 * H), lead + (3 * H,)])
    M = lead[0] if lead else 1
    plan = _cuda.cell_plan("gru_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index), M=M)
    h_seq = torch.empty(lead + (T, B, H), dtype=h0.dtype, device=h0.device)
    _cuda.launch("gru_cell", (*args, h_seq), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_seq


class GRULayer(torch.autograd.Function):
    """The layer kernel as an autograd op: the forward launches it; the
    backward recomputes the plain layer and returns its VJP for every input
    that needs one (x_seq too: a second layer feeds on the first)."""

    @staticmethod
    def forward(ctx, x_seq, h0, wx, wh, b):
        ctx.save_for_backward(x_seq, h0, wx, wh, b)
        return _launch(x_seq, h0, wx, wh, b)

    @staticmethod
    def backward(ctx, g_h):
        return ref.plain_vjp(ref.gru_layer_ref, ctx.saved_tensors,
                             ctx.needs_input_grad, (g_h,))


def gru_layer(x_seq, h0, wx, wh, b):
    """Fused GRU layer.  x_seq: (T, B, I) time-major; h0: (B, H);
    wx: (I, 3H) [z|r|h~]; wh: (H, 3H); b: (3H,); or each with a leading
    client axis M.  Returns h_seq (T, B, H) or (M, T, B, H) in the input
    dtype."""
    args = (x_seq, h0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.gru_layer_ref(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return GRULayer.apply(*args)
    return _launch(*args)


def gru_cell(x, h, wx, wh, b):
    """Fused GRU step.  x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~];
    wh: (H, 3H); b: (3H,).  Returns h' in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, wx, wh, b)):
        return ref.gru_cell_ref(x, h, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"gru_cell: x must be 2-D, got {tuple(x.shape)}")
    return gru_layer(x.unsqueeze(0), h, wx, wh, b)[0]
