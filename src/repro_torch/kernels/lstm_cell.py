"""Fused LSTM layer and cell: the wrappers around the CUDA kernel
``csrc/lstm_cell.cu``.

The kernel runs the fused cell over a whole time-major sequence in one
launch (:func:`lstm_layer`): both matrix products and the four gates of
every step, with the weights brought into shared memory once and h and c
kept on chip between steps, so only each step's h and the last c are
written.  It takes a leading client axis as well: M clients, each with its
own weights, in one launch (the federated local update's forward).
:func:`lstm_cell`, one step, is its ``T = 1`` call.

Tensors on the CPU take the plain versions
(:func:`repro_torch.kernels.ref.lstm_layer_ref`,
:func:`~repro_torch.kernels.ref.lstm_cell_ref`); CUDA tensors launch the
kernel or raise.  Where autograd records the call (grad enabled and an
input that requires it), the launch goes through :class:`LSTMLayer`, whose
backward is the VJP of the plain layer recomputed from the saved inputs,
as the JAX package's ``custom_vjp`` cell takes the VJP of its oracle
(``src/repro/kernels/ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def _launch(x_seq, h0, c0, wx, wh, b):
    """One launch of the layer kernel on CUDA tensors (no autograd)."""
    args = (x_seq, h0, c0, wx, wh, b)
    T, B, I, H = _cuda.cell_dims("lstm_cell", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    _cuda.check_inputs("lstm_cell", args, [
        lead + (T, B, I), lead + (B, H), lead + (B, H), lead + (I, 4 * H),
        lead + (H, 4 * H), lead + (4 * H,)])
    M = lead[0] if lead else 1
    plan = _cuda.cell_plan("lstm_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index), M=M)
    h_seq = torch.empty(lead + (T, B, H), dtype=h0.dtype, device=h0.device)
    c_out = torch.empty_like(c0)
    _cuda.launch("lstm_cell", (*args, h_seq, c_out), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_seq, c_out


class LSTMLayer(torch.autograd.Function):
    """The layer kernel as an autograd op: the forward launches it; the
    backward recomputes the plain layer (the kernel writes every h but only
    the last c, so there are no per-step residuals to reuse) and returns
    its VJP for every input that needs one."""

    @staticmethod
    def forward(ctx, x_seq, h0, c0, wx, wh, b):
        ctx.save_for_backward(x_seq, h0, c0, wx, wh, b)
        return _launch(x_seq, h0, c0, wx, wh, b)

    @staticmethod
    def backward(ctx, g_h, g_c):
        return ref.plain_vjp(ref.lstm_layer_ref, ctx.saved_tensors,
                             ctx.needs_input_grad, (g_h, g_c))


def lstm_layer(x_seq, h0, c0, wx, wh, b):
    """Fused LSTM layer.  x_seq: (T, B, I) time-major; h0, c0: (B, H);
    wx: (I, 4H) [i|f|g|o]; wh: (H, 4H); b: (4H,); or each with a leading
    client axis M.  Returns (h_seq (T, B, H) or (M, T, B, H), c_T) in the
    input dtype."""
    args = (x_seq, h0, c0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        return ref.lstm_layer_ref(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LSTMLayer.apply(*args)
    return _launch(*args)


def lstm_cell(x, h, c, wx, wh, b):
    """Fused LSTM step.  x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o];
    wh: (H, 4H); b: (4H,).  Returns (h', c') in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return ref.lstm_cell_ref(x, h, c, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"lstm_cell: x must be 2-D, got {tuple(x.shape)}")
    h_seq, c_out = lstm_layer(x.unsqueeze(0), h, c, wx, wh, b)
    return h_seq[0], c_out
