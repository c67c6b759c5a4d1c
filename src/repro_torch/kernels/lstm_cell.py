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
backward is one launch of the BPTT kernel ``csrc/lstm_bptt.cu``: the VJP
of the layer (the one the JAX package's ``custom_vjp`` cell takes of its
oracle, ``src/repro/kernels/ops.py``), with each step's gates recomputed
from the saved inputs and output
(:func:`repro_torch.kernels.ref.lstm_layer_bptt_ref` its plain version).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _cuda, ref


def _launch(x_seq, h0, c0, wx, wh, b, out=None):
    """One launch of the layer kernel on CUDA tensors (no autograd).
    ``out``: preallocated ``(h_seq, c_out)`` to write, else new tensors."""
    args = (x_seq, h0, c0, wx, wh, b)
    T, B, I, H = _cuda.cell_dims("lstm_cell", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    _cuda.check_inputs("lstm_cell", args, [
        lead + (T, B, I), lead + (B, H), lead + (B, H), lead + (I, 4 * H),
        lead + (H, 4 * H), lead + (4 * H,)])
    M = lead[0] if lead else 1
    plan = _cuda.cell_plan("lstm_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index), M=M)
    h_seq, c_out = out or (
        torch.empty(lead + (T, B, H), dtype=h0.dtype, device=h0.device),
        torch.empty_like(c0))
    _cuda.launch("lstm_cell", (*args, h_seq, c_out), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["lstm_cell"] += 1
    return h_seq, c_out


def _launch_bptt(x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c, needs,
                 out=None, work=None):
    """One launch of the BPTT kernel on CUDA tensors: the layer's inputs,
    its output h_seq and the cotangents of h_seq and c_T in; the gradient
    of each input that ``needs`` flags out, None for the others (no
    autograd).  ``out`` (the six gradients, preallocated where needed) and
    ``work`` (the workspace, ``_cuda.bptt_plan``'s bytes a client) are
    written instead of new tensors where given.  Counted by the tracer as
    ``layer.bptt``."""
    t0 = tracing.now() if tracing.on() else 0
    ins = (x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c)
    T, B, I, H = _cuda.cell_dims("lstm_bptt", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    state, seq = lead + (B, H), lead + (T, B, H)
    _cuda.check_inputs("lstm_bptt", ins, [
        lead + (T, B, I), state, state, lead + (I, 4 * H),
        lead + (H, 4 * H), lead + (4 * H,), seq, seq, state])
    M = lead[0] if lead else 1
    plan, size = _cuda.bptt_plan("lstm_bptt", T, B, I, H,
                                 x_seq.element_size())
    grads = [(torch.empty_like(t) if out is None else out[i]) if n
             else _cuda.NULL for i, (t, n) in enumerate(zip(ins[:6], needs))]
    if work is None:
        work = (torch.empty(M * size, dtype=torch.uint8,
                            device=x_seq.device) if size else _cuda.NULL)
    _cuda.launch("lstm_bptt", (*ins, *grads, work), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["lstm_bptt"] += 1
    if t0:
        tracing.count("layer.bptt", tracing.now() - t0)
    return tuple(g if n else None for g, n in zip(grads, needs))


class LSTMLayer(torch.autograd.Function):
    """The layer kernel as an autograd op: the forward launches it and
    keeps its inputs and its h_seq; the backward launches the BPTT kernel,
    which recomputes each step's gates from them (the forward writes every
    h but only the last c), for every input that needs a gradient.  The
    differentiable layer that mirrors the JAX package's ``custom_vjp``
    cell; federated training does not go through it, but calls the layer
    and :func:`lstm_layer_bptt` itself
    (``models/forecaster.py::loss_and_grads``)."""

    @staticmethod
    def forward(ctx, x_seq, h0, c0, wx, wh, b):
        h_seq, c_out = _launch(x_seq, h0, c0, wx, wh, b)
        ctx.save_for_backward(x_seq, h0, c0, wx, wh, b, h_seq)
        return h_seq, c_out

    @staticmethod
    def backward(ctx, g_h, g_c):
        return _launch_bptt(*ctx.saved_tensors, g_h.contiguous(),
                            g_c.contiguous(), ctx.needs_input_grad)


def lstm_layer(x_seq, h0, c0, wx, wh, b, out=None):
    """Fused LSTM layer.  x_seq: (T, B, I) time-major; h0, c0: (B, H);
    wx: (I, 4H) [i|f|g|o]; wh: (H, 4H); b: (4H,); or each with a leading
    client axis M.  Returns (h_seq (T, B, H) or (M, T, B, H), c_T) in the
    input dtype, written into ``out`` (preallocated ``(h_seq, c_T)``, for
    a call that autograd does not record) where given."""
    args = (x_seq, h0, c0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        got = ref.lstm_layer_ref(*args)
        return got if out is None else ref.into(out, got)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if out is not None:
            raise ValueError("lstm_layer: out= on a call autograd records")
        return LSTMLayer.apply(*args)
    return _launch(*args, out=out)


def lstm_layer_bptt(x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c, needs,
                    out=None, work=None):
    """The layer's VJP called directly, as :class:`LSTMLayer`'s backward
    launches it: the arguments, ``out`` and ``work`` of
    :func:`_launch_bptt`; on the CPU the plain version
    (:func:`repro_torch.kernels.ref.lstm_layer_bptt_ref`)."""
    args = (x_seq, h0, c0, wx, wh, b, h_seq, g_h, g_c)
    if all(t.device.type == "cpu" for t in args):
        got = ref.lstm_layer_bptt_ref(*args, needs)
        return got if out is None else ref.into(out, got)
    return _launch_bptt(*args, needs, out=out, work=work)


def lstm_cell(x, h, c, wx, wh, b):
    """Fused LSTM step.  x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o];
    wh: (H, 4H); b: (4H,).  Returns (h', c') in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, c, wx, wh, b)):
        return ref.lstm_cell_ref(x, h, c, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"lstm_cell: x must be 2-D, got {tuple(x.shape)}")
    h_seq, c_out = lstm_layer(x.unsqueeze(0), h, c, wx, wh, b)
    return h_seq[0], c_out
