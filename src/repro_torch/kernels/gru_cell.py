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
:class:`GRULayer`, whose backward is one launch of the BPTT kernel
``csrc/gru_bptt.cu``, the VJP of the layer
(:func:`repro_torch.kernels.ref.gru_layer_bptt_ref` its plain version).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import _cuda, ref


def _launch(x_seq, h0, wx, wh, b, out=None):
    """One launch of the layer kernel on CUDA tensors (no autograd).
    ``out``: a preallocated h_seq to write, else a new tensor."""
    args = (x_seq, h0, wx, wh, b)
    T, B, I, H = _cuda.cell_dims("gru_cell", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    _cuda.check_inputs("gru_cell", args, [
        lead + (T, B, I), lead + (B, H), lead + (I, 3 * H),
        lead + (H, 3 * H), lead + (3 * H,)])
    M = lead[0] if lead else 1
    plan = _cuda.cell_plan("gru_cell", B, I, H, x_seq.element_size(),
                           _cuda.sm_count(x_seq.device.index), M=M)
    h_seq = out if out is not None else torch.empty(
        lead + (T, B, H), dtype=h0.dtype, device=h0.device)
    _cuda.launch("gru_cell", (*args, h_seq), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["gru_cell"] += 1
    return h_seq


def _launch_bptt(x_seq, h0, wx, wh, b, h_seq, g_h, needs, out=None,
                 work=None):
    """One launch of the BPTT kernel on CUDA tensors: the layer's inputs,
    its output h_seq and its cotangent in; the gradient of each input that
    ``needs`` flags out, None for the others (no autograd).  ``out`` (the
    five gradients, preallocated where needed) and ``work`` (the
    workspace) are written instead of new tensors where given.  Counted by
    the tracer as ``layer.bptt``."""
    t0 = tracing.now() if tracing.on() else 0
    ins = (x_seq, h0, wx, wh, b, h_seq, g_h)
    T, B, I, H = _cuda.cell_dims("gru_bptt", x_seq, h0)
    lead = tuple(x_seq.shape[:-3])                 # () or (M,)
    seq = lead + (T, B, H)
    _cuda.check_inputs("gru_bptt", ins, [
        lead + (T, B, I), lead + (B, H), lead + (I, 3 * H),
        lead + (H, 3 * H), lead + (3 * H,), seq, seq])
    M = lead[0] if lead else 1
    plan, size = _cuda.bptt_plan("gru_bptt", T, B, I, H,
                                 x_seq.element_size())
    grads = [(torch.empty_like(t) if out is None else out[i]) if n
             else _cuda.NULL for i, (t, n) in enumerate(zip(ins[:5], needs))]
    if work is None:
        work = (torch.empty(M * size, dtype=torch.uint8,
                            device=x_seq.device) if size else _cuda.NULL)
    _cuda.launch("gru_bptt", (*ins, *grads, work), (M, T, B, I, H, *plan))
    _cuda.LAUNCHES["gru_bptt"] += 1
    if t0:
        tracing.count("layer.bptt", tracing.now() - t0)
    return tuple(g if n else None for g, n in zip(grads, needs))


class GRULayer(torch.autograd.Function):
    """The layer kernel as an autograd op: the forward launches it and
    keeps its inputs and its h_seq; the backward launches the BPTT kernel
    for every input that needs a gradient (x_seq too: a second layer feeds
    on the first).  The differentiable layer that mirrors the JAX
    package's ``custom_vjp`` cell; federated training does not go through
    it, but calls the layer and :func:`gru_layer_bptt` itself
    (``models/forecaster.py::loss_and_grads``)."""

    @staticmethod
    def forward(ctx, x_seq, h0, wx, wh, b):
        h_seq = _launch(x_seq, h0, wx, wh, b)
        ctx.save_for_backward(x_seq, h0, wx, wh, b, h_seq)
        return h_seq

    @staticmethod
    def backward(ctx, g_h):
        return _launch_bptt(*ctx.saved_tensors, g_h.contiguous(),
                            ctx.needs_input_grad)


def gru_layer(x_seq, h0, wx, wh, b, out=None):
    """Fused GRU layer.  x_seq: (T, B, I) time-major; h0: (B, H);
    wx: (I, 3H) [z|r|h~]; wh: (H, 3H); b: (3H,); or each with a leading
    client axis M.  Returns h_seq (T, B, H) or (M, T, B, H) in the input
    dtype, written into ``out`` (a preallocated h_seq, for a call that
    autograd does not record) where given."""
    args = (x_seq, h0, wx, wh, b)
    if all(t.device.type == "cpu" for t in args):
        got = ref.gru_layer_ref(*args)
        return got if out is None else ref.into(out, got)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if out is not None:
            raise ValueError("gru_layer: out= on a call autograd records")
        return GRULayer.apply(*args)
    return _launch(*args, out=out)


def gru_layer_bptt(x_seq, h0, wx, wh, b, h_seq, g_h, needs, out=None,
                   work=None):
    """The layer's VJP called directly, as :class:`GRULayer`'s backward
    launches it: the arguments, ``out`` and ``work`` of
    :func:`_launch_bptt`; on the CPU the plain version
    (:func:`repro_torch.kernels.ref.gru_layer_bptt_ref`)."""
    args = (x_seq, h0, wx, wh, b, h_seq, g_h)
    if all(t.device.type == "cpu" for t in args):
        got = ref.gru_layer_bptt_ref(*args, needs)
        return got if out is None else ref.into(out, got)
    return _launch_bptt(*args, needs, out=out, work=work)


def gru_cell(x, h, wx, wh, b):
    """Fused GRU step.  x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~];
    wh: (H, 3H); b: (3H,).  Returns h' in the input dtype."""
    if all(t.device.type == "cpu" for t in (x, h, wx, wh, b)):
        return ref.gru_cell_ref(x, h, wx, wh, b)
    if x.dim() != 2:
        raise ValueError(f"gru_cell: x must be 2-D, got {tuple(x.shape)}")
    return gru_layer(x.unsqueeze(0), h, wx, wh, b)[0]
