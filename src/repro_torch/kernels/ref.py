"""Plain PyTorch versions of the CUDA kernels: the fused recurrent cells, the
recurrent layers (the cells scanned over a time-major sequence) and causal
flash attention.

They are the correctness ground truth for the CUDA kernels (``csrc/``), what
the kernel wrappers compute for tensors on the CPU, and, on the card, what
the recurrent layers' autograd backward differentiates; the counterpart of
``src/repro/kernels/ref.py``.  Same layouts as the JAX package: gates
``[i|f|g|o]`` (LSTM) and ``[z|r|h~]`` (GRU) along the last axis of
``wx (I, G*H)`` / ``wh (H, G*H)``, one bias, no hidden bias in the GRU;
attention in ``(B, S, H, hd)``.

The cells and layers also take a leading client axis M, one weight set per
client (the JAX package's ``vmap`` over clients, written out): x
``(M, B, I)`` or x_seq ``(M, T, B, I)``, h and c ``(M, B, H)``, wx
``(M, I, G*H)``, wh ``(M, H, G*H)``, b ``(M, G*H)``; the products are
batched matmuls and the bias broadcasts over each client's rows.
"""
from __future__ import annotations

import torch


def _rows(b):
    """The bias broadcast over the batch rows: (G*H,) as it is, (M, G*H)
    as (M, 1, G*H)."""
    return b if b.dim() == 1 else b.unsqueeze(-2)


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x: (B, I); h, c: (B, H); wx: (I, 4H) [i|f|g|o]; wh: (H, 4H); b: (4H,);
    or each with a leading client axis M."""
    z = x @ wx + h @ wh + _rows(b)
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def gru_cell_ref(x, h, wx, wh, b):
    """x: (B, I); h: (B, H); wx: (I, 3H) [z|r|h~]; wh: (H, 3H); b: (3H,);
    or each with a leading client axis M."""
    H = h.shape[-1]
    zx = x @ wx + _rows(b)
    zh = h @ wh
    z = torch.sigmoid(zx[..., :H] + zh[..., :H])
    r = torch.sigmoid(zx[..., H:2 * H] + zh[..., H:2 * H])
    h_tilde = torch.tanh(zx[..., 2 * H:] + r * zh[..., 2 * H:])
    return z * h + (1.0 - z) * h_tilde


def _steps(x_seq):
    """The time axis of x_seq: 0 for (T, B, I), 1 for (M, T, B, I)."""
    return x_seq.dim() - 3


def lstm_layer_ref(x_seq, h0, c0, wx, wh, b, *, fp32_sums=False):
    """The LSTM cell scanned over time.  x_seq: (T, B, I) time-major; h0, c0:
    (B, H); or each with a leading client axis M.  Returns (h_seq (T, B, H)
    or (M, T, B, H), c_T).  Each step's h and c come out in the input dtype,
    so the carried state is rounded every step.  With ``fp32_sums`` a step
    computes in fp32 from the inputs' values and only its h and c are
    rounded: the function of the fused kernels (and of the JAX package's
    Pallas cell), which differs from the plain cell in bf16."""
    dt, h, c, hs = h0.dtype, h0, c0, []
    w = [t.float() for t in (wx, wh, b)] if fp32_sums else (wx, wh, b)
    axis = _steps(x_seq)
    for x_t in x_seq.unbind(axis):
        if fp32_sums:
            h, c = lstm_cell_ref(x_t.float(), h.float(), c.float(), *w)
            h, c = h.to(dt), c.to(dt)
        else:
            h, c = lstm_cell_ref(x_t, h, c, *w)
        hs.append(h)
    return torch.stack(hs, dim=axis), c


def gru_layer_ref(x_seq, h0, wx, wh, b, *, fp32_sums=False):
    """The GRU cell scanned over time.  x_seq: (T, B, I); h0: (B, H); or
    each with a leading client axis M.  Returns h_seq (T, B, H) or
    (M, T, B, H), each step rounded to the input dtype; ``fp32_sums`` as in
    :func:`lstm_layer_ref`."""
    dt, h, hs = h0.dtype, h0, []
    w = [t.float() for t in (wx, wh, b)] if fp32_sums else (wx, wh, b)
    axis = _steps(x_seq)
    for x_t in x_seq.unbind(axis):
        if fp32_sums:
            h = gru_cell_ref(x_t.float(), h.float(), *w).to(dt)
        else:
            h = gru_cell_ref(x_t, h, *w)
        hs.append(h)
    return torch.stack(hs, dim=axis)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd). GQA via head grouping.

    Returns (B, S, H, hd) in v's dtype.  Plain materialized-scores version:
    scores in the input dtype, then fp32 scale, mask (-1e30) and softmax;
    the weights go back to v's dtype for the product.  As in the JAX oracle,
    ``window`` applies only with ``causal``.
    """
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bskgh,btkh->bskgt", qg, k).float() * scale
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = j <= i
        if window:
            mask &= j > i - window
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkh->bskgh", w.to(v.dtype), v).to(v.dtype)
    return o.reshape(B, S, Hq, hd)


def plain_vjp(fn, inputs, needs_grad, grads):
    """The vector-Jacobian product of the plain function ``fn`` at
    ``inputs`` for its outputs' cotangents ``grads``: ``fn`` recomputed
    under autograd from detached copies of the inputs, then differentiated.
    Returns one gradient per input, None where ``needs_grad`` is False; the
    backward of the kernels' autograd Functions, as the JAX package's
    ``custom_vjp`` cells take the VJP of their oracle."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs_grad)]
    with torch.enable_grad():
        outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t, n in zip(inputs, needs_grad) if n]
    got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
    return tuple(next(got) if n else None for n in needs_grad)
