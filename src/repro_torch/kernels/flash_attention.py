"""Causal flash attention: the wrapper around the CUDA kernel
``csrc/flash_attention.cu``, the counterpart of
``src/repro/kernels/flash_attention.py``.

The kernel runs the online softmax over key tiles, so the (S, S) scores
never reach device memory; it takes the JAX package's (B, S, H, hd) layout
as it is and folds each query head onto its KV head (GQA) without
replicating K/V.  Tensors on the CPU take the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); CUDA tensors launch
the kernel or raise.  Causal only, as its one caller
(``models/attention.py::_causal_attend``) needs; forward only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref

# head dims the kernel is built for (one template instance each); 112 is
# Zamba2's shared attention block, held at a padded 128 in the bf16 kernel
HEAD_DIMS = (16, 32, 64, 112, 128)


def flash_attention(q, k, v, *, window=0, scale=None):
    """q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) with Hq % Hkv == 0 ->
    (B, S, Hq, hd) in the input dtype, with the causal mask j <= i.
    ``window`` > 0 also masks keys j <= i - window; ``scale`` defaults to
    hd ** -0.5."""
    args = (q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if all(t.device.type == "cpu" for t in args):
        return ref.flash_attention_ref(q, k, v, window=window, scale=scale)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-D (B, S, H, "
                         f"hd), got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if hd not in HEAD_DIMS or Hkv < 1 or Hq % Hkv or S < 1 or window < 0:
        raise ValueError(
            f"flash_attention: B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, hd={hd}, "
            f"window={window} outside the kernel's range (hd in {HEAD_DIMS}, "
            "Hq a multiple of Hkv, S >= 1, window >= 0)")
    _cuda.check_inputs("flash_attention", args,
                       [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)])
    out = torch.empty_like(q)
    _cuda.launch("flash_attention", (q, k, v, out),
                 (B, S, Hq, Hkv, hd, int(window), float(scale)))
    _cuda.LAUNCHES["flash_attention"] += 1
    return out
