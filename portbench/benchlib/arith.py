"""The yardstick's arithmetic: peaks, a recurrent layer's bytes and
operations, its roofline bound, and the forecaster's model FLOPs.

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``,
``FP32_FLOPS_PER_S``, ``_layer_bytes_flops`` and ``_bound``, widened to M
clients of one launch.  Each input byte is read once and each output byte
written once, whatever the kernel reads again; the operations are the
layer's multiply-adds, 2·T·R·(I+H)·G·H for R rows as launched.  The
count is of the work, not of an implementation, so a later kernel,
library route or fusion is judged by the same numbers.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: HBM3 bandwidth and
# fp32 outside the tensor cores (the cells run fp32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

GATES = {"lstm": 4, "gru": 3}


def layer_bytes_flops(gates: int, T: int, B: int, I: int, H: int,
                      itemsize: int = 4, M: int = 1):
    """(bytes, flops) of one layer launch over M clients, each with its own
    weights: x_seq, h0 (and the LSTM's c0), the weights and bias read once;
    h_seq (and the LSTM's c_T) written once."""
    n = T * B * I + B * H + I * gates * H + H * gates * H + gates * H \
        + T * B * H + (2 * B * H if gates == 4 else 0)
    return M * itemsize * n, M * 2 * T * B * (I + H) * gates * H


def bound_s(nbytes: float, flops: float):
    """(seconds, "bytes" | "operations"): the least time the card could
    take, the larger of bytes over bandwidth and operations over peak."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS_PER_S
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def forward_flops_per_row(cfg: dict) -> int:
    """Multiply-add FLOPs of one window through the recurrent layers and
    the head (the products; gate nonlinearities and adds left out)."""
    G, H, L = GATES[cfg["cell"]], cfg["hidden_dim"], cfg["lookback"]
    n, inp = 0, cfg["input_dim"]
    for _ in range(cfg["n_layers"]):
        n += 2 * L * (inp + H) * G * H
        inp = H
    return n + 2 * H * cfg["horizon"]
