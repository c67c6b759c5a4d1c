"""The yardstick's operation and byte counts against hand counts at the
four cells' shapes (fp32, H=64, look-back 8, I=1)."""
import pytest

from benchlib import arith


def _hand(G, T, B, I, H, M):
    ins = T * B * I + B * H + I * G * H + H * G * H + G * H
    outs = T * B * H + (2 * B * H if G == 4 else 0)
    return M * 4 * (ins + outs), M * 2 * T * B * (I + H) * G * H


@pytest.mark.parametrize("cell,G,B,M,flops,nbytes,bound_us,by", [
    # fl-sync.lstm-h64.m100: 100 clients x B=64 a launch
    ("lstm", 4, 64, 100, 1_703_936_000, 24_985_600, 25.432, "operations"),
    # fl-sync.gru-h64.m1000: 1,000 clients x B=64
    ("gru", 3, 64, 1000, 12_779_520_000, 200_192_000, 190.739, "operations"),
    # serve-open.lstm-h64.p80 at its largest bucket
    ("lstm", 4, 256, 1, 68_157_440, 796_672, 1.017, "operations"),
    # serve-closed.gru-h64.c1024 at its largest bucket
    ("gru", 3, 256, 1, 51_118_080, 648_704, 0.763, "operations"),
])
def test_layer_counts(cell, G, B, M, flops, nbytes, bound_us, by):
    got = arith.layer_bytes_flops(arith.GATES[cell], 8, B, 1, 64, M=M)
    assert got == (nbytes, flops) == _hand(G, 8, B, 1, 64, M)
    s, which = arith.bound_s(*got)
    assert which == by
    assert s * 1e6 == pytest.approx(bound_us, abs=1e-3)


def test_bytes_bound_at_one_row():
    nbytes, flops = arith.layer_bytes_flops(4, 8, 1, 1, 64)
    assert arith.bound_s(nbytes, flops)[1] == "bytes"


@pytest.mark.parametrize("cell,per_row,step_gflop", [
    ("lstm", 266_752, 5.12),       # 100 clients x 64 windows a step
    ("gru", 200_192, 38.44),       # 1,000 clients x 64 windows a step
])
def test_model_flops(cell, per_row, step_gflop):
    cfg = dict(cell=cell, input_dim=1, hidden_dim=64, n_layers=1,
               lookback=8, horizon=4)
    assert arith.forward_flops_per_row(cfg) == per_row
    rows = 6400 if cell == "lstm" else 64000
    assert 3 * per_row * rows / 1e9 == pytest.approx(step_gflop, abs=0.01)


def test_peaks():
    assert arith.FP32_FLOPS_PER_S == 67e12
    assert arith.HBM_BYTES_PER_S == 3.35e12
