"""The port's fused-cell wrappers and plain cells against the JAX package's
Pallas cells (interpret mode) and ``kernels/ref.py`` oracles.

On the CPU the wrappers compute the plain PyTorch versions; the CUDA kernels
themselves are held against those same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Inputs come from a
numpy seed and go to both frameworks; tolerances are those of
``tests/test_kernels.py`` (2e-5 fp32, 2e-2 bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gru_cell import gru_cell as jax_gru_cell  # noqa: E402
from repro.kernels.lstm_cell import lstm_cell as jax_lstm_cell  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, jdt, tdt):
    """One numpy array -> (jax array, torch tensor) holding the same values
    in the working dtype."""
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    return j, t


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# the sweeps of tests/test_kernels.py plus the serving shape (B=256, I=1,
# H=64); block sizes feed the Pallas side only
LSTM_SHAPES = [(8, 1, 16, 8, 16), (64, 8, 64, 32, 32), (128, 4, 128, 128, 128),
               (32, 16, 256, 16, 64), (256, 1, 64, 128, 64)]
GRU_SHAPES = [(8, 1, 16, 8, 16), (64, 8, 64, 32, 32), (128, 4, 128, 128, 128),
              (256, 1, 64, 128, 64)]


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,I,H,bb,bh", LSTM_SHAPES)
def test_lstm_cell_matches_jax(B, I, H, bb, bh, dt):
    name, jdt, tdt = dt
    r = np.random.default_rng(B + I + H)
    arrs = [r.normal(size=(B, I)), r.normal(size=(B, H)),
            r.normal(size=(B, H)), r.normal(size=(I, 4 * H)) * 0.2,
            r.normal(size=(H, 4 * H)) * 0.2, r.normal(size=(4 * H,)) * 0.2]
    js, ts = zip(*[_pair(a, jdt, tdt) for a in arrs])
    h_pl, c_pl = jax_lstm_cell(*js, block_b=bb, block_h=bh, interpret=True)
    h_ref, c_ref = jref.lstm_cell_ref(*js)
    p = {"wx": ts[3], "wh": ts[4], "b": ts[5]}
    h_t, c_t = ops.lstm_cell_fused(ts[0], ts[1], ts[2], p)
    h_r, c_r = ref.lstm_cell_ref(*ts)
    assert h_t.dtype == tdt and c_t.dtype == tdt
    for ht, ct in ((h_t, c_t), (h_r, c_r)):
        _close(ht, h_pl, **_tol(name))
        _close(ct, c_pl, **_tol(name))
        _close(ht, h_ref, **_tol(name))
        _close(ct, c_ref, **_tol(name))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,I,H,bb,bh", GRU_SHAPES)
def test_gru_cell_matches_jax(B, I, H, bb, bh, dt):
    name, jdt, tdt = dt
    r = np.random.default_rng(B + I + H + 1)
    arrs = [r.normal(size=(B, I)), r.normal(size=(B, H)),
            r.normal(size=(I, 3 * H)) * 0.2, r.normal(size=(H, 3 * H)) * 0.2,
            r.normal(size=(3 * H,)) * 0.2]
    js, ts = zip(*[_pair(a, jdt, tdt) for a in arrs])
    h_pl = jax_gru_cell(*js, block_b=bb, block_h=bh, interpret=True)
    h_ref = jref.gru_cell_ref(*js)
    p = {"wx": ts[2], "wh": ts[3], "b": ts[4]}
    h_t = ops.gru_cell_fused(ts[0], ts[1], p)
    h_r = ref.gru_cell_ref(*ts)
    assert h_t.dtype == tdt
    for ht in (h_t, h_r):
        _close(ht, h_pl, **_tol(name))
        _close(ht, h_ref, **_tol(name))


def test_cpu_wrappers_launch_nothing():
    """CPU tensors take the plain versions: no kernel is built or launched,
    so the launch counters stay at zero."""
    ops.reset_launch_counts()
    r = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))  # noqa: E731
    B, I, H = 37, 3, 50                   # ragged: no block divides it
    h, c = ops.lstm_cell_fused(f(B, I), f(B, H), f(B, H),
                               {"wx": f(I, 4 * H), "wh": f(H, 4 * H),
                                "b": f(4 * H)})
    g = ops.gru_cell_fused(f(B, I), f(B, H),
                           {"wx": f(I, 3 * H), "wh": f(H, 3 * H),
                            "b": f(3 * H)})
    assert h.shape == c.shape == g.shape == (B, H)
    assert ops.launch_counts() == {"lstm_cell": 0, "gru_cell": 0,
                                   "flash_attention": 0}


def test_cuda_path_refuses_a_cpu_cuda_mix():
    """Tensors not all on the CPU take the kernel path, whose checks raise
    rather than fall back to the plain version (a meta tensor stands in for
    a non-CPU device here)."""
    B, I, H = 4, 1, 8
    args = [torch.zeros(B, I), torch.zeros(B, H, device="meta"),
            torch.zeros(B, H), torch.zeros(I, 4 * H), torch.zeros(H, 4 * H),
            torch.zeros(4 * H)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.lstm_cell_fused(args[0], args[1], args[2],
                            {"wx": args[3], "wh": args[4], "b": args[5]})
    assert ops.launch_counts()["lstm_cell"] == 0


def test_ptxas_report_reads_each_kernels_numbers():
    """The build keeps nvcc's ``-Xptxas -v`` report; ``ptxas_report`` reads
    registers, stack, spills and static shared memory per kernel."""
    from repro_torch.kernels import _cuda
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z4flashILi128EEvv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z4flashILi128EEvv",
        "    72 bytes stack frame, 72 bytes spill stores, 64 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem",
        "ptxas info    : Compiling entry function '_Z4cellv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers",
    ])
    assert "-Xptxas" in _cuda.NVCC_FLAGS and "-v" in _cuda.NVCC_FLAGS
    assert _cuda.ptxas_report(log) == [
        {"kernel": "_Z4flashILi128EEvv", "stack_bytes": 72,
         "spill_store_bytes": 72, "spill_load_bytes": 64, "registers": 168,
         "static_smem_bytes": 16},
        {"kernel": "_Z4cellv", "stack_bytes": 0, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "registers": 32}]
    assert _cuda.ptxas_report("") == []
