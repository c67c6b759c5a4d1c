"""The port's fused-cell wrappers and plain cells against the JAX package's
Pallas cells (interpret mode) and ``kernels/ref.py`` oracles.

On the CPU the wrappers compute the plain PyTorch versions; the CUDA kernels
themselves are held against those same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  Inputs come from a
numpy seed and go to both frameworks; tolerances are those of
``tests/test_kernels.py`` (2e-5 fp32, 2e-2 bf16) for one step.  The layers
(the cell scanned over T steps) are held to a ``lax.scan`` of the JAX cells
at 2e-5 in fp32 and, in bf16 past one step, at 8e-2: both sides round the
state to bf16 every step, but the plain cell also rounds its two products
and their sum, and those differences carry through the recurrence (0.070
is the largest seen, the GRU at T=13, H=256).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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


def _layer_tol(name, T):
    if name == "bfloat16":
        return dict(rtol=8e-2, atol=8e-2) if T > 1 else _tol(name)
    return _tol(name)


def _scan(step, carry, xs):
    return jax.lax.scan(lambda c, x: step(c, x), carry, xs)


@pytest.mark.parametrize("T", [1, 8, 13])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,I,H,bb,bh", LSTM_SHAPES)
def test_lstm_layer_matches_jax_scan(B, I, H, bb, bh, dt, T):
    """lstm_layer (the plain layer on the CPU) against lax.scan of the JAX
    Pallas cell (interpret mode) and of its jnp oracle: every step's h and
    the last c."""
    name, jdt, tdt = dt
    r = np.random.default_rng(B + I + H + T)
    arrs = [r.normal(size=(T, B, I)), r.normal(size=(B, H)),
            r.normal(size=(B, H)), r.normal(size=(I, 4 * H)) * 0.2,
            r.normal(size=(H, 4 * H)) * 0.2, r.normal(size=(4 * H,)) * 0.2]
    js, ts = zip(*[_pair(a, jdt, tdt) for a in arrs])
    xs, h0, c0, wx, wh, b = js

    def pallas(carry, x):
        h, c = jax_lstm_cell(x, *carry, wx, wh, b, block_b=bb, block_h=bh,
                             interpret=True)
        return (h, c), h

    def oracle(carry, x):
        h, c = jref.lstm_cell_ref(x, *carry, wx, wh, b)
        return (h, c), h

    p = {"wx": ts[3], "wh": ts[4], "b": ts[5]}
    h_seq, c_T = ops.lstm_layer_fused(ts[0], ts[1], ts[2], p)
    assert h_seq.shape == (T, B, H) and h_seq.dtype == c_T.dtype == tdt
    for step in (pallas, oracle):
        (_, c_j), h_j = _scan(step, (h0, c0), xs)
        _close(h_seq, h_j, **_layer_tol(name, T))
        _close(c_T, c_j, **_layer_tol(name, T))
    # with fp32 sums the plain layer is the Pallas cell's scan, at the step
    # tolerance
    h_f, c_f = ref.lstm_layer_ref(*ts, fp32_sums=True)
    (_, c_j), h_j = _scan(pallas, (h0, c0), xs)
    _close(h_f, h_j, **_tol(name))
    _close(c_f, c_j, **_tol(name))


@pytest.mark.parametrize("T", [1, 8, 13])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("B,I,H,bb,bh", GRU_SHAPES)
def test_gru_layer_matches_jax_scan(B, I, H, bb, bh, dt, T):
    name, jdt, tdt = dt
    r = np.random.default_rng(B + I + H + T + 1)
    arrs = [r.normal(size=(T, B, I)), r.normal(size=(B, H)),
            r.normal(size=(I, 3 * H)) * 0.2, r.normal(size=(H, 3 * H)) * 0.2,
            r.normal(size=(3 * H,)) * 0.2]
    js, ts = zip(*[_pair(a, jdt, tdt) for a in arrs])
    xs, h0, wx, wh, b = js

    def pallas(h, x):
        h = jax_gru_cell(x, h, wx, wh, b, block_b=bb, block_h=bh,
                         interpret=True)
        return h, h

    def oracle(h, x):
        h = jref.gru_cell_ref(x, h, wx, wh, b)
        return h, h

    p = {"wx": ts[2], "wh": ts[3], "b": ts[4]}
    h_seq = ops.gru_layer_fused(ts[0], ts[1], p)
    assert h_seq.shape == (T, B, H) and h_seq.dtype == tdt
    for step in (pallas, oracle):
        _, h_j = _scan(step, h0, xs)
        _close(h_seq, h_j, **_layer_tol(name, T))
    _, h_j = _scan(pallas, h0, xs)
    _close(ref.gru_layer_ref(*ts, fp32_sums=True), h_j, **_tol(name))


def test_step_is_the_layer_at_one_step():
    """The step wrappers compute what the layer wrappers compute at T = 1."""
    r = np.random.default_rng(9)
    B, I, H = 5, 3, 8

    def f(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))

    x, h, c = f(B, I), f(B, H), f(B, H)
    lp = {"wx": f(I, 4 * H), "wh": f(H, 4 * H), "b": f(4 * H)}
    gp = {"wx": f(I, 3 * H), "wh": f(H, 3 * H), "b": f(3 * H)}
    h1, c1 = ops.lstm_cell_fused(x, h, c, lp)
    h_seq, c_T = ops.lstm_layer_fused(x[None], h, c, lp)
    assert torch.equal(h1, h_seq[0]) and torch.equal(c1, c_T)
    assert torch.equal(ops.gru_cell_fused(x, h, gp),
                       ops.gru_layer_fused(x[None], h, gp)[0])


@pytest.mark.parametrize("name,B,I,H,itemsize,want", [
    # the serving shape: one block holds the weights; 2 rows a block make
    # 128 blocks for 132 SMs; 4 lanes a column
    ("lstm_cell", 256, 1, 64, 4, (1, 2, 2, 4, 256)),
    ("gru_cell", 256, 64, 64, 4, (1, 2, 2, 4, 256)),
    ("lstm_cell", 8, 1, 64, 4, (1, 1, 1, 4, 256)),
    ("gru_cell", 37, 50, 50, 4, (1, 1, 1, 4, 224)),  # ragged: 200 threads
    ("lstm_cell", 1, 3, 1, 4, (1, 1, 1, 4, 32)),
    # the sweeps' wide shapes: clusters split the hidden columns
    ("lstm_cell", 128, 4, 128, 4, (2, 2, 2, 4, 256)),
    ("lstm_cell", 128, 4, 128, 2, (1, 1, 1, 4, 512)),
    ("gru_cell", 128, 4, 128, 4, (1, 1, 1, 4, 512)),
    ("lstm_cell", 32, 16, 256, 4, (8, 2, 2, 4, 128)),
    ("gru_cell", 32, 16, 256, 4, (4, 1, 1, 4, 256)),
    ("lstm_cell", 32, 64, 256, 4, (8, 2, 2, 4, 128)),
    ("lstm_cell", 32, 16, 256, 2, (4, 1, 1, 4, 256)),
    # 160 columns x 4 lanes would pass 512 threads: 2 lanes a column
    ("gru_cell", 64, 4, 160, 2, (1, 1, 1, 2, 320)),
    ("lstm_cell", 256, 4, 160, 2, (1, 2, 2, 2, 320)),
])
def test_cell_plan(name, B, I, H, itemsize, want):
    """The launch plan (cluster, rows, rows per thread, k-split, threads) at
    the paths' and the tests' shapes, for a card of 132 SMs, and its shared
    memory within one block's."""
    from repro_torch.kernels import _cuda
    plan = _cuda.cell_plan(name, B, I, H, itemsize, 132)
    assert tuple(plan) == want
    assert _cuda.cell_smem_bytes(_cuda.GATES[name], I, H, plan.cluster,
                                 plan.rows, itemsize) <= _cuda.SMEM_LIMIT


def test_cell_plan_refuses_plans_the_kernels_do_not_take():
    """The kernels are built for 1 or 2 rows a thread and 2 or 4 lanes a
    column, within 512 threads and 4 rows a block."""
    from repro_torch.kernels import _cuda
    assert _cuda.cell_plan("gru_cell", 256, 1, 64, 4, 132, 4, 1, 2) == \
        (1, 4, 1, 2, 512)
    for rows, rpt, ks in ((4, 1, 4), (2, 4, 4), (3, 2, 4), (8, 2, 4),
                          (2, 2, 1), (2, 2, 8)):
        with pytest.raises(ValueError, match="launch plan"):
            _cuda.cell_plan("gru_cell", 256, 1, 64, 4, 132, rows, rpt, ks)


def test_cell_range_refuses_what_eight_blocks_cannot_hold():
    """cell_dims raises ValueError outside the range: a weight matrix that 8
    blocks' shared memory cannot hold, or an empty axis; every shape of the
    tests, configs and chip_smoke.py (H <= 256, I <= 64) is inside."""
    from repro_torch.kernels import _cuda
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)  # noqa: E731
    for name in ("lstm_cell", "gru_cell"):
        for H in (1, 16, 50, 64, 128, 256):
            for I in (1, 16, 64):
                assert _cuda.cell_dims(name, z(8, 4, I), z(4, H)) == \
                    (8, 4, I, H)
        with pytest.raises(ValueError, match="outside the kernel's range"):
            _cuda.cell_dims(name, z(8, 4, 1), z(4, 512))
        with pytest.raises(ValueError, match="outside the kernel's range"):
            _cuda.cell_dims(name, z(0, 4, 1), z(4, 64))
        with pytest.raises(ValueError, match="3-D"):
            _cuda.cell_dims(name, z(4, 1), z(4, 64))
    # bf16 weights take half the bytes, so the range reaches further
    assert _cuda.cell_dims("lstm_cell", z(8, 4, 1, dt=torch.bfloat16),
                           z(4, 384, dt=torch.bfloat16)) == (8, 4, 1, 384)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        _cuda.cell_dims("lstm_cell", z(8, 4, 1), z(4, 384))


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
    hs, c = ops.lstm_layer_fused(f(4, B, I), f(B, H), f(B, H),
                                 {"wx": f(I, 4 * H), "wh": f(H, 4 * H),
                                  "b": f(4 * H)})
    gs = ops.gru_layer_fused(f(4, B, I), f(B, H),
                             {"wx": f(I, 3 * H), "wh": f(H, 3 * H),
                              "b": f(3 * H)})
    assert hs.shape == gs.shape == (4, B, H) and c.shape == (B, H)
    assert ops.launch_counts() == {"lstm_cell": 0, "gru_cell": 0,
                                   "flash_attention": 0, "lstm_bptt": 0,
                                   "gru_bptt": 0}


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
    with pytest.raises(ValueError, match="CUDA"):
        ops.gru_layer_fused(torch.zeros(2, B, I),
                            torch.zeros(B, H, device="meta"),
                            {"wx": torch.zeros(I, 3 * H),
                             "wh": torch.zeros(H, 3 * H),
                             "b": torch.zeros(3 * H)})
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
