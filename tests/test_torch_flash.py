"""The port's flash attention against the JAX package's.

On the CPU the port's ``ops.flash_attention`` computes its plain version
(``kernels/ref.py::flash_attention_ref``); both are held against the JAX
Pallas kernel in interpret mode and against the JAX oracle
``repro.kernels.ref.flash_attention_ref``, on the cases of
``tests/test_kernels.py`` (MHA, GQA 4:1, MQA, sliding window, 6 heads with
hd 16; and bf16 at hd 64 and at the LM path's hd 128 with GQA 5:1), inputs
from a numpy seed, at 2e-5 (fp32) / 3e-2 (bf16).
Causal only: the JAX kernel and oracle disagree on windows without
``causal`` (ROADMAP C).  The CUDA kernel itself is held against the same
plain version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# (B, S, Hq, Hkv, hd, window, block_q, block_k); blocks feed Pallas only
SWEEP = [
    (2, 128, 4, 4, 32, 0, 64, 64),          # MHA
    (2, 256, 8, 2, 64, 0, 128, 128),        # GQA 4:1
    (1, 256, 4, 1, 64, 0, 128, 64),         # MQA
    (1, 512, 2, 2, 32, 128, 128, 128),      # sliding window
    (3, 384, 6, 2, 16, 0, 128, 128),        # odd head count / small hd
]
BF16 = (2, 256, 4, 2, 64, 0, 128, 128)
# the LM path's head size and GQA fold (qwen3-14b: hd 128, 40 / 8 heads)
BF16_PATH = (1, 256, 10, 2, 128, 0, 128, 128)
CASES = ([pytest.param(c, "float32", id=f"fp32-{i}")
          for i, c in enumerate(SWEEP)]
         + [pytest.param(BF16, "bfloat16", id="bf16"),
            pytest.param(BF16_PATH, "bfloat16", id="bf16-hd128-gqa5")])
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, S, Hq, Hkv, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, Hq, hd)), r.normal(size=(B, S, Hkv, hd)),
            r.normal(size=(B, S, Hkv, hd)))


def _jax(arrs, dname):
    return [jnp.asarray(a, getattr(jnp, dname)) for a in arrs]


def _torch(arrs, dname):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dname)) for a in arrs]


def _close(t, j, dname):
    assert t.dtype == getattr(torch, dname)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=TOL[dname], atol=TOL[dname])


@pytest.mark.parametrize("case,dname", CASES)
def test_port_flash_matches_pallas_kernel(case, dname):
    B, S, Hq, Hkv, hd, win, bq, bk = case
    arrs = _inputs(B, S, Hq, Hkv, hd, S + Hq)
    want = jflash(*_jax(arrs, dname), window=win, block_q=bq, block_k=bk,
                  interpret=True)
    got = ops.flash_attention(*_torch(arrs, dname), window=win)
    assert got.shape == (B, S, Hq, hd)
    _close(got, want, dname)


@pytest.mark.parametrize("case,dname", CASES)
def test_port_ref_matches_jax_ref(case, dname):
    B, S, Hq, Hkv, hd, win, _, _ = case
    arrs = _inputs(B, S, Hq, Hkv, hd, S + Hq)
    want = jref.flash_attention_ref(*_jax(arrs, dname), window=win)
    _close(ref.flash_attention_ref(*_torch(arrs, dname), window=win), want,
           dname)


@pytest.mark.parametrize("S,win", [(200, 0), (200, 48), (4096, 0),
                                   (4096, 1000)])
def test_plain_attention_path_matches_ref(S, win):
    """The model's plain route (``_causal_attend``, q-chunked at S >= 4096)
    and its kernel route (the plain version on the CPU) agree, for an
    unaligned S and with a window."""
    B, Hq, Hkv, hd = 1, 2, 1, 16
    q, k, v = _torch(_inputs(B, S, Hq, Hkv, hd, S), "float32")
    plain = tattn._causal_attend(q, k, v, hd ** -0.5, win, torch.float32,
                                 "torch")
    kernel = tattn._causal_attend(q, k, v, hd ** -0.5, win, torch.float32,
                                  "kernel")
    torch.testing.assert_close(kernel, plain, rtol=2e-5, atol=2e-5)


def test_wrapper_counts_no_launch_on_cpu_and_refuses_unknown_impl():
    q, k, v = _torch(_inputs(1, 64, 2, 1, 32, 0), "float32")
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError):
        tattn._causal_attend(q, k, v, 1.0, 0, torch.float32, "pallas")
