"""The CUDA kernels on the card: each against its plain version, the launch
counters, and the wrappers' refusals.  Every test needs a CUDA device and
skips without one.  This file imports no JAX, so it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.client import local_update  # noqa: E402
from repro_torch.kernels import lstm_cell, ops, ref  # noqa: E402
from repro_torch.launch import lm_steps  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# a layer past one step in bf16: the plain cell rounds its two products and
# their sum to bf16, the kernel sums in fp32, and the recurrence carries the
# difference (0.138 seen at H=256 with weights of std 0.3, T=8); against the
# plain cell with fp32 sums, the kernel's own function, TOL holds
LAYER_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.2}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, dt, *shape):
    return (torch.randn(*shape, generator=gen) * 0.3).to(dev, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,I,H", [(8, 1, 16), (37, 1, 50), (37, 50, 50),
                                   (256, 1, 64), (32, 16, 256), (1, 3, 1)])
def test_kernels_match_plain(cuda, B, I, H, dt):
    g = torch.Generator().manual_seed(B * 1000 + I * 10 + H)
    r = lambda *s: _rand(g, cuda, dt, *s)  # noqa: E731
    ops.reset_launch_counts()
    x, h, c = r(B, I), r(B, H), r(B, H)
    lp = {"wx": r(I, 4 * H), "wh": r(H, 4 * H), "b": r(4 * H)}
    gp = {"wx": r(I, 3 * H), "wh": r(H, 3 * H), "b": r(3 * H)}
    h1, c1 = ops.lstm_cell_fused(x, h, c, lp)
    h2, c2 = ref.lstm_cell_ref(x, h, c, lp["wx"], lp["wh"], lp["b"])
    g1 = ops.gru_cell_fused(x, h, gp)
    g2 = ref.gru_cell_ref(x, h, gp["wx"], gp["wh"], gp["b"])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"lstm_cell": 1, "gru_cell": 1,
                                   "flash_attention": 0}
    for a, b in ((h1, h2), (c1, c2), (g1, g2)):
        assert a.dtype == dt and a.device == x.device
        torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dt],
                                   atol=TOL[dt])


def _layer_args(g, dev, dt, T, B, I, H, gates):
    r = lambda *s: _rand(g, dev, dt, *s)  # noqa: E731
    return (r(T, B, I), r(B, H), r(B, H), r(I, gates * H), r(H, gates * H),
            r(gates * H))


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,I,H", [
    (37, 1, 50), (37, 50, 50),        # ragged: no block or copy divides them
    (256, 1, 64), (256, 64, 64),      # the serving shapes: cluster 1
    (128, 4, 128),                    # LSTM fp32: cluster 2
    (32, 16, 256),                    # GRU fp32: 4, LSTM fp32: 8, bf16: 4, 2
    (32, 64, 256),                    # the widest x of the range
    (64, 4, 160),                     # bf16: 2 lanes a column; GRU fp32: 2
])
def test_layers_match_plain(cuda, B, I, H, dt, T):
    """Each layer kernel against its plain version (the plain cell stepped T
    times): every step's h, and the LSTM's last c; one launch each."""
    g = torch.Generator().manual_seed(B * 1000 + I * 10 + H + T)
    x, h, c, wx, wh, b = _layer_args(g, cuda, dt, T, B, I, H, 4)
    ops.reset_launch_counts()
    got = ops.lstm_layer(x, h, c, wx, wh, b)
    want = ref.lstm_layer_ref(x, h, c, wx, wh, b)
    fused = ref.lstm_layer_ref(x, h, c, wx, wh, b, fp32_sums=True)
    x, h, _, wx, wh, b = _layer_args(g, cuda, dt, T, B, I, H, 3)
    got_g = ops.gru_layer(x, h, wx, wh, b)
    want_g = ref.gru_layer_ref(x, h, wx, wh, b)
    fused_g = ref.gru_layer_ref(x, h, wx, wh, b, fp32_sums=True)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"lstm_cell": 1, "gru_cell": 1,
                                   "flash_attention": 0}
    tol = LAYER_TOL[dt] if T > 1 else TOL[dt]
    for a, w, f in ((got[0], want[0], fused[0]), (got[1], want[1], fused[1]),
                    (got_g, want_g, fused_g)):
        assert a.dtype == dt and a.shape == w.shape and a.is_cuda
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(a.float(), f.float(), rtol=TOL[dt],
                                   atol=TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_layer_at_one_step_is_the_step(cuda, dt):
    """The step wrappers are the layer kernels at T = 1: the same bits."""
    g = torch.Generator().manual_seed(11)
    x, h, c, wx, wh, b = _layer_args(g, cuda, dt, 1, 256, 1, 64, 4)
    h1, c1 = ops.lstm_cell_fused(x[0], h, c, {"wx": wx, "wh": wh, "b": b})
    h_seq, c_T = ops.lstm_layer(x, h, c, wx, wh, b)
    assert torch.equal(h1, h_seq[0]) and torch.equal(c1, c_T)
    x, h, _, wx, wh, b = _layer_args(g, cuda, dt, 1, 256, 64, 64, 3)
    assert torch.equal(ops.gru_cell_fused(x[0], h, {"wx": wx, "wh": wh,
                                                    "b": b}),
                       ops.gru_layer(x, h, wx, wh, b)[0])


def test_layer_wrappers_refuse_bad_inputs(cuda):
    """Outside the range (weights beyond 8 blocks' shared memory, an empty
    sequence), a 2-D sequence, a wrong shape or dtype, a CPU tensor: each
    raises before any launch."""
    g = torch.Generator().manual_seed(1)
    x, h, c, wx, wh, b = _layer_args(g, cuda, torch.float32, 4, 8, 2, 16, 4)
    big = _layer_args(g, cuda, torch.float32, 2, 4, 1, 512, 4)
    ops.reset_launch_counts()
    cases = [
        (ValueError, big),                                   # out of range
        (ValueError, (x[:0], h, c, wx, wh, b)),               # T = 0
        (ValueError, (x[0], h, c, wx, wh, b)),                # 2-D x_seq
        (ValueError, (x, h, c, wx, wh[:, :-1].contiguous(), b)),
        (ValueError, (x.transpose(0, 1).contiguous().transpose(0, 1), h, c,
                      wx, wh, b)),                            # not contiguous
        (ValueError, (x, h, c.cpu(), wx, wh, b)),             # device mix
        (TypeError, (x, h.bfloat16(), c, wx, wh, b)),         # dtype mix
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            ops.lstm_layer(*args)
    # a direct launch is forward only (the wrapper's autograd Function
    # records it instead)
    with pytest.raises(RuntimeError, match="forward only"):
        lstm_cell._launch(x, h, c, wx, wh.clone().requires_grad_(), b)
    gx, gh, _, gwx, gwh, gb = _layer_args(g, cuda, torch.float32, 2, 4, 1,
                                          512, 3)
    with pytest.raises(ValueError):
        ops.gru_layer(gx, gh, gwx, gwh, gb)
    assert ops.launch_counts() == {"lstm_cell": 0, "gru_cell": 0,
                                   "flash_attention": 0}


def test_wrappers_refuse_bad_inputs(cuda):
    g = torch.Generator().manual_seed(0)
    B, I, H = 8, 2, 16
    r = lambda *s: _rand(g, cuda, torch.float32, *s)  # noqa: E731
    x, h, c = r(B, I), r(B, H), r(B, H)
    wx, wh, b = r(I, 4 * H), r(H, 4 * H), r(4 * H)
    ops.reset_launch_counts()
    cases = [
        (TypeError, (x.bfloat16(), h, c, wx, wh, b)),        # mixed dtype
        (TypeError, tuple(t.half() for t in (x, h, c, wx, wh, b))),
        (ValueError, (x, h, c, wx, wh[:, :-1].contiguous(), b)),
        (ValueError, (x, h, c, wx.t().contiguous().t(), wh, b)),
        (ValueError, (x, h.cpu(), c, wx, wh, b)),             # device mix
        (ValueError, (x, r(B, 512), r(B, 512), r(I, 2048), r(512, 2048),
                      r(2048))),                              # out of range
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            ops.lstm_cell_fused(args[0], args[1], args[2],
                                {"wx": args[3], "wh": args[4], "b": args[5]})
    assert ops.launch_counts()["lstm_cell"] == 0
    with torch.no_grad():
        ops.lstm_cell_fused(x, h, c, {"wx": wx, "wh": wh, "b": b})
    assert ops.launch_counts()["lstm_cell"] == 1
    # where autograd records, the step goes through the layer's Function:
    # one launch, and a result that carries its backward
    h1, _ = ops.lstm_cell_fused(x, h, c, {"wx": wx.clone().requires_grad_(),
                                          "wh": wh, "b": b})
    assert h1.grad_fn is not None
    assert ops.launch_counts()["lstm_cell"] == 2


@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("gru", 2)])
def test_forecast_on_card_matches_cpu(cuda, cell, n_layers):
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(100, cfg.lookback, 1)).astype(np.float32))
    ops.reset_launch_counts()
    with torch.inference_mode():
        y_card = forecaster.forecast(
            {"layers": [{k: v.to(cuda) for k, v in p.items()}
                        for p in params["layers"]],
             "head": {k: v.to(cuda) for k, v in params["head"].items()}},
            x.to(cuda), cfg).cpu()
        y_cpu = forecaster.forecast(params, x, cfg, "torch")
    # one launch of the layer kernel per layer, over the whole look-back
    assert ops.launch_counts()[f"{cell}_cell"] == n_layers
    torch.testing.assert_close(y_card, y_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,win", [
    (2, 256, 8, 2, 64, 0),          # GQA 4:1
    (1, 512, 2, 2, 32, 128),        # sliding window
    (2, 200, 4, 2, 64, 0),          # unaligned S
    (1, 333, 6, 2, 16, 50),         # unaligned, windowed, hd 16
    (1, 300, 10, 2, 128, 0),        # hd 128, GQA 5:1 as in qwen3-14b
    (1, 300, 32, 32, 112, 0),       # hd 112, zamba2's shared block
    (1, 200, 8, 2, 112, 64),        # hd 112, GQA 4:1, windowed
])
def test_flash_matches_plain(cuda, B, S, Hq, Hkv, hd, win, dt):
    g = torch.Generator().manual_seed(S + Hq)
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(cuda, dt)
               for H in (Hq, Hkv, Hkv))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, window=win)
    assert out.dtype == dt and out.shape == q.shape and out.is_cuda
    torch.testing.assert_close(out.float(), want.float(), rtol=FLASH_TOL[dt],
                               atol=FLASH_TOL[dt])


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,win", [
    (1, 1, 8, 2, 128, 0),           # one row: every box mostly past S
    (2, 64, 8, 2, 64, 0),           # half a tile
    (1, 127, 4, 2, 32, 0),          # a tile less one row
    (1, 129, 4, 1, 16, 0),          # a tile and one row
    (1, 4097, 8, 2, 128, 0),        # the prefill length and one row
    (1, 1000, 4, 2, 64, 48),        # window inside one tile
    (1, 3000, 4, 2, 128, 1024),     # window across tiles
    (2, 300, 10, 2, 128, 0),        # GQA 5:1 at hd 128 (qwen3-14b)
    (1, 1, 4, 4, 112, 0),           # hd 112: one row, boxes past hd and S
    (1, 129, 32, 32, 112, 0),       # hd 112 (zamba2), a tile and one row
    (1, 1000, 8, 2, 112, 300),      # hd 112, GQA 4:1, window across tiles
])
def test_flash_bf16_tile_edges_match_plain(cuda, B, S, Hq, Hkv, hd, win):
    """The bf16 kernel (wgmma + TMA) at its tile and box edges: each element
    within 3e-2 of the plain version, and each row within 3e-2 of the plain
    row relative to the row's norm."""
    g = torch.Generator().manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(cuda, torch.bfloat16)
               for H in (Hq, Hkv, Hkv))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, window=win).float()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    rel = (out.float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(
        1e-30)
    assert float(rel.max()) <= tol


@pytest.mark.parametrize("scale", [-0.125, 0.0, 0.05])
def test_flash_bf16_any_scale_matches_plain(cuda, scale):
    """The bf16 kernel takes its row max on unscaled scores; a negative
    scale goes to wgmma as the sign of q, zero gives uniform weights."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, 300, H, 64, generator=g).to(cuda, torch.bfloat16)
               for H in (4, 2, 2))
    out = ops.flash_attention(q, k, v, window=100, scale=scale)
    want = ref.flash_attention_ref(q, k, v, window=100, scale=scale)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_flash_refuses_bad_inputs(cuda):
    g = torch.Generator().manual_seed(0)

    def qkv(hd=64, Hq=4, Hkv=2, dt=torch.float32):
        return [torch.randn(1, 64, H, hd, generator=g).to(cuda, dt)
                for H in (Hq, Hkv, Hkv)]
    q, k, v = qkv()
    ops.reset_launch_counts()
    cases = [
        (ValueError, (q, k.cpu(), v)),                      # device mix
        (ValueError, (q.cpu(), k, v)),
        (TypeError, qkv(dt=torch.float16)),                 # wrong dtype
        (TypeError, (q, k.bfloat16(), v)),
        (ValueError, qkv(hd=48)),                           # hd out of range
        (ValueError, qkv(hd=96)),
        (ValueError, qkv(hd=256)),
        (ValueError, qkv(Hq=3, Hkv=2)),                     # Hq % Hkv
        (ValueError, (q.transpose(1, 2).contiguous().transpose(1, 2), k, v)),
        (RuntimeError, (q.clone().requires_grad_(), k, v)),  # forward only
    ]
    for exc, args in cases:
        with pytest.raises(exc):
            ops.flash_attention(*args)
    assert ops.launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        ops.flash_attention(q.clone().requires_grad_(), k, v)
    assert ops.launch_counts()["flash_attention"] == 1


def test_lm_prefill_and_decode_kernel_route_match_plain(cuda):
    """The LM slice at a reduced width on the card: one flash launch per
    layer in the prefill, none in decode, logits of both routes within the
    bf16 tolerance scaled by the largest |logit|."""
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(),
                              n_kv_heads=2)
    gen = torch.Generator(cuda).manual_seed(0)
    params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                           device=cuda)
    with torch.inference_mode():
        ops.reset_launch_counts()
        kern = lm_steps.generate(params, {"tokens": prompt}, cfg, 4,
                                 attn_impl="kernel")
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        plain = lm_steps.generate(params, {"tokens": prompt}, cfg, 4,
                                  attn_impl="torch", feed=kern["tokens"])
    for a, b in zip([kern["prefill_logits"]] + kern["logits"],
                    [plain["prefill_logits"]] + plain["logits"]):
        bound = 3e-2 * max(float(b.float().abs().max()), 1.0)
        assert float((a.float() - b.float()).abs().max()) < bound


# flash launches of one prefill of a reduced config: one per attention
# layer; the hybrid's shared block once per group; MLA never (its q and v
# head dims differ, as in the reference); xLSTM has no attention
FAMILY_FLASH = {"codeqwen1.5-7b": 2, "qwen2-72b": 2, "dbrx-132b": 2,
                "deepseek-v3-671b": 0, "zamba2-7b": 1, "xlstm-1.3b": 0,
                "llava-next-34b": 2, "musicgen-medium": 2}


@pytest.mark.parametrize("arch", sorted(FAMILY_FLASH))
def test_lm_families_kernel_route_match_plain(cuda, arch):
    """Each family's reduced config on the card in bf16: the flash launches
    of FAMILY_FLASH in the prefill, none in decode, and both routes'
    logits within the bf16 tolerance scaled by the largest |logit|."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator(cuda).manual_seed(1)
    params = tf.init_model(gen, cfg, dtype=torch.bfloat16)
    batch = lm_steps.make_batch(cfg, 2, 200, gen)
    with torch.inference_mode():
        ops.reset_launch_counts()
        kern = lm_steps.generate(params, batch, cfg, 3, attn_impl="kernel")
        assert ops.launch_counts()["flash_attention"] == FAMILY_FLASH[arch]
        plain = lm_steps.generate(params, batch, cfg, 3, attn_impl="torch",
                                  feed=kern["tokens"])
    for a, b in zip([kern["prefill_logits"]] + kern["logits"],
                    [plain["prefill_logits"]] + plain["logits"]):
        assert bool(torch.isfinite(a).all())
        bound = 3e-2 * max(float(b.float().abs().max()), 1.0)
        assert float((a.float() - b.float()).abs().max()) < bound


# ------------------------------------- the client axis (federated training)
def _client_args(g, dev, dt, M, T, B, I, H, gates):
    r = lambda *s: _rand(g, dev, dt, *s)  # noqa: E731
    return (r(M, T, B, I), r(M, B, H), r(M, B, H), r(M, I, gates * H),
            r(M, H, gates * H), r(M, gates * H))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("M,B,I,H", [
    (1, 64, 1, 64), (3, 64, 1, 64), (100, 64, 1, 64),   # the training shape
    (100, 64, 64, 64),                                  # GRU's second layer
    (3, 61, 1, 64),                                     # a prime B
    (3, 64, 4, 128), (3, 32, 16, 256),                  # the cluster shapes
])
def test_client_axis_layers_match_plain(cuda, M, B, I, H, dt):
    """Each layer kernel with M clients, each with its own weights, against
    the plain layer with the client axis (T = 8): every step's h and the
    LSTM's last c; one launch for all M clients."""
    g = torch.Generator().manual_seed(M * 7 + B + I + H)
    x, h, c, wx, wh, b = _client_args(g, cuda, dt, M, 8, B, I, H, 4)
    ops.reset_launch_counts()
    got = ops.lstm_layer(x, h, c, wx, wh, b)
    want = ref.lstm_layer_ref(x, h, c, wx, wh, b)
    fused = ref.lstm_layer_ref(x, h, c, wx, wh, b, fp32_sums=True)
    x, h, _, wx, wh, b = _client_args(g, cuda, dt, M, 8, B, I, H, 3)
    got_g = ops.gru_layer(x, h, wx, wh, b)
    want_g = ref.gru_layer_ref(x, h, wx, wh, b)
    fused_g = ref.gru_layer_ref(x, h, wx, wh, b, fp32_sums=True)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"lstm_cell": 1, "gru_cell": 1,
                                   "flash_attention": 0}
    for a, w, f in ((got[0], want[0], fused[0]), (got[1], want[1], fused[1]),
                    (got_g, want_g, fused_g)):
        assert a.dtype == dt and a.shape == w.shape and a.is_cuda
        torch.testing.assert_close(a.float(), w.float(), rtol=LAYER_TOL[dt],
                                   atol=LAYER_TOL[dt])
        torch.testing.assert_close(a.float(), f.float(), rtol=TOL[dt],
                                   atol=TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_one_client_is_byte_identical_to_the_unbatched_call(cuda, dt):
    """M = 1 with a leading client axis launches the same plan on the same
    bytes as the unbatched call (the serving path): equal bits."""
    g = torch.Generator().manual_seed(21)
    x, h, c, wx, wh, b = _client_args(g, cuda, dt, 1, 8, 256, 1, 64, 4)
    one = ops.lstm_layer(x, h, c, wx, wh, b)
    flat = ops.lstm_layer(x[0], h[0], c[0], wx[0], wh[0], b[0])
    assert torch.equal(one[0][0], flat[0]) and torch.equal(one[1][0], flat[1])
    x, h, _, wx, wh, b = _client_args(g, cuda, dt, 1, 8, 256, 64, 64, 3)
    assert torch.equal(ops.gru_layer(x, h, wx, wh, b)[0],
                       ops.gru_layer(x[0], h[0], wx[0], wh[0], b[0]))


@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_layer_function_gradients_match_plain(cuda, name):
    """The autograd Function at the training shape (M = 100, B = 64, T = 8,
    H = 64, fp32): the kernel's outputs and the gradients of every input
    that needs one, against autograd through the plain layer, within 2e-5
    of each gradient's largest magnitude."""
    g = torch.Generator().manual_seed(5)
    G = 4 if name == "lstm" else 3
    x, h, c, wx, wh, b = _client_args(g, cuda, torch.float32, 100, 8, 64, 1,
                                      64, G)
    h = torch.zeros_like(h)                    # a zero h0 that needs no grad
    args = (x, h, c, wx, wh, b) if G == 4 else (x, h, wx, wh, b)
    fn = ops.lstm_layer if G == 4 else ops.gru_layer
    plain = ref.lstm_layer_ref if G == 4 else ref.gru_layer_ref
    w = torch.randn(100, 8, 64, 64, generator=g).to(cuda)

    def grads(f):
        leaves = [t.clone().requires_grad_(t is not h) for t in args]
        out = f(*leaves)
        out = out[0] if G == 4 else out
        wanted = [t for t in leaves if t.requires_grad]
        return out.detach(), torch.autograd.grad((out * w).sum(), wanted)

    ops.reset_launch_counts()
    out, got = grads(fn)
    assert ops.launch_counts()[f"{name}_cell"] == 1
    want_out, want = grads(plain)
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    assert len(got) == len(args) - 1
    for a, bb in zip(got, want):
        scale = float(bb.abs().max())
        assert float((a - bb).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("cell,n_layers", [("lstm", 1), ("gru", 2)])
def test_local_update_on_card_both_routes(cuda, cell, n_layers):
    """One local update of 3 clients on the card: the kernel route (one
    launch per layer per step) against the plain route on the card and the
    CPU, at the reference's local-update tolerance."""
    cfg = ForecasterConfig(cell=cell, n_layers=n_layers)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(2), cfg)
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.random((3, 200, 8, 1)).astype(np.float32))
    y = torch.from_numpy(r.random((3, 200, 4)).astype(np.float32))
    bidx = torch.from_numpy(r.integers(0, 200, (3, 4, 64)))
    loss = losses.make_loss("ew_mse", 2.0)
    on = lambda t: t.to(cuda)  # noqa: E731
    card_params = {"layers": [{k: on(v) for k, v in p.items()}
                              for p in params["layers"]],
                   "head": {k: on(v) for k, v in params["head"].items()}}
    ops.reset_launch_counts()
    kern, kl = local_update(card_params, on(x), on(y), on(bidx), 0.05, cfg,
                            loss, "kernel", 0.1)
    assert ops.launch_counts()[f"{cell}_cell"] == 4 * n_layers
    plain, pl = local_update(card_params, on(x), on(y), on(bidx), 0.05, cfg,
                             loss, "torch", 0.1)
    cpu, cl = local_update(params, x, y, bidx, 0.05, cfg, loss, "kernel", 0.1)
    for other, ol in ((plain, pl), (cpu, cl)):
        torch.testing.assert_close(kl.cpu(), ol.cpu(), rtol=1e-5, atol=0)
        for a, b in zip(forecaster.params_to_numpy(kern)["layers"] +
                        [forecaster.params_to_numpy(kern)["head"]],
                        forecaster.params_to_numpy(other)["layers"] +
                        [forecaster.params_to_numpy(other)["head"]]):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- privacy pipeline
def test_prng_on_card_matches_the_cpu(cuda):
    """The threefry PRNG on the card: keys, bits, uniform and randint
    bit-equal to the CPU's, batched keys too; normal within 1e-5 of |x|
    (torch's CUDA and CPU erfinv may differ in the last bits)."""
    from repro_torch.core import prng

    key = prng.fold_in(prng.PRNGKey(3), 42)
    batch = prng.split(prng.as_tensor(key), 12).reshape(4, 3, 2)
    assert torch.equal(prng.split(batch.to(cuda), 5).cpu(),
                       prng.split(batch, 5))
    assert torch.equal(prng.fold_in(batch.to(cuda), 7).cpu(),
                       prng.fold_in(batch, 7))
    for shape in ((), (7,), (3, 4, 5), (100_003,)):
        assert torch.equal(prng.bits(key, shape, device=cuda).cpu(),
                           prng.bits(key, shape))
        assert torch.equal(prng.uniform(key, shape, device=cuda).cpu(),
                           prng.uniform(key, shape))
        for lo, hi in ((0, 256), (-5, 1_000_003)):
            assert torch.equal(
                prng.randint(key, shape, lo, hi, device=cuda).cpu(),
                prng.randint(key, shape, lo, hi))
        n, c = prng.normal(key, shape, device=cuda).cpu(), \
            prng.normal(key, shape)
        assert bool(((n - c).abs() <= 1e-5 * c.abs()).all())
    assert torch.equal(prng.randint(batch.to(cuda), (5, 2), 0, 256).cpu(),
                       prng.randint(batch, (5, 2), 0, 256))


def test_ring_masked_round_equals_clear_on_card(cuda):
    """A ring-masked round on the card equals the ring-clear round bit for
    bit (kernel route, clip + noise + 8-bit quantize, one weight-0 pad),
    and its uploads are ring noise."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import fedavg

    cfg = ForecasterConfig(hidden_dim=16)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(5), cfg)
    r = np.random.default_rng(4)
    x = r.random((4, 120, 8, 1)).astype(np.float32)
    y = r.random((4, 120, 4)).astype(np.float32)
    bidx = r.integers(0, 120, (4, 3, 16))
    w = np.asarray([17.0, 0.0, 29.0, 11.0], np.float32)
    kw = dict(dp_clip=1.0, dp_noise=0.5, quantize_bits=8, lr=0.05, seed=3)
    outs = []
    for extra in (dict(quantize_ring=True), dict(secure_agg=True)):
        e = fedavg.RoundEngine(cfg, FLConfig(**kw, **extra), device=cuda)
        p, s = e.init(params=params)
        p, s, l = e.step(p, s, x, y, bidx, w, round_idx=1, stream=2)
        outs.append((p, l, e))
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(tree_leaves(outs[0][0]),
                    tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    e = outs[1][2]
    d = {"w": torch.randn(4, 300, generator=torch.Generator().manual_seed(1)
                          ).to(cuda) * 0.05}
    masked = fedavg.apply_stack(e.stack, d, e.round_keys(1, 4, 2),
                                w_full=(torch.from_numpy(w) > 0).float()
                                .to(cuda), round_key=e.base_round_key(1, 2))
    assert torch.equal(masked["w"], masked["w"].round())
    assert float(masked["w"].abs().max()) > 8.0


def test_int8_publish_on_card_matches_the_cpu(cuda):
    from repro_torch.serving import ModelRegistry

    params = forecaster.init_forecaster(torch.Generator().manual_seed(6),
                                        ForecasterConfig())
    key = (0, 123)
    hs = [ModelRegistry(device=d).publish(params, ForecasterConfig(),
                                          weights="int8", key=key)
          for d in (cuda, "cpu")]
    for a, b in zip(tree_leaves(hs[0].params),
                    tree_leaves(hs[1].params)):
        assert a.is_cuda and torch.equal(a.cpu(), b)


def _small_fl(**kw):
    from repro_torch.configs.base import FLConfig
    from repro_torch.data import synthetic

    series = synthetic.generate_buildings("CA", list(range(6)), days=20)
    base = dict(n_clients=6, clients_per_round=4, rounds=6, n_clusters=0,
                batch_size=16, lr=0.05, loss="ew_mse", seed=0,
                mode="semi_sync", over_select=1.5, staleness_alpha=0.5,
                stragglers="lognormal", straggler_jitter=1.0)
    return series, FLConfig(**dict(base, **kw))


def _same_result(a, b):
    for k in ("loss_history", "sim_times", "eps_history"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_array_equal(x, y)


def test_semi_sync_churn_on_card_rekeys_and_resumes(cuda, tmp_path):
    """Semi-sync under dropout with the 8-bit ring and secure aggregation
    on the card: the event schedule equals the CPU run's, the masked run
    equals the ring-clear cohort-atomic run bit for bit, and a run killed
    after 3 rounds resumes from its checkpoint bit for bit."""
    from repro_torch.core import fedavg

    cfg = ForecasterConfig(hidden_dim=16)
    churn = dict(dropout_prob=0.3, timeout_rounds=1, quantize_bits=8,
                 dp_clip=1.0)
    series, masked = _small_fl(**churn, secure_agg=True)
    _, clear = _small_fl(**churn, quantize_ring=True, cohort_atomic=True)
    run = fedavg.run_federated_training
    full = run(series, cfg, masked, device=cuda)[-1]
    _same_result(run(series, cfg, clear, device=cuda)[-1], full)
    np.testing.assert_array_equal(
        run(series, cfg, masked, device="cpu")[-1].sim_times, full.sim_times)
    assert np.isfinite(full.loss_history).any()
    ck = tmp_path / "ck"
    run(series, cfg, masked, device=cuda, checkpoint_path=ck,
        stop_after_rounds=3)
    _same_result(run(series, cfg, masked, device=cuda,
                     checkpoint_path=ck)[-1], full)


@pytest.mark.parametrize("extra", [dict(), dict(
    dp_clip=1.0, dp_noise=0.5, quantize_bits=8, secure_agg=True)])
def test_one_nccl_rank_mesh_round_equals_local(cuda, tmp_path, extra):
    """A round on a mesh of one NCCL rank (flat and hierarchical 1 x 1)
    equals the local round bit for bit."""
    import torch.distributed as dist
    from repro_torch.configs.base import AggregationConfig, FLConfig
    from repro_torch.core import aggregation, fedavg

    cfg = ForecasterConfig(hidden_dim=16)
    params = forecaster.init_forecaster(torch.Generator().manual_seed(5), cfg)
    r = np.random.default_rng(4)
    x = r.random((4, 120, 8, 1)).astype(np.float32)
    y = r.random((4, 120, 4)).astype(np.float32)
    bidx = r.integers(0, 120, (4, 3, 16))
    w = np.asarray([17.0, 0.0, 29.0, 11.0], np.float32)
    kw = dict(extra, lr=0.05, seed=3)

    def one(mesh=None, **more):
        e = fedavg.RoundEngine(cfg, FLConfig(**kw, **more), mesh=mesh,
                               device=cuda)
        p, s = e.init(params=params)
        return e.step(p, s, x, y, bidx, w, round_idx=1, stream=2)

    want_p, _, want_l = one()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        for kind in ("flat", "hierarchical"):
            mesh = aggregation.make_mesh(AggregationConfig(kind=kind))
            p, _, loss = one(mesh, aggregation=kind)
            assert torch.equal(loss, want_l)
            for a, b in zip(tree_leaves(p), tree_leaves(want_p)):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- LM training
def _train_inputs(arch, dev, seed=0):
    cfg = get_config(arch).reduced()
    params = tf.init_model(torch.Generator().manual_seed(seed), cfg,
                           dtype=torch.float32)
    return (cfg, tree_map(lambda t: t.to(dev), params),
            lm_steps.train_batch(cfg, 4, 64, seed, dev))


def _grads_close(a, b, tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.float().cpu(), y.float().cpu()
        assert torch.isfinite(x).all()
        assert (x - y).abs().max() <= tol * y.abs().max()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_train_step_on_card_matches_the_cpu(cuda, arch):
    """Two microbatches in fp32 on the plain attention route: loss rtol
    1e-4, grads within 1e-3 of each leaf's largest |value|."""
    out = {}
    for dev in ("cpu", cuda):
        cfg, params, batch = _train_inputs(arch, dev)
        out[str(dev)] = tf.accumulate_grads(params, batch, cfg,
                                            microbatches=2,
                                            dtype=torch.float32)
    (lc, _, gc), (lg, _, gg) = out["cpu"], out[str(cuda)]
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    _grads_close(gg, gc, 1e-3)


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_attention_under_autograd_raises_on_card(cuda, remat):
    """The flash kernel is forward only: a train step on the kernel route
    fails loudly instead of dropping the attention's gradients."""
    cfg, params, batch = _train_inputs("qwen3-14b", cuda)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        tf.value_and_grad(params, batch, cfg, dtype=torch.float32,
                          remat=remat, attn_impl="kernel")
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_remat_gives_the_same_loss_and_grads_on_card(cuda, arch):
    cfg, params, batch = _train_inputs(arch, cuda)
    l1, _, g1 = tf.value_and_grad(params, batch, cfg, dtype=torch.float32,
                                  remat=True)
    l0, _, g0 = tf.value_and_grad(params, batch, cfg, dtype=torch.float32,
                                  remat=False)
    assert abs(float(l1) - float(l0)) <= TOL[torch.float32] * abs(float(l0))
    _grads_close(g1, g0, TOL[torch.float32])


@pytest.mark.parametrize("name", ["adam", "adafactor", "sgd"])
def test_in_place_optimizer_update_equals_the_functional_one_on_card(
        cuda, name):
    opt = {"adam": optim.adam(), "adafactor": optim.adafactor(),
           "sgd": optim.sgd(momentum=0.9, nesterov=True)}[name]
    g = torch.Generator().manual_seed(5)

    def tree():
        return {"e": torch.randn(64, 32, generator=g),
                "s": {"w": torch.randn(3, 16, 8, generator=g),
                      "n": torch.randn(16, generator=g)}}
    p_fun = tree_map(lambda t: t.to(cuda, torch.bfloat16), tree())
    p_in = tree_map(torch.clone, p_fun)
    s_fun, s_in = opt.init(p_fun), opt.init(p_in)
    for _ in range(3):
        grads = tree_map(lambda t: t.to(cuda, torch.bfloat16), tree())
        u, s_fun = opt.update(grads, s_fun, p_fun, 1e-2)
        p_fun = tree_map(lambda p, d: p + d.to(p.dtype), p_fun, u)
        s_in = optim.update_in_place(opt, grads, s_in, p_in, 1e-2)
    for a, b in zip(tree_leaves(p_in), tree_leaves(p_fun)):
        assert torch.equal(a, b)
