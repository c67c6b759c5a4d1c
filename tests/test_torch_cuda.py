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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ForecasterConfig  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.client import local_update  # noqa: E402
from repro_torch.kernels import lstm_cell, ops, ref  # noqa: E402
from repro_torch.launch import lm_steps  # noqa: E402
from repro_torch.models import forecaster  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

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
        kern = lm_steps.generate(params, prompt, cfg, 4, attn_impl="kernel")
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        plain = lm_steps.generate(params, prompt, cfg, 4, attn_impl="torch",
                                  feed=kern["tokens"])
    for a, b in zip([kern["prefill_logits"]] + kern["logits"],
                    [plain["prefill_logits"]] + plain["logits"]):
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
