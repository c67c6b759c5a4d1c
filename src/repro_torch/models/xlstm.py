"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a true recurrence), the 7:1 mix of
xlstm-1.3b; the counterpart of ``src/repro/models/xlstm.py``.

mLSTM cell:   C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
              h_t = o_t * (q_t^T C_t) / max(|q_t . n_t|, 1)
with f = sigmoid(f~) and i = exp(i~).  Prefill runs the chunkwise form with
i~ clamped at ``ICLAMP``; decode runs the plain recurrence with an
unclamped ``exp``.  Both are the JAX package's, as they are.

sLSTM cell (per head, block-diagonal recurrence):
  m_t = max(f~ + m_{t-1}, i~);  c_t = e^{f~+m_{t-1}-m_t} c + e^{i~-m_t} tanh(z~)
  n_t likewise;  h_t = sigmoid(o~) * c_t / max(n_t, 1)

This is the recurrent cell family of the paper's forecaster, but the sLSTM
here is plain torch, as the JAX package's is plain JAX: neither calls the
fused LSTM cell kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.scan import loop
from repro_torch.sharding import constrain
from repro_torch.sharding.rules import (local_region, matmul, reshape,
                                        split_last)

ICLAMP = 8.0       # clamp on the exponential input gate's pre-activation


def _mdims(cfg: ModelConfig):
    x = cfg.xlstm
    d_m = int(x.mlstm_proj_factor * cfg.d_model)
    nh = max(1, d_m // x.mlstm_head_dim)
    hd = d_m // nh
    return x, d_m, nh, hd


def _log_sigmoid(x):
    """log sigmoid(x) as the JAX package writes it, -softplus(-x)."""
    return -F.softplus(-x)


# ===================================================================== mLSTM
def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    x, d_m, nh, hd = _mdims(cfg)
    d = cfg.d_model
    dev = generator.device
    return {
        "up_proj": dense_init(generator, d, 2 * d_m, dtype=dtype),
        "wq": dense_init(generator, d_m, d_m, dtype=dtype),
        "wk": dense_init(generator, d_m, d_m, dtype=dtype),
        "wv": dense_init(generator, d_m, d_m, dtype=dtype),
        "w_gates": dense_init(generator, d_m, 2 * nh, dtype=torch.float32),
        "b_gates": torch.cat([torch.zeros((nh,), device=dev),       # i~
                              torch.full((nh,), 3.0, device=dev)]),  # f~
        "ogate": dense_init(generator, d_m, d_m, dtype=dtype),
        "norm_w": torch.ones((d_m,), dtype=dtype, device=dev),
        "down_proj": dense_init(generator, d_m, d, scale=d_m ** -0.5,
                                dtype=dtype),
    }


def _mlstm_qkvg(params, a, cfg):
    x, d_m, nh, hd = _mdims(cfg)
    shp = a.shape[:-1]
    heads = (0, len(shp))             # batch and heads stay split on a mesh
    q = split_last(matmul(a, params["wq"].to(a.dtype)), *shp, nh, hd,
                   keep=heads)
    k = split_last(matmul(a, params["wk"].to(a.dtype)), *shp, nh, hd,
                   keep=heads) * hd ** -0.5
    v = split_last(matmul(a, params["wv"].to(a.dtype)), *shp, nh, hd,
                   keep=heads)
    gates = matmul(a.float(), params["w_gates"]) + params["b_gates"]
    i_raw = torch.clamp(gates[..., :nh], max=ICLAMP)
    logf = _log_sigmoid(gates[..., nh:])                 # log sigmoid(f~)
    o = torch.sigmoid(matmul(a, params["ogate"].to(a.dtype)))
    return q, k, v, i_raw, logf, o


def mlstm_forward(params, xin, cfg: ModelConfig, *, state=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> ((B, S, d), {"C", "n"}).  Chunkwise-parallel."""
    x, d_m, nh, hd = _mdims(cfg)
    B, S, _ = xin.shape
    Q = min(x.chunk_size, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    u = matmul(xin, params["up_proj"].to(xin.dtype))
    a, b = u[..., :d_m], u[..., d_m:]
    q, k, v, i_raw, logf, o = _mlstm_qkvg(params, a, cfg)
    q = constrain(q, "batch", None, "act_heads", None)
    if pad:
        # identity padding: f = 1 (logf = 0), i = exp(-1e9) = 0
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e9)
        logf = F.pad(logf, (0, 0, 0, pad))

    # on a mesh each rank scans its batch rows and heads
    seq = ("batch", None, "act_heads", None)          # (B, S, nh, hd)
    gate = ("batch", None, "act_heads")               # (B, S, nh)
    c_axes = ("batch", "act_heads", None, None)       # (B, nh, hd, hd)
    n_axes = ("batch", "act_heads", None)             # (B, nh, hd)
    h, C, n = local_region(
        lambda *a: _mlstm_scan(*a, Q=Q, nc=nc),
        (q, k, v, i_raw, logf) + ((None, None) if state is None
                                  else (state["C"], state["n"])),
        (seq, seq, seq, gate, gate, c_axes, n_axes), (seq, c_axes, n_axes))
    h = reshape(h, B, S + pad, d_m)[:, :S] * o
    h = rms_norm(h, params["norm_w"], cfg.norm_eps)
    h = h * F.silu(b)
    out = matmul(h, params["down_proj"].to(xin.dtype))
    return out, {"C": C, "n": n}


def _mlstm_scan(q, k, v, i_raw, logf, C, n, *, Q: int, nc: int):
    """The chunkwise mLSTM over padded (B, nc * Q, nh, ...) inputs from
    the state (C, n) (zeros when None).  Returns (h (B, nc * Q, nh, hd),
    C, n).  Batch rows and heads are independent."""
    B, _, nh, hd = q.shape

    def ch(t):
        return t.reshape(B, nc, Q, *t.shape[2:])
    q_c, k_c, v_c, i_c, lf_c = map(ch, (q, k, v, i_raw, logf))

    if C is None:
        C = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((B, nh, hd), dtype=torch.float32, device=q.device)
    iq = torch.arange(Q, device=q.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    hs = []
    for c in range(nc):
        qc, kc, vc, ic, lfc = (q_c[:, c], k_c[:, c], v_c[:, c], i_c[:, c],
                               lf_c[:, c])
        cum = torch.cumsum(lfc, dim=1)                   # (B,Q,nh)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        w = torch.where(causal, torch.exp(seg + ic[:, None, :, :]),
                        0.0)                             # (B,Qi,Qj,nh)
        qk = torch.einsum("bqhe,bjhe->bqjh", qc, kc)
        aw = qk.float() * w
        num_intra = torch.einsum("bqjh,bjhe->bqhe", aw.to(vc.dtype), vc)
        den_intra = aw.sum(dim=2)                        # sum_j w_qj q.k_j
        dfs = torch.exp(cum)                             # decay from start
        qd = qc * dfs[..., None].to(qc.dtype)
        num_inter = torch.einsum("bqhe,bhef->bqhf", qd, C.to(qc.dtype))
        den_inter = torch.einsum("bqhe,bhe->bqh", qd, n.to(qc.dtype))
        num = num_intra + num_inter
        den = den_intra.float() + den_inter
        h = num / torch.clamp(den.abs(), min=1.0)[..., None].to(num.dtype)
        # state update
        dte = torch.exp(cum[:, -1:, :] - cum + ic)       # (B,Q,nh)
        kw = kc * dte[..., None].to(kc.dtype)
        C = (C * torch.exp(cum[:, -1])[..., None, None]
             + torch.einsum("bqhe,bqhf->bhef", kw, vc).float())
        n = n * torch.exp(cum[:, -1])[..., None] + kw.sum(dim=1).float()
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(B, nc * Q, nh, hd), C, n


def mlstm_decode(params, xin, state, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent mLSTM.  xin: (B, 1, d)."""
    x, d_m, nh, hd = _mdims(cfg)
    B = xin.shape[0]
    u = matmul(xin[:, 0], params["up_proj"].to(xin.dtype))
    a, b = u[..., :d_m], u[..., d_m:]
    q, k, v, i_raw, logf, o = _mlstm_qkvg(params, a, cfg)  # (B,nh,hd) ...
    i_w = torch.exp(i_raw)                               # (B,nh)
    f_w = torch.exp(logf)
    ki = (k * i_w[..., None].to(k.dtype)).float()
    C = (state["C"] * f_w[..., None, None]
         + torch.einsum("bhe,bhf->bhef", ki, v.float()))
    n = state["n"] * f_w[..., None] + ki
    num = torch.einsum("bhe,bhef->bhf", q.float(), C)
    den = torch.einsum("bhe,bhe->bh", q.float(), n)
    h = (num / torch.clamp(den.abs(), min=1.0)[..., None]).to(xin.dtype)
    h = h.reshape(B, d_m) * o
    h = rms_norm(h, params["norm_w"], cfg.norm_eps)
    h = h * F.silu(b)
    out = matmul(h, params["down_proj"].to(xin.dtype))
    return out[:, None], {"C": C, "n": n}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    x, d_m, nh, hd = _mdims(cfg)
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, nh, hd), dtype=torch.float32,
                             device=device)}


# ===================================================================== sLSTM
def _sdims(cfg: ModelConfig):
    x = cfg.xlstm
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    d_ff = int(x.slstm_proj_factor * cfg.d_model)
    return x, nh, hd, d_ff


def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Dict:
    x, nh, hd, d_ff = _sdims(cfg)
    d = cfg.d_model
    dev = generator.device
    return {
        "wx": dense_init(generator, d, 4 * d, dtype=dtype),
        # block-diagonal recurrence: per head (hd, 4*hd)
        "r": (torch.randn((nh, hd, 4 * hd), generator=generator,
                          dtype=torch.float32, device=dev)
              * hd ** -0.5).to(dtype),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d,), dtype=dtype, device=dev),
        "up_proj": dense_init(generator, d, 2 * d_ff, dtype=dtype),
        "down_proj": dense_init(generator, d_ff, d, scale=d_ff ** -0.5,
                                dtype=dtype),
    }


def _slstm_step(params, x_t, state, cfg: ModelConfig):
    """x_t: (B, 4d), Wx . x_t computed ahead; state: dict of (B, nh, hd)."""
    x, nh, hd, _ = _sdims(cfg)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhe,hek->bhk", h.to(x_t.dtype),
                       params["r"].to(x_t.dtype))        # (B,nh,4*hd)
    # wx's output is [i~(d) | f~(d) | z~(d) | o~(d)]; regrouped per head to
    # (B, nh, 4*hd), the recurrent block-diagonal layout
    z = x_t.reshape(-1, 4, nh, hd).transpose(1, 2).reshape(-1, nh, 4 * hd)
    bias = params["b"].reshape(4, nh, hd).transpose(0, 1).reshape(nh,
                                                                   4 * hd)
    pre = (z + rec).float() + bias
    i_t = pre[..., :hd]
    f_t = pre[..., hd:2 * hd]
    z_t = torch.tanh(pre[..., 2 * hd:3 * hd])
    o_t = torch.sigmoid(pre[..., 3 * hd:])
    logf = _log_sigmoid(f_t)                             # log sigmoid(f~)
    m_new = torch.maximum(logf + m, i_t)
    i_w = torch.exp(i_t - m_new)
    f_w = torch.exp(logf + m - m_new)
    c = f_w * c + i_w * z_t
    n = f_w * n + i_w
    h_new = o_t * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h_new.to(h.dtype), "m": m_new}


def _slstm_out(params, h, dtype, cfg: ModelConfig):
    """The block's output from the cell's h: norm, GELU up, down."""
    h = rms_norm(h.to(dtype), params["norm_w"], cfg.norm_eps)
    u = matmul(h, params["up_proj"].to(dtype))
    a, g = torch.chunk(u, 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    return matmul(a * F.gelu(g, approximate="tanh"),
                  params["down_proj"].to(dtype))


def slstm_forward(params, xin, cfg: ModelConfig, *, state=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> ((B, S, d), state).  A true recurrent loop over S."""
    xw = matmul(xin, params["wx"].to(xin.dtype))
    h, state = _slstm_run(params, xw, state, cfg)
    return _slstm_out(params, h, xin.dtype, cfg), state


_SLSTM_KEYS = ("c", "n", "h", "m")


def _slstm_run(params, xw, state, cfg: ModelConfig):
    """The recurrence over xw (B, S, 4d) from ``state`` (None: the initial
    state) -> (h (B, S, d), state); on a mesh each rank runs its batch
    rows."""
    row = ("batch", None, None)
    h, *st = local_region(
        lambda xw, r, b, *st: _slstm_scan(xw, r, b, st, cfg),
        (xw, params["r"], params["b"])
        + tuple(None if state is None else state[k] for k in _SLSTM_KEYS),
        (row, (None, None, None), (None,)) + (row,) * 4, (row,) * 5)
    return h, dict(zip(_SLSTM_KEYS, st))


def _slstm_scan(xw, r, b, st, cfg: ModelConfig):
    """The sLSTM recurrence over xw (B, S, 4d) from the state (c, n, h, m)
    (``init_slstm_state`` when None): (h (B, S, d), c, n, h, m).  Batch
    rows are independent.  The steps take xw's rows through one
    ``unbind``, whose backward stacks their gradients once (indexed step
    by step, each would come back as a zero-padded (B, S, 4d) copy)."""
    B, S, _ = xw.shape
    state = (init_slstm_state(cfg, B, device=xw.device) if st[0] is None
             else dict(zip(_SLSTM_KEYS, st)))
    p = {"r": r, "b": b}
    xs = xw.unbind(1)

    def step(t, state):
        state = _slstm_step(p, xs[t], state, cfg)
        return state, state["h"]
    state, hs = loop(S, step, state)
    h = torch.stack(hs, dim=1).reshape(B, S, -1)
    return (h,) + tuple(state[k] for k in _SLSTM_KEYS)


def slstm_decode(params, xin, state, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    xw = matmul(xin, params["wx"].to(xin.dtype))
    h, state = _slstm_run(params, xw, state, cfg)
    return _slstm_out(params, h, xin.dtype, cfg), state


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    x, nh, hd, _ = _sdims(cfg)

    def z():
        return torch.zeros((batch, nh, hd), dtype=torch.float32,
                           device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, nh, hd), -1e9, dtype=torch.float32,
                            device=device)}
