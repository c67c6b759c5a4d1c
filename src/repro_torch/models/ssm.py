"""Mamba2 (SSD, state-space duality) block in the chunked-scan form; the
counterpart of ``src/repro/models/ssm.py``.

Prefill runs the chunkwise algorithm (Dao & Gu 2024): within a chunk of Q
tokens the output is a masked quadratic form; across chunks a loop carries
the (nh, hd, ds) state.  Decode is the plain one-step recurrence against a
conv ring buffer and the SSM state.

Layout: x (B, S, d) -> in_proj -> [z | xBC | dt]; a depthwise causal conv
over xBC; nh = d_inner / head_dim heads, each with the scalar decay
a_t = exp(-exp(a_log) · dt_t) (Mamba2's scalar-identity A); a gated RMS
norm before out_proj.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return s, d_in, nh


def init_ssm(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Dict:
    s, d_in, nh = _dims(cfg)
    d = cfg.d_model
    dev = generator.device
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(generator, d, 2 * d_in
                              + 2 * s.n_groups * s.state_dim + nh,
                              dtype=dtype),
        "conv_w": (torch.randn((s.conv_width, conv_dim), generator=generator,
                               **f32) * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.zeros((nh,), **f32),
        "dt_bias": torch.full((nh,), -2.0, **f32),       # softplus^-1(~0.12)
        "d_skip": torch.ones((nh,), **f32),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, d_in, d, scale=d_in ** -0.5,
                               dtype=dtype),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    s, d_in, nh = _dims(cfg)
    gdim = s.n_groups * s.state_dim
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * gdim]
    dt = zxbcdt[..., 2 * d_in + 2 * gdim:]
    return z, xBC, dt


def _conv(xBC, w, b):
    """Depthwise causal conv over the sequence.  xBC: (B,S,Cd); w: (K,Cd)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _conv_step(x_t, conv_state, w, b):
    """x_t: (B,Cd); conv_state: (B,K-1,Cd), most recent last."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B,K,Cd)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return F.silu(out), window[:, 1:]


def _heads(xBC, dt, params, cfg: ModelConfig):
    s, d_in, nh = _dims(cfg)
    gdim = s.n_groups * s.state_dim
    x = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + gdim]
    Cm = xBC[..., d_in + gdim:]
    shp = x.shape[:-1]
    x = x.reshape(*shp, nh, s.head_dim)
    Bm = Bm.reshape(*shp, s.n_groups, s.state_dim)
    Cm = Cm.reshape(*shp, s.n_groups, s.state_dim)
    # each group over its nh / n_groups consecutive heads (jnp.repeat)
    rep = nh // s.n_groups
    Bm = torch.repeat_interleave(Bm, rep, dim=-2)
    Cm = torch.repeat_interleave(Cm, rep, dim=-2)
    dt = F.softplus(dt.float() + params["dt_bias"])         # (...,nh)
    a = -torch.exp(params["a_log"])                         # (nh,) < 0
    decay = torch.exp(a * dt)                               # (...,nh) in (0,1)
    return x, Bm, Cm, dt, decay


def ssm_forward(params, x, cfg: ModelConfig, *, state=None
                ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence chunked SSD.  x: (B, S, d) -> (B, S, d).

    Returns (out, final_state), state = {"ssm": (B,nh,hd,ds) fp32,
    "conv": (B,K-1,Cd)}.
    """
    s, d_in, nh = _dims(cfg)
    B, S, _ = x.shape
    Q = min(s.chunk_size, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    zxbcdt = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = _conv(xBC_raw, params["conv_w"].to(x.dtype),
                params["conv_b"].to(x.dtype))
    xh, Bm, Cm, dt, decay = _heads(xBC, dt_raw, params, cfg)
    if pad:
        # pad to a chunk multiple with IDENTITY steps: decay 1, no input
        def pz(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xh, Bm, Cm, dt = map(pz, (xh, Bm, Cm, dt))
        decay = F.pad(decay, (0, 0, 0, pad), value=1.0)

    # chunks of (B, Q, ...); the quadratic intra-chunk term is one
    # (B, Q, Q, nh) block at a time
    def ch(t):
        return t.reshape(B, nc, Q, *t.shape[2:])
    xh_c, Bm_c, Cm_c, dt_c, decay_c = map(ch, (xh, Bm, Cm, dt, decay))
    xdt_c = xh_c * dt_c[..., None].to(xh_c.dtype)          # fold dt into x

    st = (torch.zeros((B, nh, s.head_dim, s.state_dim), dtype=torch.float32,
                      device=x.device) if state is None else state["ssm"])
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        xdt, Bc, Cc, dec = (xdt_c[:, c], Bm_c[:, c], Cm_c[:, c],
                            decay_c[:, c])
        logdec = torch.log(torch.clamp(dec, min=1e-20))     # (B,Q,nh) fp32
        cum = torch.cumsum(logdec, dim=1)                   # inclusive
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B,Qi,Qj,nh)
        L = torch.where(causal, torch.exp(seg), 0.0)
        cb = torch.einsum("bqhn,bkhn->bqkh", Cc, Bc)        # (B,Qi,Qj,nh)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", cb * L.to(cb.dtype), xdt)
        # inter-chunk: C_t . decay from the chunk's start . st
        dfs = torch.exp(cum)                                # (B,Q,nh)
        y_inter = torch.einsum("bqhn,bhpn->bqhp",
                               Cc * dfs[..., None].to(Cc.dtype),
                               st.to(Cc.dtype))
        # st' = decay over the chunk . st + sum_j decay to its end . B_j x_j
        dte = torch.exp(cum[:, -1:, :] - cum)               # (B,Q,nh)
        contrib = torch.einsum("bqhn,bqhp->bhpn",
                               (Bc * dte[..., None].to(Bc.dtype)).float(),
                               xdt.float())
        st = st * torch.exp(cum[:, -1, :])[..., None, None] + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S + pad, nh, s.head_dim)[:, :S]
    y = y + xh[:, :S] * params["d_skip"][:, None].to(y.dtype)
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))

    new_conv = xBC_raw[:, S - (s.conv_width - 1):]
    return out, {"ssm": st, "conv": new_conv}


def ssm_decode(params, x, state, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence.  x: (B, 1, d); state from ``init_ssm_state``.
    Returns (out (B, 1, d), new state)."""
    s, d_in, nh = _dims(cfg)
    B = x.shape[0]
    zxbcdt = torch.matmul(x[:, 0], params["in_proj"].to(x.dtype))
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, cfg)
    xBC, new_conv = _conv_step(xBC_raw, state["conv"],
                               params["conv_w"].to(x.dtype),
                               params["conv_b"].to(x.dtype))
    xh, Bm, Cm, dt, decay = _heads(xBC, dt_raw, params, cfg)  # (B,nh,hd)...

    contrib = torch.einsum("bhn,bhp->bhpn", Bm.float(),
                           (xh * dt[..., None].to(xh.dtype)).float())
    st = state["ssm"] * decay[..., None, None] + contrib    # (B,nh,hd,ds)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), st)
    y = y.to(x.dtype) + xh * params["d_skip"][:, None].to(x.dtype)
    y = y.reshape(B, d_in)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out[:, None], {"ssm": st, "conv": new_conv}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }
