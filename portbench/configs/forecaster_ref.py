"""Plain fp32 PyTorch reference of the paper's forecasters (§3.2, §3.3.2,
Alg. 1) for the configurations beside this file: an LSTM or GRU layer
stack scanned over the look-back, a linear head, the exponentially
weighted MSE, client SGD, FedAvg, and the serving path's min-max
normalisation around the forward.

Written from the published equations in the layouts the benchmark hands
both sides (gates ``[i|f|g|o]`` for the LSTM; ``[z|r|h~]`` for the GRU,
one bias, the reset gate applied to the hidden product, no hidden bias, as
the paper's reference code has it).  No kernels, no caches, no batching
tricks beyond a leading client axis; every product is a plain matmul,
with TF32 off unless a caller asks for it (the lower-precision control).
Imports neither the program nor JAX.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products (``tf32=False``) or TF32 ones, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _bias(b):
    return b.unsqueeze(-2) if b.dim() == 2 else b


def forward(params, x, cfg: dict):
    """x: (B, L, I), or (M, B, L, I) with a leading client axis on every
    leaf -> (B, horizon) or (M, B, horizon)."""
    H = cfg["hidden_dim"]
    seq = x
    for p in params["layers"]:
        wx, wh, b = p["wx"], p["wh"], _bias(p["b"])
        h = x.new_zeros(seq.shape[:-2] + (H,))
        c = torch.zeros_like(h)
        hs = []
        for t in range(seq.shape[-2]):
            xt = seq[..., t, :]
            if cfg["cell"] == "lstm":
                z = xt @ wx + h @ wh + b
                i, f, g, o = z.split(H, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                zx, zh = xt @ wx + b, h @ wh
                zg = torch.sigmoid(zx[..., :H] + zh[..., :H])
                r = torch.sigmoid(zx[..., H:2 * H] + zh[..., H:2 * H])
                cand = torch.tanh(zx[..., 2 * H:] + r * zh[..., 2 * H:])
                h = zg * h + (1.0 - zg) * cand
            hs.append(h)
        seq = torch.stack(hs, dim=-2)
    return h @ params["head"]["w"] + _bias(params["head"]["b"])


def ew_mse(pred, y, beta: float):
    """Per-client EW-MSE: the mean over rows and horizon of beta^(i-1)
    times the squared error (unnormalised weights, as the paper writes
    it).  pred, y: (M, B, horizon) -> (M,)."""
    w = beta ** torch.arange(pred.shape[-1], dtype=pred.dtype,
                             device=pred.device)
    return ((pred - y) ** 2 * w).mean(dim=(-2, -1))


def _stack(tree, M):
    return {"layers": [{k: v.expand((M,) + v.shape).clone()
                        for k, v in p.items()} for p in tree["layers"]],
            "head": {k: v.expand((M,) + v.shape).clone()
                     for k, v in tree["head"].items()}}


def _leaves(tree):
    return [p[k] for p in tree["layers"] for k in ("wx", "wh", "b")] + \
        [tree["head"]["w"], tree["head"]["b"]]


def _rebuild(like, flat):
    it = iter(flat)
    return {"layers": [{k: next(it) for k in ("wx", "wh", "b")}
                       for _ in like["layers"]],
            "head": {k: next(it) for k in ("w", "b")}}


def fl_round(params, norm, sel, bidx, cfg: dict, lr: float, beta: float,
             half_batch: bool = False):
    """One synchronous FedAvg round of every selected client.

    params: the global tree; norm: (N, T) min-max normalised series on the
    device; sel: (M,) selected clients; bidx: (M, steps, B) train-window
    starts.  Each client runs ``steps`` SGD steps on its own copy, its
    minibatch the windows ``norm[c, i : i + L]`` -> ``norm[c, i + L : i + L
    + horizon]``; the new global model is the mean of the local models and
    the round's loss the mean over clients of each client's mean step
    loss.  ``half_batch`` keeps only the first half of every minibatch (a
    planted fault).  Returns (new global tree, loss)."""
    dev = norm.device
    L, Hz = cfg["lookback"], cfg["horizon"]
    sel = torch.as_tensor(sel, device=dev)
    bidx = torch.as_tensor(bidx, device=dev)
    M = sel.shape[0]
    rows = norm[sel]
    ox = torch.arange(L, device=dev)
    oy = torch.arange(L, L + Hz, device=dev)
    local = _stack(params, M)
    losses = []
    for s in range(bidx.shape[1]):
        idx = bidx[:, s]
        if half_batch:
            idx = idx[:, :idx.shape[1] // 2]
        B = idx.shape[1]
        x = torch.gather(rows, 1, (idx[..., None] + ox).reshape(M, -1))
        y = torch.gather(rows, 1, (idx[..., None] + oy).reshape(M, -1))
        x = x.reshape(M, B, L, 1)
        y = y.reshape(M, B, Hz)
        flat = [t.detach().requires_grad_() for t in _leaves(local)]
        with torch.enable_grad():
            per_client = ew_mse(forward(_rebuild(local, flat), x, cfg), y,
                                beta)
            grads = torch.autograd.grad(per_client.sum(), flat)
        local = _rebuild(local, [w.detach() - lr * g
                                 for w, g in zip(flat, grads)])
        losses.append(per_client.detach())
    new = {"layers": [{k: v.mean(0) for k, v in p.items()}
                      for p in local["layers"]],
           "head": {k: v.mean(0) for k, v in local["head"].items()}}
    return new, float(torch.stack(losses).mean(0).mean())


def serve(params_by_slot, windows, lo, hi, slot, cfg: dict,
          block: int = 1 << 18):
    """kWh forecasts of raw watt-hour windows (N, L): each row normalised
    by its consumer's (lo, hi), forecast by its slot's model, and
    de-normalised.  lo, hi: (N,); slot: (N,) indices into
    ``params_by_slot``.  Returns (N, horizon) on the windows' device."""
    out = torch.empty((windows.shape[0], cfg["horizon"]),
                      dtype=torch.float32, device=windows.device)
    for s, p in enumerate(params_by_slot):
        rows = torch.nonzero(slot == s).flatten()
        for i in range(0, rows.shape[0], block):
            r = rows[i:i + block]
            l, h = lo[r, None], hi[r, None]
            scale = torch.clamp_min(h - l, 1e-9)
            xn = (windows[r] - l) / scale
            out[r] = forward(p, xn[..., None], cfg) * scale + l
    return out
