"""Loss functions and metrics (paper §3.3, §4.5): the counterpart of
``src/repro/core/losses.py``.

EW-MSE(y, ŷ) = (1/N) Σ_i β^{i-1} (y_i − ŷ_i)²   with β ≥ 1; β=1 ⇒ MSE.

For the LLM side-workloads the same idea transfers as a position-weighted
cross-entropy, ``weighted_ce``: position i of S is weighted β^{i/(S-1)},
normalized to mean 1 so β=1 is plain CE; ``chunked_weighted_ce`` computes
it from hidden states 512 positions at a time.

The losses reduce over every axis by default, as the JAX package's do;
``dim`` reduces over the given axes only, which the client-batched local
update uses to get one loss per client from ``(M, B, horizon)`` forecasts.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import constrain
from repro_torch.sharding.rules import local_region


def horizon_weights(horizon: int, beta: float, dtype=torch.float32,
                    device=None):
    """β^{i-1} for i = 1..N (paper's EW-MSE weights, unnormalized).  Made on
    ``device`` from the Python scalar: no copy from the host, which would
    hold the host until the card had drained its queue (once a step)."""
    return beta ** torch.arange(horizon, dtype=dtype, device=device)


def _mean(v, dim):
    return v.mean() if dim is None else v.mean(dim=dim)


def mse(pred, target, dim=None):
    """Standard MSE over all elements (or over ``dim``).
    pred/target: (..., horizon)."""
    d = (pred - target).float()
    return _mean(d * d, dim)


def ew_mse(pred, target, beta: float = 2.0, dim=None):
    """Exponentially weighted MSE (paper eq. §3.3.2).

    Weights the squared error at horizon step i by β^{i-1} and averages with
    1/N exactly as the paper writes it (NOT normalized by Σβ^{i-1}).
    """
    w = horizon_weights(pred.shape[-1], beta, device=pred.device)
    d = (pred - target).float()
    return _mean(d * d * w, dim)


@functools.lru_cache(maxsize=None)
def make_loss(name: str, beta: float = 2.0):
    """Loss factory, cached on (name, beta) so repeated callers share one
    callable.  The callable takes ``(pred, target, dim=None)``."""
    if name == "mse":
        return mse
    if name == "ew_mse":
        return functools.partial(ew_mse, beta=beta)
    raise ValueError(f"unknown loss {name!r}")


# ------------------------------------------------------------- LM analogue
def _position_weights(S: int, beta: float, device):
    """β^{i/(S-1)} for i in [0, S) (ones for S = 1), fp32, unnormalized."""
    if S > 1:
        return beta ** (torch.arange(S, dtype=torch.float32, device=device)
                        / (S - 1))
    return torch.ones((S,), dtype=torch.float32, device=device)


def weighted_ce(logits, labels, beta: float = 1.0, mask=None):
    """Position-weighted cross entropy: the EW-MSE analogue for LM training.

    logits: (B, S, V); labels: (B, S) integer ids.  Position i in [0, S)
    gets weight β^{i/(S-1)} (so the last position is weighted β× the
    first); weights are normalized to mean 1 so the loss scale matches
    plain CE and β=1 is exact CE.  ``mask`` (B, S) drops positions.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = _position_weights(logits.shape[1], beta, logits.device)
    w = w / torch.mean(w)
    wl = -ll * w[None, :]
    if mask is not None:
        m = mask.float()
        return torch.sum(wl * m) / torch.clamp(torch.sum(m * w[None, :]),
                                               min=1.0)
    return torch.mean(wl) / torch.mean(w)


class _HeadLogits(torch.autograd.Function):
    """(B, c, d) @ (d, V) with 16-bit operands and fp32 logits, as
    ``jnp.einsum(..., preferred_element_type=jnp.float32)`` gives them.
    On the card one ``torch.mm(..., out_dtype=torch.float32)`` (fp32
    accumulation, no 16-bit rounding of the logits), on the CPU the same
    products of the upcast operands.  The backward rounds the fp32
    cotangent to the operands' dtype and runs two 16-bit products."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        if h2.is_cuda:
            out = torch.mm(h2, w, out_dtype=torch.float32)
        else:
            out = torch.mm(h2.float(), w.float())
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(h.dtype)
        dh = torch.mm(g2, w.T).reshape(h.shape)
        dw = torch.mm(h.reshape(-1, h.shape[-1]).T, g2)
        return dh, dw


def head_logits(h, w_head):
    """fp32 logits of hidden states h (B, c, d) under the head (d, V), the
    head cast to h's dtype first.  On a mesh each rank computes its rows'
    logits for its block of the vocabulary (DTensor has no rule for the
    fp32-output product)."""
    w = w_head.to(h.dtype)
    if h.dtype == torch.float32:
        return torch.matmul(h, w)
    return local_region(_HeadLogits.apply, (h, w),
                        (("batch", None, None), (None, "act_vocab")),
                        ("batch", None, "act_vocab"))


def _ce_chunk(h, w_head, labels, mw):
    """One chunk's weighted negative log-likelihood sum and weight sum."""
    logits = constrain(head_logits(h, w_head), "batch", None, "act_vocab")
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.sum(-ll * mw), torch.sum(mw)


def chunked_weighted_ce(h, w_head, labels, beta: float = 1.0, mask=None,
                        chunk: int = 512):
    """``weighted_ce`` computed from hidden states, chunked over the
    sequence.

    h: (B, S, d); w_head: (d, V).  Each chunk's fp32 logits and
    log-softmax are (B, chunk, V) transients; with grad enabled each chunk
    runs under ``torch.utils.checkpoint`` (``jax.checkpoint`` in the
    reference), so the backward recomputes them chunk by chunk and peak
    memory never holds full-sequence fp32 logits (151,936 x 4,096 x 4 B is
    2.5 GB a sequence).  Numerically ``weighted_ce(h @ w_head, ...)``.
    """
    B, S, _ = h.shape
    if S % chunk:
        chunk = S
    w_pos = _position_weights(S, beta, h.device)
    m = (torch.ones((B, S), dtype=torch.float32, device=h.device)
         if mask is None else mask.float())
    mw = m * w_pos[None, :]
    nums, dens = [], []
    for i in range(0, S, chunk):
        args = (h[:, i:i + chunk], w_head, labels[:, i:i + chunk],
                mw[:, i:i + chunk])
        num, den = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _ce_chunk(*args))
        nums.append(num)
        dens.append(den)
    return (torch.sum(torch.stack(nums))
            / torch.clamp(torch.sum(torch.stack(dens)), min=1.0))


# ------------------------------------------------------------- metrics (§4.5)
# ONE epsilon for every MAPE-family metric, torch and numpy paths alike
# (core.fedavg's MetricAccumulator imports it): near-zero actuals only occur
# in normalized [0, 1] space, where 1e-2 caps any single window's APE
# contribution at 100× its absolute error; kWh-space actuals are ≥ 0.16 so
# the guard never binds there.
MAPE_EPS = 1e-2


def rmse(pred, target):
    d = (pred - target).float()
    return torch.sqrt(torch.mean(d * d))


def _ape(pred, target, eps):
    return torch.abs((target - pred) / torch.clamp(torch.abs(target),
                                                   min=eps)).float()


def mape(pred, target, eps: float = MAPE_EPS):
    """Mean absolute percentage error, in % (§4.5.2).

    Guards against division blow-up at near-zero actuals with ``eps`` in the
    denominator (the OpenEIA kWh minimum is 0.16 so this is benign there).
    """
    return 100.0 * torch.mean(_ape(pred, target, eps))


def accuracy(pred, target, eps: float = MAPE_EPS):
    """Accuracy = 100 − MAPE (§4.5.3), clipped to [0, 100]."""
    return torch.clamp(100.0 - mape(pred, target, eps), 0.0, 100.0)


def per_horizon_accuracy(pred, target, eps: float = MAPE_EPS):
    """Accuracy at each forecast step (paper Table 4 layout). (..., H) -> (H,)."""
    a = _ape(pred, target, eps).reshape(-1, pred.shape[-1])
    return torch.clamp(100.0 - 100.0 * torch.mean(a, dim=0), 0.0, 100.0)
