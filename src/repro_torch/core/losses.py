"""Loss functions and metrics of the forecaster (paper §3.3, §4.5): the
counterpart of the forecaster half of ``src/repro/core/losses.py``.

EW-MSE(y, ŷ) = (1/N) Σ_i β^{i-1} (y_i − ŷ_i)²   with β ≥ 1; β=1 ⇒ MSE.

The losses reduce over every axis by default, as the JAX package's do;
``dim`` reduces over the given axes only, which the client-batched local
update uses to get one loss per client from ``(M, B, horizon)`` forecasts.
"""
from __future__ import annotations

import functools

import torch


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
