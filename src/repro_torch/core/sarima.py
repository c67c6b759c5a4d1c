"""Compact seasonal-ARIMA baseline (paper §4.3); a copy of
``src/repro/core/sarima.py``, held bit-exact (pure numpy, as the
reference is).

pmdarima is not available offline, so this is an in-repo SARIMA
(p,d,q)×(P,D,Q)_s fitter using the Hannan–Rissanen two-stage conditional
least-squares method:

  1. apply ordinary (d) and seasonal (D, period s) differencing;
  2. fit a long AR model by OLS to estimate innovations;
  3. regress the differenced series on its own lags (AR, seasonal AR) and on
     the estimated innovations' lags (MA, seasonal MA).

``auto_fit`` mimics auto-ARIMA by searching a small order grid with AIC.  The
paper's protocol is followed by ``rolling_forecast``: fit on 30 days, predict
forward, refit every 30 days.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import STEPS_PER_DAY


@dataclasses.dataclass
class SarimaModel:
    order: Tuple[int, int, int]
    seasonal: Tuple[int, int, int, int]
    ar: np.ndarray
    ma: np.ndarray
    sar: np.ndarray
    sma: np.ndarray
    intercept: float
    sigma2: float
    aic: float


def _difference(y: np.ndarray, d: int, D: int, s: int) -> np.ndarray:
    for _ in range(d):
        y = np.diff(y)
    for _ in range(D):
        y = y[s:] - y[:-s]
    return y


def _lagmat(y: np.ndarray, lags) -> np.ndarray:
    """Columns y[t-l] for each l in lags, rows t = max(lags)..T-1."""
    m = max(lags) if lags else 0
    return np.stack([y[m - l:len(y) - l] for l in lags], axis=1) \
        if lags else np.empty((len(y) - m, 0))


def fit(y: np.ndarray, order=(2, 0, 1), seasonal=(1, 1, 0, STEPS_PER_DAY)
        ) -> Optional[SarimaModel]:
    p, d, q = order
    P, D, Q, s = seasonal
    w = _difference(y.astype(np.float64), d, D, s)
    lag_ar = list(range(1, p + 1))
    lag_sar = [s * j for j in range(1, P + 1)]
    lag_ma = list(range(1, q + 1))
    lag_sma = [s * j for j in range(1, Q + 1)]
    m = max(lag_ar + lag_sar + lag_ma + lag_sma + [1])
    if len(w) < 3 * m + 10:
        return None

    # stage 1: long-AR innovations estimate
    k = min(max(2 * m, 10), len(w) // 4)
    Xl = _lagmat(w, list(range(1, k + 1)))
    yl = w[k:]
    beta, *_ = np.linalg.lstsq(np.c_[np.ones(len(yl)), Xl], yl, rcond=None)
    eps = np.concatenate([np.zeros(k), yl - np.c_[np.ones(len(yl)), Xl] @ beta])

    # stage 2: CSS regression on AR/SAR lags of w and MA/SMA lags of eps
    cols, names = [np.ones(len(w) - m)], ["c"]
    for l in lag_ar + lag_sar:
        cols.append(w[m - l:len(w) - l])
    for l in lag_ma + lag_sma:
        cols.append(eps[m - l:len(w) - l])
    X = np.stack(cols, axis=1)
    yt = w[m:]
    coef, *_ = np.linalg.lstsq(X, yt, rcond=None)
    resid = yt - X @ coef
    sigma2 = float(resid @ resid / max(len(resid), 1))
    n_par = len(coef)
    aic = len(resid) * np.log(max(sigma2, 1e-12)) + 2 * n_par
    i = 1
    ar = coef[i:i + p]; i += p
    sar = coef[i:i + P]; i += P
    ma = coef[i:i + q]; i += q
    sma = coef[i:i + Q]
    return SarimaModel(order, seasonal, ar, ma, sar, sma,
                       float(coef[0]), sigma2, float(aic))


def auto_fit(y: np.ndarray, s: int = STEPS_PER_DAY) -> SarimaModel:
    """Small-grid AIC search (auto-ARIMA stand-in)."""
    best = None
    for (p, q, P, D) in itertools.product((1, 2), (0, 1), (0, 1), (1,)):
        m = fit(y, (p, 0, q), (P, D, 0, s))
        if m is not None and (best is None or m.aic < best.aic):
            best = m
    if best is None:
        raise ValueError("series too short for SARIMA fit")
    return best


def forecast(model: SarimaModel, history: np.ndarray, steps: int) -> np.ndarray:
    """Recursive h-step forecast from the end of ``history`` (original scale)."""
    p, d, q = model.order
    P, D, Q, s = model.seasonal
    y = history.astype(np.float64)
    w_hist = _difference(y, d, D, s)
    # rebuild in-sample innovations for the MA terms
    m = max([1] + list(range(1, p + 1)) + [s * j for j in range(1, P + 1)]
            + list(range(1, q + 1)) + [s * j for j in range(1, Q + 1)])
    eps = np.zeros(len(w_hist))
    for t in range(m, len(w_hist)):
        eps[t] = w_hist[t] - _one_step(model, w_hist, eps, t)
    w_ext, eps_ext = list(w_hist), list(eps)
    for h in range(steps):
        t = len(w_ext)
        w_arr, e_arr = np.asarray(w_ext), np.asarray(eps_ext)
        w_next = _one_step(model, w_arr, e_arr, t)
        w_ext.append(w_next)
        eps_ext.append(0.0)
    w_fc = np.asarray(w_ext[len(w_hist):])
    return _undifference(y, w_fc, d, D, s)


def _one_step(model: SarimaModel, w: np.ndarray, eps: np.ndarray, t: int) -> float:
    p, _, q = model.order
    P, _, Q, s = model.seasonal
    v = model.intercept
    for j, a in enumerate(model.ar, 1):
        if t - j >= 0:
            v += a * w[t - j]
    for j, a in enumerate(model.sar, 1):
        if t - s * j >= 0:
            v += a * w[t - s * j]
    for j, b in enumerate(model.ma, 1):
        if t - j >= 0:
            v += b * eps[t - j]
    for j, b in enumerate(model.sma, 1):
        if t - s * j >= 0:
            v += b * eps[t - s * j]
    return float(v)


def _undifference(y: np.ndarray, w_fc: np.ndarray, d: int, D: int, s: int
                  ) -> np.ndarray:
    """Invert seasonal then ordinary differencing for the forecast path."""
    if d > 1 or D > 1:
        raise NotImplementedError
    # first invert seasonal differencing against the (possibly d-differenced) base
    base = np.diff(y) if d else y
    out = []
    hist = list(base)
    for wv in w_fc:
        val = wv + (hist[len(hist) - s] if D else 0.0)
        out.append(val)
        hist.append(val)
    if d:
        level = y[-1]
        out = list(np.cumsum(out) + level)
    return np.asarray(out)


def rolling_forecast(series: np.ndarray, lookahead: int = 4,
                     fit_days: int = 30, refit_days: int = 30,
                     horizon_days: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §4.3 protocol: fit on 30 days, forecast, refit every 30 days.

    Returns (pred, actual), each (n, lookahead) — one row per forecast origin
    over ``horizon_days`` of evaluation after the initial fit window.
    """
    s = STEPS_PER_DAY
    fit_len = fit_days * s
    preds, actuals = [], []
    model = auto_fit(series[:fit_len])
    t = fit_len
    next_refit = fit_len + refit_days * s
    end = min(len(series) - lookahead, fit_len + horizon_days * s)
    while t < end:
        if t >= next_refit:
            model = auto_fit(series[t - fit_len:t])
            next_refit += refit_days * s
        preds.append(forecast(model, series[max(0, t - fit_len):t], lookahead))
        actuals.append(series[t:t + lookahead])
        t += lookahead
    return np.asarray(preds), np.asarray(actuals)
