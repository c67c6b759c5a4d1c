"""The port's SARIMA baseline against ``repro.core.sarima``: a copy, so
every fit, forecast and rolling forecast is bit-equal on the same series."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import sarima as jsarima
from repro.data import synthetic as jsynthetic
from repro_torch.core import sarima as tsarima
from repro_torch.data import synthetic as tsynthetic

ORDERS = [((2, 0, 1), (1, 1, 0, 96)), ((1, 0, 0), (0, 1, 0, 96)),
          ((2, 0, 1), (1, 1, 1, 96)), ((1, 1, 1), (0, 0, 0, 96))]


def _series(days=33, ids=(2,)):
    a = jsynthetic.generate_buildings("CA", list(ids), days=days)
    b = tsynthetic.generate_buildings("CA", list(ids), days=days)
    assert np.array_equal(a, b)
    return a


def _same_model(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.order, a.seasonal) == (b.order, b.seasonal)
    for f in ("ar", "ma", "sar", "sma"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.intercept, a.sigma2, a.aic) == (b.intercept, b.sigma2, b.aic)


@pytest.mark.parametrize("order,seasonal", ORDERS)
def test_fit_and_forecast_bit_equal(order, seasonal):
    y = _series()[0][:96 * 30]
    ja = jsarima.fit(y, order, seasonal)
    ta = tsarima.fit(y, order, seasonal)
    _same_model(ja, ta)
    assert np.array_equal(jsarima.forecast(ja, y, 8),
                          tsarima.forecast(ta, y, 8))


def test_too_short_series_gives_none_in_both():
    y = _series(days=1)[0][:40]
    assert jsarima.fit(y) is None and tsarima.fit(y) is None


def test_rolling_forecast_bit_equal():
    s = _series(ids=(2,))[0]
    jp, ja = jsarima.rolling_forecast(s, lookahead=4, fit_days=30,
                                      horizon_days=1)
    tp, ta = tsarima.rolling_forecast(s, lookahead=4, fit_days=30,
                                      horizon_days=1)
    assert tp.shape == jp.shape and tp.shape[1] == 4
    assert np.array_equal(jp, tp) and np.array_equal(ja, ta)
    assert np.isfinite(tp).all()


@pytest.mark.slow
def test_auto_fit_bit_equal():
    t = np.arange(96 * 40, dtype=np.float64)
    series = (10 + 5 * np.sin(2 * np.pi * t / 96)
              + np.random.default_rng(0).normal(0, 0.3, len(t)))
    _same_model(jsarima.auto_fit(series[:96 * 30]),
                tsarima.auto_fit(series[:96 * 30]))
