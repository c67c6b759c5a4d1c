"""Inputs are fixed by the seed: the same seed gives the same series,
draws and arrivals; another seed other values of the same sizes."""
import numpy as np
import pytest

from benchlib import data

import _small

BIG = 2 ** 33 + 17


@pytest.mark.parametrize("n,days", [(5, 3), (3, 30)])
def test_series_fixed_by_seed(n, days):
    a = data.generate_buildings(data.rng_for(BIG, 1), n, days)
    b = data.generate_buildings(data.rng_for(BIG, 1), n, days)
    c = data.generate_buildings(data.rng_for(BIG + 1, 1), n, days)
    assert a.shape == (n, days * 96) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (a >= 0.01).all() and np.isfinite(a).all()


def test_sub_seed_takes_large_seeds():
    s = {data.sub_seed(BIG, k) for k in range(50)}
    assert len(s) == 50 and all(0 <= v < 2 ** 31 for v in s)
    assert data.sub_seed(BIG, 3) == data.sub_seed(BIG, 3)


def test_round_draws_fixed_by_seed():
    a = data.round_draws(123, 10, 10, 2, 50, 4, 8)
    b = data.round_draws(123, 10, 10, 2, 50, 4, 8)
    for (s1, i1), (s2, i2) in zip(a, b):
        assert np.array_equal(s1, s2) and np.array_equal(i1, i2)
        assert sorted(s1) == list(range(10)) and i1.shape == (10, 4, 8)
        assert i1.max() < 50
    assert not np.array_equal(a[0][1], a[1][1])


def test_open_loop_arrivals_same_work_every_seed():
    from benchlib import harness
    drv = harness.driver("serve_open")

    class Dep:
        ids = list(range(300))
        n_offsets = 89

    got = []
    for seed in (BIG, BIG, BIG + 9):
        ctx = _small.ctx("serve-open.lstm-h64.p80", seed=seed)
        got.append(drv.arrivals(ctx, Dep, 5000.0, 2.0))
    (d1, c1, o1), (d2, c2, o2), (d3, c3, o3) = got
    assert np.array_equal(d1, d2) and np.array_equal(c1, c2)
    assert np.array_equal(o1, o2)
    assert len(d1) == len(d3) == 10_000
    assert d1[-1] == pytest.approx(2.0) and d3[-1] == pytest.approx(2.0)
    assert (np.diff(d1) >= 0).all() and not np.array_equal(c1, c3)


def test_weights_fixed_by_seed():
    import torch
    from benchlib import weights
    cfg = _small.ctx("fl-sync.lstm-h64.m100").config
    a = weights.forecaster_params(BIG, cfg, 2, torch.device("cpu"))
    b = weights.forecaster_params(BIG, cfg, 2, torch.device("cpu"))
    for (n, x), (_, y) in zip(weights.leaves(a[0]), weights.leaves(b[0])):
        assert torch.equal(x, y), n
    assert not torch.equal(a[0]["layers"][0]["wh"], a[1]["layers"][0]["wh"])
    assert a[0]["layers"][0]["wx"].shape == (1, 256)
