"""The plain reference against the program's plain CPU route at a tiny
size: the forward alone, then whole runs of each cell's driver, whose
every compared number must sit within its limit."""
import pytest
import torch

from benchlib import harness, weights

import _small


def _ref():
    return harness.load_module(harness.BENCH / "configs" / "forecaster_ref.py",
                               "portbench_forecaster_ref")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forward_matches_program(cell):
    from repro_torch.configs.base import ForecasterConfig
    from repro_torch.models import forecaster
    cfg = dict(cell=cell, input_dim=1, hidden_dim=16, n_layers=2,
               lookback=8, horizon=4)
    p = weights.forecaster_params(11, cfg, 3, torch.device("cpu"))
    x = torch.rand(3, 5, 8, 1, generator=torch.Generator().manual_seed(1))
    stacked = {"layers": [{k: torch.stack([t["layers"][l][k] for t in p])
                           for k in ("wx", "wh", "b")} for l in range(2)],
               "head": {k: torch.stack([t["head"][k] for t in p])
                        for k in ("w", "b")}}
    want = forecaster.forecast(stacked, x, ForecasterConfig(
        cell=cell, hidden_dim=16, n_layers=2), cell_impl="torch")
    got = _ref().forward(stacked, x, cfg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    one = _ref().forward(p[1], x[1], cfg)
    torch.testing.assert_close(one, want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("workload", _small.workloads(with_open=True))
def test_tiny_run_is_correct(workload):
    out = _small.run(_small.ctx(workload))
    assert harness.judge(out.checks), out.checks
    assert out.failed == 0 and out.attempted > 0
    limits = _small._files(workload)[3]
    extra = {"unanswered"} if "serve" in workload else set()
    assert {n for n, _, _ in out.checks} == set(limits) | extra
    assert all(v <= 1e-6 for n, v, _ in out.checks if n != "unanswered")
    if workload != _small.OPEN:
        assert set(out.end_to_end) | {"setup_s"} == {
            m["name"] for m in harness.end_to_end_for(harness.bench_json(),
                                                      workload)}
