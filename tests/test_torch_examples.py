"""The port's examples (``examples/torch_*.py``) run on the CPU at tiny
settings and print the report blocks of their JAX twins.  The numbers of
the quickstart workload are held against JAX by
``tests/test_torch_training.py::test_quickstart_workload_matches_jax``."""
import importlib.util
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
E2E_TINY = ["--device", "cpu", "--clients", "6", "--rounds", "2",
            "--heldout", "3", "--days", "30"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_reports_training_and_an_unseen_forecast(capsys):
    out = _example("torch_quickstart").main(
        ["--device", "cpu", "--buildings", "4", "--days", "20",
         "--rounds", "2"])
    text = capsys.readouterr().out
    for block in ("corpus: 4 buildings", "final train loss:",
                  "next-hour forecast (kWh/15min):",
                  "(building's recent hour was:"):
        assert block in text, block
    assert np.isfinite(out["loss_history"]).all()
    assert out["forecast_kwh"].shape == (4,)
    assert np.isfinite(out["forecast_kwh"]).all()


@pytest.mark.parametrize("extra", [
    [],
    ["--mode", "semi_sync", "--dp-clip", "1", "--dp-noise", "0.5",
     "--quantize", "8", "--secure-agg"],
    ["--hier", "--ragged", "--server-opt", "fedavg_weighted",
     "--sampling", "weighted", "--holdout-frac", "0.2"],
], ids=["default", "semi_sync_private", "hier_ragged_holdout"])
def test_e2e_prints_every_report_block(capsys, extra):
    out = _example("torch_fl_forecasting_e2e").main(E2E_TINY + extra)
    text = capsys.readouterr().out
    blocks = ["== clustered FL (6 clients → 4 clusters",
              "== global FL (no clustering)", "simulated wall-clock",
              "global model  F^A : accuracy", "avg of cluster models:",
              "== unseen-client generalization",
              "CA fresh buildings (in-dist)",
              "FLO fresh buildings (transfer)"]
    if "--dp-clip" in extra:
        blocks += ["cluster 0 ", "global    ", "wall-clock to target loss"]
    if "--holdout-frac" in extra:
        blocks += ["== ragged histories: 6 clients",
                   "CA held-out clients (1 never trained)"]
    for block in blocks:
        assert block in text, block
    assert np.isfinite(out["global"].loss_history).all()
    for m in (out["global_eval"], *out["unseen"].values()):
        assert np.isfinite([m["accuracy"], m["rmse"]]).all()


def test_serve_forecaster_serves_every_request(capsys):
    tickets = _example("torch_serve_forecaster").main(
        ["--device", "cpu", "--train-clients", "4", "--rounds", "2",
         "--requests", "16", "--days", "20"])
    text = capsys.readouterr().out
    for block in ("[serve] quick FL fit on 4 clients", "[serve] registry:",
                  "[serve] 16 forecasts in", "[serve] sample forecast"):
        assert block in text, block
    assert len(tickets) == 16 and all(t.done for t in tickets)
    assert np.isfinite(np.stack([t.result for t in tickets])).all()
