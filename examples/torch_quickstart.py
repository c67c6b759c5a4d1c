"""Quickstart, in the PyTorch port: the counterpart of
``examples/quickstart.py``.

Trains a global LSTM forecaster with FedAvg + EW-MSE over 12 synthetic
California commercial buildings, then forecasts the next hour for an UNSEEN
building (the paper's deployment story: no client-side retraining).  It runs
on the CUDA card, where every local step's forward is one launch of the
LSTM layer kernel, unless given ``--device cpu`` (the plain cells).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ForecasterConfig
from repro_torch.core import fedavg
from repro_torch.data import synthetic, windows
from repro_torch.models import forecaster
from repro_torch.models.layers import tree_from_numpy
from repro_torch.serving.registry import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--buildings", type=int, default=12)
    ap.add_argument("--days", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a micro-grid of buildings, 15-min smart-meter data
    series = synthetic.generate_buildings("CA", list(range(args.buildings)),
                                          days=args.days)
    print(f"corpus: {series.shape[0]} buildings × {series.shape[1]} readings "
          f"(mean {series.mean():.1f} kWh)")

    # 2. federated training: every client trains locally, server averages
    fcfg = ForecasterConfig(cell="lstm", hidden_dim=32)
    flcfg = FLConfig(n_clients=args.buildings,
                     clients_per_round=args.buildings, rounds=args.rounds,
                     loss="ew_mse", beta=2.0, n_clusters=0, lr=0.05)
    result = fedavg.run_federated_training(series, fcfg, flcfg, log_every=5,
                                           device=device)[-1]
    print(f"final train loss: {result.loss_history[-1]:.5f}")

    # 3. deploy to an unseen building
    unseen = synthetic.generate_buildings("CA", [99_999], days=args.days)[0]
    norm, (lo, hi) = windows.minmax_normalize(unseen)
    x = torch.from_numpy(np.ascontiguousarray(
        norm[-fcfg.lookback:][None, :, None], dtype=np.float32)).to(device)
    with torch.inference_mode():
        pred = forecaster.forecast(tree_from_numpy(result.params, device), x,
                                   fcfg).cpu().numpy()[0]
    kwh = pred * max(hi - lo, 1e-9) + lo
    actual_recent = unseen[-4:]
    print(f"next-hour forecast (kWh/15min): {np.round(kwh, 2)}")
    print(f"(building's recent hour was:    {np.round(actual_recent, 2)})")
    return {"loss_history": result.loss_history, "forecast_kwh": kwh,
            "params": result.params}


if __name__ == "__main__":
    main()
