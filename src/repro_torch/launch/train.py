"""FL training driver — the paper's end-to-end pipeline as a CLI, on the
card: the counterpart of ``src/repro/launch/train.py``.

Generates the OpenEIA-calibrated corpus for a state, optionally clusters
clients, trains per-cluster federated models (LSTM/GRU × MSE/EW-MSE × any
``--server-opt`` rule; every local step's forward is one launch of the
CUDA layer kernel per layer for all selected clients), and evaluates on a
large held-out population, mirroring §4/§5 of the paper.  The last line of
its output is one JSON object: rounds, clients and local steps per round,
wall seconds per round, held-out accuracy / MAPE / RMSE, and the kernel
launches of training and of evaluation.

  PYTHONPATH=src python -m repro_torch.launch.train --state CA --rounds 100 \\
      --clusters 4 --loss ew_mse --beta 2 --cell lstm --heldout 500
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --clients 6 --rounds 3 --days 30 --heldout 5
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import FLConfig, ForecasterConfig
from repro_torch.core import clustering, fedavg
from repro_torch.core.sampling import SAMPLING_STRATEGIES
from repro_torch.core.server_opt import SERVER_OPTS
from repro_torch.data import partition, synthetic, windows
from repro_torch.kernels import ops
from repro_torch.serving.registry import resolve_device


def _since(before):
    """Kernel launches since ``before`` (an ``ops.launch_counts()``)."""
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def configs(argv=None):
    """The parsed flags and the (ForecasterConfig, FLConfig) they give."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="CA", choices=list(synthetic.STATES))
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="M (0 = all)")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cell", default="lstm", choices=("lstm", "gru"))
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--loss", default="ew_mse", choices=("mse", "ew_mse"))
    ap.add_argument("--beta", type=float, default=2.0)
    ap.add_argument("--clusters", type=int, default=0,
                    help="K-means k (0 = single global model)")
    ap.add_argument("--server-opt", default="fedavg", choices=SERVER_OPTS,
                    help="round-engine server update rule")
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--prox-mu", type=float, default=0.0,
                    help="FedProx proximal strength")
    ap.add_argument("--sampling", default="uniform",
                    choices=SAMPLING_STRATEGIES)
    ap.add_argument("--heldout", type=int, default=200,
                    help="# held-out buildings for evaluation")
    ap.add_argument("--days", type=int, default=365)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="cuda when omitted (raises without a card); cpu "
                    "runs the plain cells")
    args = ap.parse_args(argv)
    fcfg = ForecasterConfig(cell=args.cell, hidden_dim=args.hidden)
    flcfg = FLConfig(
        n_clients=args.clients,
        clients_per_round=args.clients_per_round or args.clients,
        local_epochs=args.local_epochs, batch_size=args.batch_size,
        rounds=args.rounds, lr=args.lr, loss=args.loss, beta=args.beta,
        n_clusters=args.clusters, seed=args.seed,
        cluster_days=min(273, int(args.days * 0.75)),
        server_opt=args.server_opt, server_lr=args.server_lr,
        prox_mu=args.prox_mu, sampling=args.sampling)
    return args, fcfg, flcfg


def main(argv=None):
    args, fcfg, flcfg = configs(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    print(f"[train] generating {args.clients} train buildings ({args.state})")
    train_series = synthetic.generate_buildings(
        args.state, list(range(args.clients)), days=args.days)
    provider = fedavg._as_provider(train_series, fcfg)
    steps = partition.local_steps(provider.n_win_max, args.batch_size,
                                  args.local_epochs)
    print(f"[train] FL training on {device}: {args.rounds} rounds × "
          f"{flcfg.clients_per_round} clients × {steps} local steps, "
          f"loss={args.loss}"
          f"{f' β={args.beta}' if args.loss == 'ew_mse' else ''}, "
          f"clusters={args.clusters or 'off'}")
    launched = ops.launch_counts()
    t_train = time.perf_counter()
    results = fedavg.run_federated_training(
        provider, fcfg, flcfg, log_every=max(args.rounds // 5, 1),
        device=device)
    train_s = time.perf_counter() - t_train
    train_launches = _since(launched)

    print(f"[train] evaluating on {args.heldout} held-out buildings")
    held_ids = list(range(10_000, 10_000 + args.heldout))
    held = synthetic.generate_buildings(args.state, held_ids, days=args.days)
    data = windows.batched_client_windows(held, fcfg.lookback, fcfg.horizon)
    x, y, stats = windows.flatten_test_windows(data)

    launched = ops.launch_counts()
    report = {}
    if args.clusters:
        z = windows.daily_average_vector(held, flcfg.cluster_days)
        cents = results[0].cluster_centroids
        assign = clustering.assign(z, cents)
        n_win = data["x_test"].shape[1]
        for cid, res in results.items():
            m = np.repeat(assign == cid, n_win)
            if not m.any():
                continue
            met = fedavg.evaluate_global(res.params, x[m], y[m], fcfg,
                                         stats=(stats[0][m], stats[1][m]),
                                         device=device)
            report[f"cluster_{cid}"] = met
        accs = [v["accuracy"] for v in report.values()]
        report["avg_of_clusters"] = float(np.mean(accs))
    else:
        report["global"] = fedavg.evaluate_global(results[-1].params, x, y,
                                                  fcfg, stats=stats,
                                                  device=device)
    eval_launches = _since(launched)
    for k, v in report.items():
        if isinstance(v, dict):
            print(f"  {k}: accuracy={v['accuracy']:.2f}%  rmse={v['rmse']:.3f}"
                  f"  per-horizon={np.round(v['per_horizon_accuracy'], 1)}")
        else:
            print(f"  {k}: {v:.2f}")
    print(f"[train] total {time.perf_counter() - t0:.0f}s")
    mets = [v for v in report.values() if isinstance(v, dict)]
    summary = {
        "device": str(device), "cell": args.cell, "rounds": args.rounds,
        "clusters": len(results),
        "clients_per_round": flcfg.clients_per_round,
        "local_steps_per_round": steps,
        "wall_s_per_round": train_s / (args.rounds * len(results)),
        "loss_history": {str(cid): res.loss_history.tolist()
                         for cid, res in results.items()},
        "heldout_windows": int(x.shape[0]),
        "heldout": {k: float(np.mean([v[k] for v in mets]))
                    for k in ("accuracy", "mape", "rmse")},
        "launches_train": train_launches, "launches_eval": eval_launches,
    }
    if args.out:
        clean = {k: ({kk: (vv.tolist() if hasattr(vv, 'tolist') else vv)
                      for kk, vv in v.items()} if isinstance(v, dict) else v)
                 for k, v in report.items()}
        with open(args.out, "w") as f:
            json.dump(clean, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
