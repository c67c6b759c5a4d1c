"""Serving entry point: a thin client of the ``repro_torch.serving`` tier (the
micro-grid provider's deployment path, §5.4: the FL model serves 1000s of
unseen consumers with no client-side retraining), on the card.

Publishes forecaster weights into a :class:`~repro_torch.serving.ModelRegistry`
and replays unseen-consumer requests through the padded-bucket
:class:`~repro_torch.serving.ServingEngine`: raw watt-hours in, kWh
forecasts out.  Without ``--checkpoint`` it first trains a quick federated
model (``--train-clients`` buildings, ``--rounds`` rounds, per cluster with
``--clusters k``) on the same device and publishes each cluster's model,
routed by the training's k-means centroids.  With ``--checkpoint`` (an
``.npz`` written by either package: a bare param tree or an FL training
snapshot) it publishes those weights, and ``--clusters k`` takes the
router's centroids from the requesting consumers' daily summaries.
``--int8`` serves int8 weights (a 4x smaller model on the card), rounded
under the JAX package's keys: ``fold_in(fold_in(PRNGKey(seed), rounds),
slot + 1)``.

  PYTHONPATH=src python -m repro_torch.launch.serve --state CA --requests 256
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --clusters 2 \
      --train-clients 8 --rounds 3 --days 14
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ForecasterConfig
from repro_torch.core import clustering, fedavg, prng
from repro_torch.data import synthetic, windows
from repro_torch.models import forecaster
# re-exported: chip_smoke.py's serving phase seeds its weights with it
from repro_torch.models.layers import seeded_generator  # noqa: F401
from repro_torch.serving import (ClusterRouter, ModelRegistry, ServingEngine,
                                 bucket_for)


def serve_forecaster(params, cfg: ForecasterConfig, requests: np.ndarray,
                     batch: int = 1024):
    """requests: (n, lookback) NORMALIZED windows -> (n, horizon) forecasts,
    on the device the params live on.

    Batches are padded up to the next power-of-two bucket and the pad rows
    sliced off, so any request count reuses one of <= log2(batch)+1 batch
    shapes.  Callers holding RAW watt-hour windows should use
    :class:`repro_torch.serving.ServingEngine`, which also owns
    normalization and model hot-swap.
    """
    device = params["head"]["w"].device
    outs = []
    with torch.inference_mode():
        for i in range(0, len(requests), batch):
            chunk = np.asarray(requests[i:i + batch], np.float32)
            n = chunk.shape[0]
            b = bucket_for(n, 1, batch)
            if b > n:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - n,) + chunk.shape[1:], chunk.dtype)])
            x = torch.from_numpy(chunk[..., None]).to(device)
            outs.append(forecaster.forecast(params, x, cfg).cpu().numpy()[:n])
    return np.concatenate(outs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="CA")
    ap.add_argument("--train-clients", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--requests", type=int, default=256,
                    help="# of held-out consumers sending forecast requests")
    ap.add_argument("--days", type=int, default=120)
    ap.add_argument("--clusters", type=int, default=0,
                    help="k-means clusters (0 = single global model); "
                    "unseen consumers are routed by nearest centroid")
    ap.add_argument("--int8", action="store_true",
                    help="serve int8-quantized weights (4x smaller)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz weights to publish (either package's format) "
                    "instead of training")
    ap.add_argument("--device", default=None,
                    help="cuda when omitted (raises without a card); cpu "
                    "runs the plain cells")
    args = ap.parse_args(argv)

    fcfg = ForecasterConfig()
    registry = ModelRegistry(device=args.device)
    weights = "int8" if args.int8 else "fp32"
    # int8 rounding keys, as the JAX package derives them: one root per
    # (seed, rounds), folded with slot + 1 per published model
    qroot = prng.fold_in(prng.PRNGKey(args.seed), args.rounds)
    held = synthetic.generate_buildings(
        args.state, list(range(50_000, 50_000 + args.requests)),
        days=args.days)

    # ---- publish the weights into the serving registry
    if args.checkpoint:
        if args.clusters > 1:
            z = windows.daily_average_vector(held, days=args.days)
            cents, _, _ = clustering.kmeans(z, args.clusters, seed=args.seed)
            router = ClusterRouter(cents)
        else:
            router = ClusterRouter(None)
        if not registry.poll_checkpoint(args.checkpoint, fcfg,
                                        weights=weights,
                                        key=qroot if args.int8 else None):
            raise ValueError(f"no forecaster weights in {args.checkpoint}")
    else:
        flcfg = FLConfig(n_clients=args.train_clients,
                         clients_per_round=args.train_clients,
                         rounds=args.rounds, n_clusters=args.clusters,
                         seed=args.seed, lr=0.05,
                         cluster_days=min(273, int(args.days * 0.75)))
        print(f"[serve] quick FL fit on {args.train_clients} clients "
              f"({args.rounds} rounds, clusters={args.clusters or 'off'})")
        series = synthetic.generate_buildings(
            args.state, list(range(args.train_clients)), days=args.days)
        results = fedavg.run_federated_training(series, fcfg, flcfg,
                                                device=registry.device)
        # ---- publish the trained models, one slot per cluster
        for cid, res in results.items():
            registry.publish(
                res.params, fcfg, slot=cid, generation=len(res.loss_history),
                weights=weights,
                key=prng.fold_in(qroot, cid + 1) if args.int8 else None)
        router = ClusterRouter.from_result(next(iter(results.values())))
    engine = ServingEngine(registry, router, max_batch=args.max_batch,
                           min_bucket=args.min_bucket, device=args.device)
    n_prog = engine.warmup()
    print(f"[serve] registry: slots {registry.slots()} ({weights}) on "
          f"{registry.device}; warmed {n_prog} bucket shapes")

    # ---- replay raw watt-hour requests from unseen consumers
    print(f"[serve] serving {args.requests} unseen consumers")
    t0 = time.perf_counter()
    tickets = [engine.submit(50_000 + i, held[i, -fcfg.lookback:],
                             history=held[i])
               for i in range(args.requests)]
    engine.flush()
    dt = time.perf_counter() - t0
    if not all(t.done for t in tickets):
        raise RuntimeError("some requests were not served")
    st = engine.stats
    print(f"[serve] {args.requests} forecasts in {dt*1e3:.1f} ms "
          f"({dt/args.requests*1e6:.0f} µs/request, "
          f"{st.flushes} batches, fill {st.fill():.2f})")
    print(f"[serve] sample forecast (kWh, next hour): "
          f"{np.round(tickets[0].result, 2)}")
    return tickets


if __name__ == "__main__":
    main()
