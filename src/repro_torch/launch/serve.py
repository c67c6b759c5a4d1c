"""Serving entry point: a thin client of the ``repro_torch.serving`` tier (the
micro-grid provider's deployment path, §5.4: the FL model serves 1000s of
unseen consumers with no client-side retraining), on the card.

Publishes forecaster weights into a :class:`~repro_torch.serving.ModelRegistry`
and replays unseen-consumer requests through the padded-bucket
:class:`~repro_torch.serving.ServingEngine`: raw watt-hours in, kWh
forecasts out.  The weights come from ``--checkpoint`` (an ``.npz`` written
by either package: a bare param tree or an FL training snapshot) or, without
it, from a seeded random init.  With ``--clusters k`` the router's k-means
centroids come from the requesting consumers' daily summaries.

  PYTHONPATH=src python -m repro_torch.launch.serve --state CA --requests 256
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --clusters 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ForecasterConfig
from repro_torch.core import clustering
from repro_torch.data import synthetic, windows
from repro_torch.models import forecaster
from repro_torch.serving import (GLOBAL_SLOT, ClusterRouter, ModelRegistry,
                                 ServingEngine, bucket_for)


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


def seeded_generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded injectively from (seed, *stream)."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default="CA")
    ap.add_argument("--requests", type=int, default=256,
                    help="# of held-out consumers sending forecast requests")
    ap.add_argument("--days", type=int, default=120)
    ap.add_argument("--clusters", type=int, default=0,
                    help="k-means clusters (0 = single global model); "
                    "unseen consumers are routed by nearest centroid")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz weights to publish (either package's format); "
                    "default: seeded random init")
    ap.add_argument("--device", default=None,
                    help="cuda when omitted (raises without a card); cpu "
                    "runs the plain cells")
    args = ap.parse_args(argv)

    fcfg = ForecasterConfig()
    held = synthetic.generate_buildings(
        args.state, list(range(50_000, 50_000 + args.requests)),
        days=args.days)
    if args.clusters > 1:
        z = windows.daily_average_vector(held, days=args.days)
        cents, _, _ = clustering.kmeans(z, args.clusters, seed=args.seed)
        router = ClusterRouter(cents)
    else:
        router = ClusterRouter(None)

    # ---- publish the weights into the serving registry
    registry = ModelRegistry(device=args.device)
    if args.checkpoint:
        if not registry.poll_checkpoint(args.checkpoint, fcfg):
            raise ValueError(f"no forecaster weights in {args.checkpoint}")
    else:
        slots = [GLOBAL_SLOT] + list(range(args.clusters if router.enabled
                                           else 0))
        for s in slots:
            registry.publish(forecaster.init_forecaster(
                seeded_generator(args.seed, s + 1), fcfg), fcfg, slot=s)
    engine = ServingEngine(registry, router, max_batch=args.max_batch,
                           min_bucket=args.min_bucket, device=args.device)
    n_prog = engine.warmup()
    print(f"[serve] registry: slots {registry.slots()} (fp32) on "
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
