"""End-to-end example, in the PyTorch port: the counterpart of
``examples/fl_forecasting_e2e.py``, with the same flags, defaults and report.

K-means clustering on privacy-coarsened summaries → per-cluster federated
LSTM training with EW-MSE → held-out evaluation vs the single global model
— i.e. Tables 2/3 + the EW-MSE ablation at example scale — plus the round
engine's server-optimizer axis and an unseen-CLIENT generalization report:
buildings held out of training entirely (``--holdout-frac``) and fresh
buildings from every state, scored with no client-side retraining (§5.4).

``--ragged`` gives every building a different history length (new deployments
next to year-old ones) — the regime where sample-count-weighted aggregation
and weighted sampling actually differ from uniform; training then runs
through the streaming ``ClientWindowProvider`` with count-masked windows.

``--hier`` builds the (region, clients) rank mesh with
``aggregation.make_mesh`` over the initialised ``torch.distributed`` process
group.  This script starts none, so in one process the mesh is one rank
(1 region × 1 client block): the edge, region and cloud sums are the
identity and the rounds equal flat aggregation's.  Under a process group
every rank runs this script with the same flags and trains its block of
each round's clients.

It runs on the CUDA card, where every local step's forward is one launch of
the LSTM layer kernel, unless given ``--device cpu`` (the plain cells).

  PYTHONPATH=src python examples/torch_fl_forecasting_e2e.py [--rounds 60]
  PYTHONPATH=src python examples/torch_fl_forecasting_e2e.py \
      --server-opt fedadam --server-lr 0.05
  PYTHONPATH=src python examples/torch_fl_forecasting_e2e.py \
      --ragged --server-opt fedavg_weighted --sampling weighted
  PYTHONPATH=src python examples/torch_fl_forecasting_e2e.py --device cpu \
      --clients 8 --rounds 6 --heldout 6 --days 40
"""
import argparse

import numpy as np

from repro_torch.configs.base import FLConfig, ForecasterConfig
from repro_torch.core import aggregation, clustering, fedavg
from repro_torch.core import privacy as privacy_mod
from repro_torch.core.sampling import SAMPLING_STRATEGIES
from repro_torch.core.server_opt import SERVER_OPTS
from repro_torch.data import synthetic, windows
from repro_torch.data.windows import ClientWindowProvider
from repro_torch.serving.registry import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--state", default="CA")
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--heldout", type=int, default=40)
    ap.add_argument("--days", type=int, default=120)
    ap.add_argument("--server-opt", default="fedavg", choices=SERVER_OPTS,
                    help="server aggregation/optimizer rule")
    ap.add_argument("--server-lr", type=float, default=1.0,
                    help="server step on the pseudo-gradient "
                         "(fedadam/fedyogi want ~0.03-0.1)")
    ap.add_argument("--prox-mu", type=float, default=0.0,
                    help="FedProx proximal strength (with --server-opt fedprox)")
    ap.add_argument("--sampling", default="uniform",
                    choices=SAMPLING_STRATEGIES)
    ap.add_argument("--holdout-frac", type=float, default=0.0,
                    help="fraction of clients excluded from training for the "
                         "unseen-client eval (0 keeps the paper's exact "
                         "training population; fresh-building transfer is "
                         "reported either way)")
    ap.add_argument("--ragged", action="store_true",
                    help="give each building a different history length "
                         "(1/3 .. 1x of --days): sample-count weighting and "
                         "weighted sampling become material, and training "
                         "streams through the ClientWindowProvider")
    ap.add_argument("--dp-clip", type=float, default=0.0,
                    help="per-client delta L2 clip norm C (0 = off)")
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="Gaussian DP noise multiplier (std = z*C; 0 = off)")
    ap.add_argument("--quantize", type=int, default=0,
                    help="stochastic b-bit delta quantization (0 = off)")
    ap.add_argument("--quantize-ring", action="store_true",
                    help="shared-grid ring quantizer (needs --quantize): the "
                         "clear comparator of the secure-agg wire — masked "
                         "runs use it automatically (docs/privacy.md)")
    ap.add_argument("--secure-agg", action="store_true",
                    help="pairwise-masked uploads whose masks cancel in the "
                         "aggregate; with --quantize the masks live in the "
                         "quantizer's integer ring (int-b wire, uniform "
                         "masked uploads) and, under uniform aggregation, "
                         "the accountant switches to central secure-agg "
                         "mode (docs/privacy.md)")
    ap.add_argument("--mask-std", type=float, default=1.0,
                    help="per-pair secure-agg mask scale (float path only: "
                         "ring masks are uniform over the ring)")
    ap.add_argument("--privacy-delta", type=float, default=1e-5,
                    help="target delta for the (eps, delta) accountant "
                         "(reported when --dp-clip AND --dp-noise are set)")
    ap.add_argument("--hier", action="store_true",
                    help="hierarchical edge->region->cloud aggregation (the "
                         "(region, clients) mesh is built automatically)")
    ap.add_argument("--mode", default="sync", choices=("sync", "semi_sync"),
                    help="round pacing: semi_sync buffers stragglers and "
                         "folds them later with staleness-discounted weights")
    ap.add_argument("--over-select", type=float, default=1.5,
                    help="semi_sync dispatch factor: m' = ceil(f * m)")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="absolute semi_sync flush threshold (0 = use "
                         "--buffer-frac)")
    ap.add_argument("--buffer-frac", type=float, default=0.75,
                    help="flush at ceil(frac * round dispatch size) — "
                         "relative, so it adapts to uneven k-means cluster "
                         "sizes (with full participation there is no over-"
                         "selection headroom, so the demo sheds the slowest "
                         "quarter instead)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="late-update weight discount (1+tau)^-alpha")
    ap.add_argument("--stragglers", default="deterministic",
                    choices=("deterministic", "lognormal", "heavy_tail"),
                    help="simulated client-latency distribution")
    ap.add_argument("--straggler-jitter", type=float, default=1.0,
                    help="straggler spread (0 = deterministic latency)")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="per-dispatch client dropout probability (semi_sync "
                         "only): dropped uploads never arrive; the engine "
                         "re-dispatches after --timeout-rounds and, under "
                         "--secure-agg, re-keys the surviving cohort")
    ap.add_argument("--absent-prob", type=float, default=0.0,
                    help="per-round client unavailability: absent clients "
                         "are excluded from selection that round")
    ap.add_argument("--timeout-rounds", type=int, default=2,
                    help="rounds a dispatched update may stay unarrived "
                         "before the engine declares it lost")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint path stem: training state is saved as "
                         "<stem>.clustered.npz / <stem>.global.npz and a "
                         "killed run resumes bit-identically")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="save the checkpoint every N rounds")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    fcfg = ForecasterConfig(cell="lstm", hidden_dim=64)
    if args.ragged:
        dr = np.random.default_rng(7)
        days_i = dr.integers(max(20, args.days // 3), args.days + 1,
                             size=args.clients)
        series = [synthetic.generate_buildings(args.state, [i],
                                               days=int(d))[0]
                  for i, d in enumerate(days_i)]
        # full-participation training revisits every client each round, so
        # cache all of them (the raw series are in memory anyway)
        train_data = ClientWindowProvider.from_series(
            series, fcfg.lookback, fcfg.horizon, cache_size=args.clients)
        c = train_data.train_counts
        print(f"== ragged histories: {args.clients} clients, train windows "
              f"min/median/max = {c.min()}/{int(np.median(c))}/{c.max()} "
              f"(count-masked streaming batches)")
    else:
        series = synthetic.generate_buildings(args.state,
                                              list(range(args.clients)),
                                              days=args.days)
        train_data = series
    base = dict(n_clients=args.clients, clients_per_round=args.clients,
                rounds=args.rounds, lr=0.05, loss="ew_mse", beta=2.0,
                cluster_days=min(273, int(args.days * 0.75)),
                server_opt=args.server_opt, server_lr=args.server_lr,
                prox_mu=args.prox_mu, sampling=args.sampling,
                holdout_frac=args.holdout_frac, dp_clip=args.dp_clip,
                dp_noise=args.dp_noise, quantize_bits=args.quantize,
                quantize_ring=args.quantize_ring,
                secure_agg=args.secure_agg, secure_mask_std=args.mask_std,
                privacy_delta=args.privacy_delta,
                aggregation="hierarchical" if args.hier else "flat",
                mode=args.mode, over_select=args.over_select,
                buffer_k=args.buffer_k,
                # an explicit --buffer-k wins; otherwise the relative
                # threshold flushes at frac of each round's ACTUAL dispatch
                # size, which tracks uneven k-means cluster memberships
                buffer_frac=(0.0 if args.buffer_k or args.mode != "semi_sync"
                             else args.buffer_frac),
                staleness_alpha=args.staleness_alpha,
                stragglers=args.stragglers,
                straggler_jitter=args.straggler_jitter,
                dropout_prob=args.dropout_prob,
                absent_prob=args.absent_prob,
                timeout_rounds=args.timeout_rounds)
    run_kw = dict(checkpoint_every=args.checkpoint_every, device=device)
    if args.hier:
        run_kw["mesh"] = aggregation.make_mesh(
            FLConfig(**base).aggregation_config)

    pipe = ""
    if (args.dp_clip or args.dp_noise or args.quantize or args.hier
            or args.secure_agg):
        ring = bool(args.quantize) and (args.quantize_ring or args.secure_agg)
        pipe = (f", transforms clip={args.dp_clip}/noise={args.dp_noise}"
                f"/quant={args.quantize}b{'-ring' if ring else ''}"
                f"{'/masked' if args.secure_agg else ''}"
                f", agg={base['aggregation']}")
    if args.mode == "semi_sync":
        thresh = (f"buffer_k={args.buffer_k}" if args.buffer_k
                  else f"buffer_frac={args.buffer_frac}")
        pipe += (f", semi_sync(over_select={args.over_select}, {thresh}, "
                 f"alpha={args.staleness_alpha}, "
                 f"stragglers={args.stragglers})")
    if args.dropout_prob or args.absent_prob:
        pipe += (f", churn(dropout={args.dropout_prob}, "
                 f"absent={args.absent_prob}, "
                 f"timeout={args.timeout_rounds}r)")
    print(f"== clustered FL ({args.clients} clients → 4 clusters, "
          f"server_opt={args.server_opt}, sampling={args.sampling}{pipe})")
    res_c = fedavg.run_federated_training(
        train_data, fcfg, FLConfig(**base, n_clusters=4),
        log_every=args.rounds // 2,
        checkpoint_path=(f"{args.checkpoint}.clustered"
                         if args.checkpoint else None), **run_kw)
    print("== global FL (no clustering)")
    res_g = fedavg.run_federated_training(
        train_data, fcfg, FLConfig(**base, n_clusters=0),
        log_every=args.rounds // 2,
        checkpoint_path=(f"{args.checkpoint}.global"
                         if args.checkpoint else None), **run_kw)

    # privacy: the (eps, delta) accountant composes the per-round clipped +
    # noised release across rounds (core/privacy.py; see docs/privacy.md) —
    # reported per trained model since each cluster has its own sampling rate
    if args.dp_clip or args.dp_noise:
        print()
        for cid, res in sorted(res_c.items()):
            print(f"cluster {cid} " + privacy_mod.format_report(res.privacy))
        print("global    " + privacy_mod.format_report(res_g[-1].privacy))

    # round pacing: simulated wall-clock (the edge metric) for the global
    # model; under semi_sync, also train the sync baseline with the SAME
    # straggler model and compare simulated time to the common target loss
    print(f"\nsimulated wall-clock (global model): "
          f"{res_g[-1].sim_times[-1]:.1f}s over {args.rounds} rounds "
          f"({args.stragglers} stragglers)")
    if args.mode == "semi_sync":
        # the sync baseline blocks on every upload, so dropout would stall
        # it forever — compare against the dropout-free sync run instead
        res_sync = fedavg.run_federated_training(
            train_data, fcfg, FLConfig(**{**base, "mode": "sync",
                                          "dropout_prob": 0.0},
                                       n_clusters=0),
            mesh=run_kw.get("mesh"), device=device)
        # last FINITE losses: cohort-atomic pacing (--secure-agg) records
        # nan for flushes that complete no cohort
        target = max(fedavg.final_loss(res_g[-1]),
                     fedavg.final_loss(res_sync[-1]))
        tt = {k: fedavg.time_to_target(r, target)
              for k, r in (("semi_sync", res_g[-1]),
                           ("sync", res_sync[-1]))}
        print(f"wall-clock to target loss {target:.5f}: semi_sync "
              f"{tt['semi_sync']:.1f}s vs sync {tt['sync']:.1f}s "
              f"({tt['sync'] / tt['semi_sync']:.2f}x)")

    held = synthetic.generate_buildings(
        args.state, list(range(10_000, 10_000 + args.heldout)),
        days=args.days)
    data = windows.batched_client_windows(held, fcfg.lookback, fcfg.horizon)
    x, y, stats = windows.flatten_test_windows(data)

    g = fedavg.evaluate_global(res_g[-1].params, x, y, fcfg, stats=stats,
                               device=device)
    print(f"\nglobal model  F^A : accuracy {g['accuracy']:.2f}%  "
          f"rmse {g['rmse']:.3f}  per-horizon "
          f"{np.round(g['per_horizon_accuracy'], 1)}")

    z = windows.daily_average_vector(held, base["cluster_days"])
    assign = clustering.assign(z, res_c[0].cluster_centroids)
    n_win = data["x_test"].shape[1]
    accs = []
    for cid, res in sorted(res_c.items()):
        m = np.repeat(assign == cid, n_win)
        if not m.any():
            continue
        met = fedavg.evaluate_global(res.params, x[m], y[m], fcfg,
                                     stats=(stats[0][m], stats[1][m]),
                                     device=device)
        accs.append(met["accuracy"])
        print(f"cluster model F^C{cid}: accuracy {met['accuracy']:.2f}%  "
              f"({int(m.sum() / n_win)} held-out buildings)")
    print(f"\navg of cluster models: {np.mean(accs):.2f}% vs global "
          f"{g['accuracy']:.2f}%  (paper: clustering ≥ global)")

    # ---- unseen-CLIENT generalization (§5.4): clients held out of training
    # entirely, plus fresh buildings from every state — no retraining.
    print("\n== unseen-client generalization (global model, no retraining)")
    unseen = {}
    held_ids = res_g[-1].heldout_clients
    if held_ids is not None:
        m = fedavg.evaluate_unseen_clients(res_g[-1].params,
                                           [series[i] for i in held_ids],
                                           fcfg, device=device)
        print(f"{args.state} held-out clients ({len(held_ids)} never "
              f"trained): accuracy {m['accuracy']:.2f}%  rmse {m['rmse']:.3f}")
        unseen["held_out"] = m
    for state in sorted(synthetic.STATES):
        fresh = synthetic.generate_buildings(
            state, list(range(20_000, 20_000 + args.heldout)), days=args.days)
        m = fedavg.evaluate_unseen_clients(res_g[-1].params, fresh, fcfg,
                                           device=device)
        tag = "in-dist" if state == args.state else "transfer"
        print(f"{state:>4} fresh buildings ({tag}): "
              f"accuracy {m['accuracy']:.2f}%  rmse {m['rmse']:.3f}")
        unseen[state] = m
    return {"clustered": res_c, "global": res_g[-1], "global_eval": g,
            "cluster_accuracy": accs, "unseen": unseen}


if __name__ == "__main__":
    main()
