"""Federated round engine (paper Alg. 1, generalized), synchronous and on
one device: the counterpart of the sync, single-process half of
``src/repro/core/fedavg.py``.

    select -> local-update -> transform(deltas) -> aggregate -> server-update

*select* picks the round's participants (``core/sampling.py``); every
selected client runs ``ClientUpdate`` — E local epochs of minibatch SGD,
optionally FedProx-regularized (``core/client.py``) — all M of them at once,
each step's forward one launch of the CUDA layer kernel per layer with the
clients on its grid; *transform* is the identity stack; *aggregate* is the
sample-count-weighted (or uniform) average of the local models; the server
then applies a *server optimizer* to the pseudo-gradient
``w_global - w_agg`` (``core/server_opt.py``).  Rounds are synchronous: the
simulated clock (``core/latency.py``) advances by the slowest selected
client, and ``FLResult.sim_times`` reports it.

Not ported yet, and refused with ``NotImplementedError`` naming its ROADMAP
item: non-identity transforms and DP noise (A7), secure aggregation (A8),
a mesh or hierarchical aggregation (A9), semi-synchronous pacing, client
churn and checkpoint/resume (A10).

Params live on the device as trees of tensors; ``FLResult.params`` comes
back as host numpy arrays, the JAX package's tree layout, which
``checkpoint.save`` and ``serving.ModelRegistry.publish`` take as they are.
Initial params are drawn from a ``torch.Generator`` seeded from
``(seed, cluster id)`` (``jax.random`` cannot be replayed in torch), or
given through ``run_federated_training(init_params=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import (FLConfig, ForecasterConfig,
                                      TransformConfig)
from repro_torch.core import clustering, losses as losses_mod
from repro_torch.core import latency as latency_mod
from repro_torch.core import privacy as privacy_mod
from repro_torch.core import sampling as sampling_mod
from repro_torch.core import server_opt as server_opt_mod
from repro_torch.core.client import local_update
from repro_torch.data import partition, windows
from repro_torch.models import forecaster
from repro_torch.models.layers import (seeded_generator, tree_from_numpy,
                                       tree_map)
from repro_torch.serving.registry import resolve_device


# ------------------------------------------------------------- aggregation
def fedavg_aggregate(stacked_params):
    """Uniformly average a client-stacked param tree (leading axis = clients)."""
    return tree_map(lambda w: w.mean(0), stacked_params)


def _weighted_sums(stacked_params, weights):
    """Weighted sums: the ONE place the weighting math lives.

    Returns (tree of Σ_i weight_i * w_i, Σ_i weight_i).
    """
    def ws(w):
        wt = weights.reshape((-1,) + (1,) * (w.dim() - 1))
        return (w * wt).sum(0)

    return tree_map(ws, stacked_params), weights.sum()


def weighted_aggregate(stacked_params, weights):
    """Weighted average of a client-stacked tree; weights: (M,) float."""
    sums, wsum = _weighted_sums(stacked_params, weights)
    return tree_map(lambda s: s / wsum, sums)


# ------------------------------------------------------------ one round
def engine_round(params, x, y, batch_idx, weights, lr, prox_mu,
                 cfg: ForecasterConfig, loss: Callable,
                 cell_impl: str = "kernel"):
    """Generalized round: weighted aggregation + optional FedProx clients.

    x: (M, n_win, L, 1); y: (M, n_win, H); batch_idx: (M, steps, B);
    weights: (M,) aggregation weights (sample counts; pass ones for
    uniform); prox_mu: FedProx proximal strength (0 = plain local SGD).
    Returns ``(w_agg, weighted mean client loss)`` — the server step is
    applied by the caller (``RoundEngine.step``).
    """
    locals_, client_loss = local_update(params, x, y, batch_idx, lr, cfg,
                                        loss, cell_impl, prox_mu)
    with torch.no_grad():
        w_agg = weighted_aggregate(locals_, weights)
        loss_mean = (weights * client_loss).sum() / weights.sum()
    return w_agg, loss_mean


def pipeline_round(params, x, y, batch_idx, weights, lr, prox_mu,
                   cfg: ForecasterConfig, loss: Callable,
                   tcfg: TransformConfig = TransformConfig(),
                   cell_impl: str = "kernel"):
    """Full pipeline round with the identity transform stack: the raw local
    models aggregated through :func:`_weighted_sums`, as the JAX package's
    identity path does.  Returns ``(w_agg, weighted mean client loss)``."""
    if not tcfg.is_identity:
        raise NotImplementedError(
            "delta transforms (clip, DP noise, quantize) are not ported yet: "
            "ROADMAP A7")
    return engine_round(params, x, y, batch_idx, weights, lr, prox_mu, cfg,
                        loss, cell_impl)


# ------------------------------------------------------------- round engine
class RoundEngine:
    """Composable federated round: select -> local update -> transform ->
    aggregate -> server update, synchronous, on one device::

        engine = RoundEngine(fcfg, flcfg)          # the card; or device="cpu"
        params, state = engine.init(seeded_generator(flcfg.seed, 0))
        sel = engine.select(rng, members, m, round_idx, member_weights)
        params, state, loss = engine.step(params, state, x[sel], y[sel],
                                          bidx, counts[sel], round_idx)

    ``cell_impl`` picks the forward of every local step: ``"kernel"`` (the
    CUDA layer kernels, the default) or ``"torch"`` (the plain cells).
    ``device`` defaults to the card and raises without one; ``"cpu"`` runs
    the plain versions, only when the caller asks.
    """

    def __init__(self, fcfg: ForecasterConfig, flcfg: FLConfig, *,
                 loss: Optional[Callable] = None, mesh=None,
                 cell_impl: str = "kernel", device=None):
        if mesh is not None or flcfg.aggregation_config.kind != "flat":
            raise NotImplementedError(
                "mesh execution and hierarchical aggregation are not ported "
                "yet: ROADMAP A9")
        if not flcfg.transform.is_identity:
            raise NotImplementedError(
                "delta transforms (clip, DP noise, quantize) are not ported "
                "yet: ROADMAP A7")
        if flcfg.secure.enabled:
            raise NotImplementedError(
                "secure aggregation is not ported yet: ROADMAP A8")
        if flcfg.async_config.mode != "sync" or flcfg.churn.absent_prob > 0:
            raise NotImplementedError(
                "semi-synchronous pacing and client churn are not ported "
                "yet: ROADMAP A10")
        if cell_impl not in forecaster.CELL_IMPLS:
            raise ValueError(f"cell_impl={cell_impl!r}; pick from "
                             f"{forecaster.CELL_IMPLS}")
        # stage names/knobs were validated eagerly by the FLConfig facade
        self.fcfg, self.flcfg = fcfg, flcfg
        ccfg = flcfg.client_opt
        self.loss = loss if loss is not None else losses_mod.make_loss(
            ccfg.loss, ccfg.beta)
        self.cell_impl = cell_impl
        self.device = resolve_device(device)
        self.sampler = sampling_mod.make_sampler(flcfg.sampling_config)
        # proximal term only under fedprox (prox_mu is ignored otherwise)
        self.prox_mu = ccfg.prox_mu if flcfg.server_opt == "fedprox" else 0.0
        self.weighted = server_opt_mod.uses_weighted_aggregation(flcfg)
        self.transform = flcfg.transform
        self.accountant: Optional[privacy_mod.PrivacyAccountant] = None
        # the latency model is host-side only: under sync pacing it tracks
        # a simulated wall clock and never touches the round math
        self.async_cfg = flcfg.async_config
        self.latency = latency_mod.LatencyModel(
            self.async_cfg.latency, flcfg.seed,
            latency_mod.payload_bytes(fcfg.num_params(), flcfg.quantize_bits),
            churn=flcfg.churn)
        self._clock = 0.0

    def dispatch_m(self, m: int, n_members: Optional[int] = None) -> int:
        """Per-round dispatch size: ``m`` under sync pacing."""
        return m

    @property
    def sim_time(self) -> float:
        """Simulated wall-clock seconds consumed so far (event clock)."""
        return self._clock

    def reset_pacing(self) -> None:
        """Rewind the simulated clock (call between independent trainings,
        e.g. per cluster)."""
        self._clock = 0.0

    def init(self, generator: Optional[torch.Generator] = None,
             params=None):
        """Fresh global params + server-optimizer state on the engine's
        device: drawn from ``generator``, or ``params`` (a tree of numpy
        arrays or CPU tensors, e.g. made by the JAX package) carried over."""
        if params is None:
            params = forecaster.init_forecaster(generator, self.fcfg)
        params = tree_from_numpy(params, self.device)
        return params, server_opt_mod.init_server_state(params)

    def select(self, rng, members: np.ndarray, m: int, round_idx: int,
               weights: Optional[np.ndarray] = None) -> np.ndarray:
        """Pick this round's m participants (``FLConfig.sampling``)."""
        return self.sampler(rng, np.asarray(members), m, round_idx, weights)

    def attach_accountant(self, n_members: int, dispatch_m: int) -> None:
        """(Re)bind the (eps, delta) accountant for one training run:
        sampling rate ``q = dispatch_m / n_members``.  Under the identity
        stack it is disabled and reports ``epsilon = inf``."""
        q = min(1.0, dispatch_m / max(n_members, 1))
        self.accountant = privacy_mod.make_accountant(
            self.transform, self.flcfg.privacy, q)

    def step(self, params, state, x, y, batch_idx, weights,
             round_idx: int = 0):
        """One full round on already-selected client data.

        x: (M, n_win, L, 1); y: (M, n_win, H); batch_idx: (M, steps, B),
        numpy arrays or tensors; weights: (M,) per-client sample counts —
        zero marks padding duplicates, which are excluded from aggregation
        AND loss on both the uniform and weighted paths.  The slowest
        client's simulated latency advances the clock.  Returns ``(new
        params, new server state, round loss)``.
        """
        if self.accountant is not None:
            self.accountant.observe_cohort(
                int((np.asarray(weights) > 0).sum()))
            self.accountant.step()
        w_np = np.asarray(weights, np.float32)
        real = np.flatnonzero(w_np > 0)
        times = self.latency.times(round_idx, w_np[real],
                                   self.flcfg.client_opt.local_epochs,
                                   slots=real)
        self._clock += float(times.max(initial=0.0))
        return self._sync_step(params, state, x, y, batch_idx, weights)

    def _sync_step(self, params, state, x, y, batch_idx, weights):
        """The synchronous round (select-free part of paper Alg. 1)."""
        dev = self.device
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        if not self.weighted:             # uniform aggregation (pads stay 0)
            w = (w > 0).float()
        x, y = (torch.as_tensor(a, device=dev) for a in (x, y))
        batch_idx = torch.as_tensor(batch_idx, device=dev)
        w_agg, loss = pipeline_round(params, x, y, batch_idx, w,
                                     self.flcfg.lr, self.prox_mu, self.fcfg,
                                     self.loss, self.transform,
                                     self.cell_impl)
        params, state = server_opt_mod.server_update(params, w_agg, state,
                                                     self.flcfg.server)
        return params, state, loss


# ------------------------------------------------------------------ driver
@dataclasses.dataclass
class FLResult:
    params: Dict
    loss_history: np.ndarray
    cluster_centroids: Optional[np.ndarray] = None
    cluster_assignments: Optional[np.ndarray] = None  # (N,); -1 = held out
    heldout_clients: Optional[np.ndarray] = None
    sim_times: Optional[np.ndarray] = None  # (T,) simulated seconds at each
    #                                       # round's end (latency model)
    eps_history: Optional[np.ndarray] = None  # (T,) running accountant eps
    #                                       # after each round (inf when the
    #                                       # accountant is disabled)
    privacy: Optional[Dict] = None          # final accountant report
    #                                       # (core/privacy.py::report)


def time_to_target(res: FLResult, target: float) -> float:
    """Simulated seconds until ``res.loss_history`` first reaches ``target``;
    ``nan`` when the run never got there (e.g. diverged)."""
    hit = np.flatnonzero(res.loss_history <= target)
    return float(res.sim_times[hit[0]]) if len(hit) else float("nan")


def final_loss(res: FLResult) -> float:
    """Last FINITE entry of the loss history."""
    finite = res.loss_history[np.isfinite(res.loss_history)]
    return float(finite[-1]) if len(finite) else float("nan")


def _seed_rngs(seed: int):
    """Independent (holdout, round) rng streams.

    ``SeedSequence.spawn`` derives decorrelated child streams from one root
    seed, so the holdout permutation can NOT replay as the first round's
    client selection.
    """
    hold_ss, round_ss = np.random.SeedSequence(seed).spawn(2)
    return np.random.default_rng(hold_ss), np.random.default_rng(round_ss)


def _as_provider(data, fcfg: ForecasterConfig) -> windows.ClientWindowProvider:
    if isinstance(data, windows.ClientWindowProvider):
        return data
    # in-memory sources window each client at most once: the raw series are
    # already resident, and full-participation configs would thrash any
    # smaller LRU every round
    return windows.ClientWindowProvider.from_series(
        data, fcfg.lookback, fcfg.horizon, cache_size=len(data))


def run_federated_training(all_series, fcfg: ForecasterConfig,
                           flcfg: FLConfig, *, mesh=None,
                           log_every: int = 0, checkpoint_path=None,
                           init_params=None, cell_impl: str = "kernel",
                           device=None) -> Dict[int, FLResult]:
    """Full Alg. 1 via the round engine: optional client holdout, optional
    clustering, then per-cluster federated training.

    all_series: (N, T) raw kWh (one row per client), a ragged list of (T_i,)
    series, or a ``windows.ClientWindowProvider``; each round fetches,
    normalizes and windows ONLY the selected clients.  When
    ``flcfg.holdout_frac > 0`` that fraction of clients is excluded from
    training entirely (their indices are on every
    ``FLResult.heldout_clients``).  ``init_params``: one param tree (numpy
    or CPU tensors) for every cluster, or a dict from cluster id to tree;
    without it each cluster draws from ``seeded_generator(seed, cluster
    id)``.  ``cell_impl`` / ``device`` as in :class:`RoundEngine`.  Returns
    {cluster_id: FLResult}; cluster_id = -1 when clustering is off.
    """
    if checkpoint_path is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet: ROADMAP A10")
    provider = _as_provider(all_series, fcfg)
    holdout_rng, rng = _seed_rngs(flcfg.seed)
    engine = RoundEngine(fcfg, flcfg, mesh=mesh, cell_impl=cell_impl,
                         device=device)
    ccfg = flcfg.client_opt
    steps = partition.local_steps(provider.n_win_max, ccfg.batch_size,
                                  ccfg.local_epochs)

    n_total = provider.n_clients
    train_ids, held_ids = partition.holdout_clients(
        holdout_rng, n_total, flcfg.holdout_frac)
    if len(train_ids) == 0:
        raise ValueError(
            f"holdout_frac={flcfg.holdout_frac} leaves no training clients "
            f"(n_clients={n_total})")
    # Per-client sample counts: aggregation + sampling weights.
    counts = provider.train_counts.astype(np.float32)

    # -------- optional privacy-preserving clustering (server side, Alg. 1)
    if flcfg.n_clusters > 1:
        z = provider.daily_summary(train_ids, flcfg.cluster_days)
        cents, train_assigns, _ = clustering.kmeans(z, flcfg.n_clusters,
                                                    seed=flcfg.seed)
        groups = {cid: train_ids[m] for cid, m in
                  partition.cluster_partition(train_assigns).items()}
        # report assignments in FULL client index space (-1 = held out)
        assigns = np.full(n_total, -1, train_assigns.dtype)
        assigns[train_ids] = train_assigns
    else:
        cents, assigns = None, None
        groups = {-1: train_ids}

    one_tree = init_params is not None and not (
        isinstance(init_params, dict) and "layers" not in init_params)
    results: Dict[int, FLResult] = {}
    for cid, members in groups.items():
        if init_params is None:
            params, sstate = engine.init(
                seeded_generator(flcfg.seed, cid if cid >= 0 else 0))
        else:
            params, sstate = engine.init(
                params=init_params if one_tree else init_params[cid])
        engine.reset_pacing()          # per-cluster event clock
        hist, sim_hist, eps_hist = [], [], []
        m_sel = engine.dispatch_m(min(flcfg.clients_per_round, len(members)),
                                  len(members))
        engine.attach_accountant(len(members), m_sel)
        for t in range(flcfg.rounds):
            sel = engine.select(rng, members, m_sel, t, counts[members])
            bidx = partition.ragged_minibatch_indices(
                rng, counts[sel], steps, ccfg.batch_size)
            x, y, w = provider.round_batch(sel)
            params, sstate, l = engine.step(params, sstate, x, y, bidx, w,
                                            round_idx=t)
            hist.append(float(l))
            sim_hist.append(engine.sim_time)
            eps_hist.append(engine.accountant.epsilon())
            if log_every and (t + 1) % log_every == 0:
                print(f"[cluster {cid}] round {t+1}/{flcfg.rounds} "
                      f"loss {hist[-1]:.5f} sim_t {sim_hist[-1]:.1f}s")
        results[cid] = FLResult(forecaster.params_to_numpy(params),
                                np.array(hist), cents, assigns,
                                held_ids if len(held_ids) else None,
                                sim_times=np.array(sim_hist),
                                eps_history=np.array(eps_hist),
                                privacy=engine.accountant.report())
    return results


# ------------------------------------------------------------------ eval
class MetricAccumulator:
    """Streaming RMSE / MAPE / Accuracy (§4.5) over window batches.

    Accumulates sufficient statistics (Σ squared error, Σ APE, per-horizon
    Σ APE, counts) so million-window evaluations never hold predictions for
    more than one batch.  The APE epsilon is the shared
    ``losses.MAPE_EPS``.
    """

    def __init__(self, horizon: int):
        self.sse = 0.0
        self.ape_sum = np.zeros(horizon, np.float64)
        self.rows = 0

    def update(self, pred: np.ndarray, y: np.ndarray):
        """pred/y: (n, H) in the space metrics should be computed in."""
        d = (pred - y).astype(np.float64)
        self.sse += float((d * d).sum())
        ape = np.abs((y - pred) /
                     np.maximum(np.abs(y), losses_mod.MAPE_EPS))
        self.ape_sum += ape.sum(axis=0, dtype=np.float64)
        self.rows += pred.shape[0]

    def result(self) -> Dict[str, float]:
        if self.rows == 0:
            raise ValueError("no evaluation windows accumulated (empty ids "
                             "or 0-client provider)")
        h = len(self.ape_sum)
        mean_ape = self.ape_sum.sum() / (self.rows * h)
        per_h = 100.0 - 100.0 * self.ape_sum / self.rows
        return {
            "rmse": float(np.sqrt(self.sse / (self.rows * h))),
            "mape": float(100.0 * mean_ape),
            "accuracy": float(np.clip(100.0 - 100.0 * mean_ape, 0, 100)),
            "per_horizon_accuracy": np.clip(per_h, 0, 100),
        }


def _on_device(params, device):
    """A param tree (numpy arrays or tensors) on ``device`` (None: the
    card, raising without one)."""
    return tree_from_numpy(params, resolve_device(device))


def _predict_denorm(params, x, cfg, stats=None, batch: int = 8192,
                    cell_impl: str = "kernel"):
    """Predict a flat window batch in device sub-batches (params already on
    the device); de-normalize to kWh when per-row (lo, hi) ``stats`` are
    given.  Returns (pred, y-transform).

    Sub-batches are zero-padded up to the next power of two, as the JAX
    package pads them, so the layer kernel sees a bounded set of shapes.
    """
    dev = params["head"]["w"].device
    n = x.shape[0]
    preds = []
    with torch.inference_mode():
        for i in range(0, n, batch):
            xb = x[i:i + batch]
            nb = xb.shape[0]
            nb_pad = 1 << max(nb - 1, 0).bit_length()  # next power of two
            if nb_pad > nb:
                xb = np.concatenate(
                    [xb, np.zeros((nb_pad - nb,) + xb.shape[1:], xb.dtype)])
            xt = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
            preds.append(forecaster.forecast(params, xt, cfg, cell_impl)
                         .cpu().numpy()[:nb])
    pred = np.concatenate(preds)
    if stats is None:
        return pred, lambda y: y
    return (windows.denormalize(pred, stats),
            lambda y: windows.denormalize(y, stats))


def evaluate_global(params, x_test: np.ndarray, y_test: np.ndarray,
                    cfg: ForecasterConfig, stats=None, batch: int = 8192, *,
                    cell_impl: str = "kernel", device=None
                    ) -> Dict[str, float]:
    """Evaluate on (possibly huge) held-out window sets, streamed in batches.

    x_test: (n, L, 1); y_test: (n, H) — normalized per building.  ``stats`` is
    the per-row (lo, hi) min/max pair (broadcastable to (n, 1)); when given,
    MAPE/Accuracy are computed in DE-normalized kWh space, as the paper does.
    ``params``: numpy arrays (an ``FLResult.params``) or tensors; they run
    on ``device`` (None: the card).
    Returns RMSE / MAPE / Accuracy (§4.5) + per-horizon accuracy (Table 4).
    """
    acc = MetricAccumulator(cfg.horizon)
    pred, to_space = _predict_denorm(_on_device(params, device), x_test, cfg,
                                     stats, batch, cell_impl)
    acc.update(pred, to_space(y_test))
    return acc.result()


def evaluate_unseen_clients(params, series, cfg: ForecasterConfig,
                            batch: int = 8192, ids=None,
                            clients_per_chunk: int = 64, *,
                            cell_impl: str = "kernel", device=None
                            ) -> Dict[str, float]:
    """Unseen-CLIENT generalization (paper §5.4): run the full windowing
    pipeline on buildings never seen in training and score their *test*
    windows in kWh space.  ``series`` is (n_held, T) raw kWh, a ragged list,
    or a ``ClientWindowProvider`` (then ``ids`` restricts which clients to
    score).  Clients stream through in chunks."""
    provider = _as_provider(series, cfg)
    params = _on_device(params, device)
    acc = MetricAccumulator(cfg.horizon)
    for x, y, stats in provider.iter_test_flat(ids, clients_per_chunk):
        pred, to_space = _predict_denorm(params, x, cfg, stats, batch,
                                         cell_impl)
        acc.update(pred, to_space(y))
    return acc.result()
