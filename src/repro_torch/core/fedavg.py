"""Federated round engine (paper Alg. 1, generalized): the counterpart of
``src/repro/core/fedavg.py``.

    select -> local-update -> transform(deltas) -> aggregate -> server-update

*select* picks the round's participants (``core/sampling.py``); every
selected client runs ``ClientUpdate`` — E local epochs of minibatch SGD,
optionally FedProx-regularized (``core/client.py``) — all M of them at once,
each step's forward one launch of the CUDA layer kernel per layer with the
clients on its grid; *transform* passes each client's delta
``w_i - w_global`` through the privacy stack — L2 clip, Gaussian DP noise,
stochastic int quantize (``core/transforms.py``) and pairwise masking
(``core/secure_agg.py``) — with keys from the seed, the cluster (``stream``),
the round and the slot (``core/prng.py``, the JAX package's keys bit for
bit); *aggregate* is the sample-count-weighted (or uniform) average of the
local models under the identity stack, or ``w_global`` plus the average of
the transformed deltas (unweighted sums of pre-weighted uploads, decoded
from the ring when the stack quantizes onto it), its sums reduced through
a topology (``core/aggregation.py``: local, flat, or hierarchical
edge->region->cloud over ``torch.distributed`` ranks, each rank running
its own block of the clients); the server then applies a *server
optimizer* to the pseudo-gradient ``w_global - w_agg``
(``core/server_opt.py``), the same step on every rank.

Round PACING is orthogonal to the stages: ``FLConfig.mode`` selects
synchronous rounds (the slowest selected client gates the round on the
simulated clock, ``core/latency.py``) or semi-synchronous buffered rounds
(``core/async_engine.py``: over-select, flush at the ``buffer_k``-th
arrival, fold stragglers later with staleness-discounted weights, with
client churn and cohort re-keying); ``FLResult.sim_times`` reports the
simulated clock either way.  The (eps, delta) accountant
(``core/privacy.py``) prices every round, per client or, for ring-masked
uniform aggregation, centrally on the masked sum.
``run_federated_training`` checkpoints the whole engine state and resumes
from it bit for bit, in the JAX package's checkpoint format.

Params live on the device as trees of tensors; ``FLResult.params`` comes
back as host numpy arrays, the JAX package's tree layout, which
``checkpoint.save`` and ``serving.ModelRegistry.publish`` take as they are.
Initial params are drawn from a ``torch.Generator`` seeded from
``(seed, cluster id)``, or given through
``run_federated_training(init_params=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as checkpoint_mod
from repro_torch.analysis import taint as taint_mod
from repro_torch.configs.base import (FLConfig, ForecasterConfig,
                                      SecureAggConfig, TransformConfig)
from repro_torch.core import aggregation as aggregation_mod
from repro_torch.core import async_engine
from repro_torch.core import clustering, losses as losses_mod
from repro_torch.core import latency as latency_mod
from repro_torch.core import privacy as privacy_mod
from repro_torch.core import prng
from repro_torch.core import sampling as sampling_mod
from repro_torch.core import secure_agg as secure_agg_mod
from repro_torch.core import server_opt as server_opt_mod
from repro_torch.core import transforms as transforms_mod
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
def apply_stack(stack, deltas, keys, *, slots=None, w_full=None,
                round_key=None):
    """Transform a client-stacked delta tree through ``stack``, every client
    at once (``keys``: (M, 2) per-client keys).

    Cohort-aware stacks (the ring quantizer, secure aggregation) also take
    each client's :class:`~repro_torch.core.secure_agg.CohortContext`: its
    dispatch slot (default: its row), the cohort's weight vector and the
    shared round key.
    """
    if not stack.needs_cohort:
        return stack(deltas, keys)
    if round_key is None:
        raise ValueError("cohort-aware transform stack needs the shared "
                         "round_key (engine.base_round_key)")
    if w_full is None:
        raise ValueError("cohort-aware transform stack needs the cohort "
                         "weight vector w_full")
    if slots is None:
        slots = torch.arange(w_full.shape[0], device=w_full.device)
    return stack(deltas, keys,
                 secure_agg_mod.CohortContext(slots, w_full, round_key))


def transform_and_aggregate(params, locals_, client_loss, weights, keys,
                            stack, round_key=None, *,
                            agg: "aggregation_mod.Aggregator" =
                            aggregation_mod.LocalAggregator(),
                            slots=None, w_full=None):
    """The transform -> aggregate stages of one round, from the local
    models (client-stacked) and each client's mean local loss (M,).

    With the identity stack the raw local models are averaged through
    :func:`_weighted_sums`.  Otherwise each client's delta ``w_i - w_global``
    goes through ``stack`` and the aggregate is ``w_global`` plus the
    average of the transformed deltas.  Pre-weighted stacks (ring quantizer
    and/or masker) already carry each client's weight share in its upload,
    so their uploads are summed UNWEIGHTED; on the ring the sum is wrapped
    into the centered ring and decoded through the public grid step:
    ``params + scale * wrap(sum of uploads)``.

    Every sum goes through ``agg.reduce`` (a linear sum over ranks; the
    identity without a mesh), so one implementation serves every topology.
    On a rank mesh ``locals_`` / ``weights`` / ``keys`` are this rank's
    block of the cohort, ``slots`` its clients' global dispatch slots and
    ``w_full`` the whole cohort's weight vector (default: ``weights``).
    Returns ``(w_agg, weighted mean client loss)``.
    """
    if stack.is_identity:
        sums, wsum_local = _weighted_sums(locals_, weights)
        wsum = agg.reduce(wsum_local)
        w_agg = tree_map(lambda s: agg.reduce(s) / wsum, sums)
    else:
        deltas = tree_map(lambda l, g: l - g, locals_, params)
        w_cohort = weights if w_full is None else w_full
        deltas = apply_stack(stack, deltas, keys, slots=slots,
                             w_full=w_cohort, round_key=round_key)
        if stack.pre_weighted:
            sums = tree_map(lambda d: d.sum(0), deltas)
            wsum = agg.reduce(weights.sum())
            ring = stack.ring_spec
            if ring is not None:
                bits, sensitivity, headroom = ring
                scale = transforms_mod.ring_scale(bits, sensitivity,
                                                  w_cohort.shape[0], headroom)
                w_agg = tree_map(
                    lambda g, s: g + scale * transforms_mod.ring_wrap(
                        agg.reduce(s), bits), params, sums)
            else:
                w_agg = tree_map(lambda g, s: g + agg.reduce(s) / wsum,
                                 params, sums)
        else:
            sums, wsum_local = _weighted_sums(deltas, weights)
            wsum = agg.reduce(wsum_local)
            w_agg = tree_map(lambda g, s: g + agg.reduce(s) / wsum,
                             params, sums)
    loss_mean = agg.reduce((weights * client_loss).sum()) / wsum
    return w_agg, loss_mean


def pipeline_round(params, x, y, batch_idx, weights, keys, lr, prox_mu,
                   cfg: ForecasterConfig, loss: Callable,
                   tcfg: TransformConfig = TransformConfig(),
                   cell_impl: str = "kernel",
                   scfg: Optional[SecureAggConfig] = None, round_key=None,
                   *, agg: "aggregation_mod.Aggregator" =
                   aggregation_mod.LocalAggregator(),
                   slots=None, w_full=None):
    """Full pipeline round: every client's local update, then
    :func:`transform_and_aggregate` under the stack of ``tcfg`` (+
    ``scfg``).  ``keys``: (M, 2) per-client transform keys (unused by the
    identity stack); ``round_key``: the cohort's shared key (cohort-aware
    stacks); ``agg`` / ``slots`` / ``w_full``: the topology and this rank's
    place in the cohort (see :func:`transform_and_aggregate`).  Returns
    ``(w_agg, weighted mean client loss)``; the server stage is applied by
    the caller (``RoundEngine.step``)."""
    locals_, client_loss = local_update(params, x, y, batch_idx, lr, cfg,
                                        loss, cell_impl, prox_mu)
    # taint source (production no-op): the local models, and the deltas
    # made from them, are the private values flcheck follows to the
    # aggregation boundary.  client_loss is NOT tagged: the weighted scalar
    # loss release is the accepted disclosure
    locals_ = taint_mod.tag_private(locals_)
    with torch.no_grad():
        return transform_and_aggregate(
            params, locals_, client_loss, weights, keys,
            transforms_mod.make_stack(tcfg, scfg), round_key, agg=agg,
            slots=slots, w_full=w_full)


def fedavg_round(params, x, y, batch_idx, lr, cfg: ForecasterConfig,
                 loss: Callable, cell_impl: str = "kernel"):
    """One uniform-FedAvg round over M clients: every client's local update,
    then the plain mean of the local models.  x: (M, n_win, L, 1); y: (M,
    n_win, H); batch_idx: (M, steps, B).  Returns ``(w_agg, mean client
    loss)``; :func:`pipeline_round` with unit weights and the identity
    stack."""
    ones = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    return pipeline_round(params, x, y, batch_idx, ones, None, lr, 0.0, cfg,
                          loss, cell_impl=cell_impl)


def engine_round(params, x, y, batch_idx, weights, lr, prox_mu,
                 cfg: ForecasterConfig, loss: Callable,
                 cell_impl: str = "kernel"):
    """Weighted aggregation with optional FedProx clients: ``weights`` (M,)
    are the aggregation weights (sample counts; ones for uniform),
    ``prox_mu`` the proximal strength (0 = plain local SGD).  Returns
    ``(w_agg, weighted mean client loss)``; the server step is the
    caller's.  :func:`pipeline_round` with the identity stack."""
    return pipeline_round(params, x, y, batch_idx, weights, None, lr,
                          prox_mu, cfg, loss, cell_impl=cell_impl)


# ------------------------------------------------------------- round engine
class RoundEngine:
    """Composable federated round: select -> local update -> transform ->
    aggregate -> server update::

        engine = RoundEngine(fcfg, flcfg)          # the card; or device="cpu"
        params, state = engine.init(seeded_generator(flcfg.seed, 0))
        sel = engine.select(rng, members, m, round_idx, member_weights)
        params, state, loss = engine.step(params, state, x[sel], y[sel],
                                          bidx, counts[sel], round_idx)

    ``cell_impl`` picks the forward of every local step: ``"kernel"`` (the
    CUDA layer kernels, the default) or ``"torch"`` (the plain cells).
    ``device`` defaults to the card and raises without one; ``"cpu"`` runs
    the plain versions, only when the caller asks.  ``audited_payload``
    (the per-client upload bytes of flcheck's cost audit,
    ``analysis/costs.py``) replaces the latency model's byte formula.

    ``mesh`` (``aggregation.make_mesh``): every rank of the mesh builds the
    same engine and calls ``step`` with the same global round inputs; each
    runs its contiguous block of the M clients and reduces through the
    topology of ``FLConfig.aggregation``, and every rank applies the same
    server step.  Hierarchical aggregation needs a mesh with the
    ``(region, clients)`` axis pair.
    """

    def __init__(self, fcfg: ForecasterConfig, flcfg: FLConfig, *,
                 loss: Optional[Callable] = None, mesh=None,
                 cell_impl: str = "kernel", device=None,
                 audited_payload: Optional[float] = None):
        if cell_impl not in forecaster.CELL_IMPLS:
            raise ValueError(f"cell_impl={cell_impl!r}; pick from "
                             f"{forecaster.CELL_IMPLS}")
        # stage names/knobs were validated eagerly by the FLConfig facade
        self.fcfg, self.flcfg = fcfg, flcfg
        ccfg = flcfg.client_opt
        self.loss = loss if loss is not None else losses_mod.make_loss(
            ccfg.loss, ccfg.beta)
        self.mesh, self.cell_impl = mesh, cell_impl
        self.device = resolve_device(device)
        self.sampler = sampling_mod.make_sampler(flcfg.sampling_config)
        # proximal term only under fedprox (prox_mu is ignored otherwise)
        self.prox_mu = ccfg.prox_mu if flcfg.server_opt == "fedprox" else 0.0
        self.weighted = server_opt_mod.uses_weighted_aggregation(flcfg)
        self.transform = flcfg.transform
        # secure aggregation (pairwise masking) + privacy accounting
        self.secure = flcfg.secure if flcfg.secure.enabled else None
        self.stack = transforms_mod.make_stack(self.transform, self.secure)
        self.accountant: Optional[privacy_mod.PrivacyAccountant] = None
        if mesh is None and flcfg.aggregation_config.kind != "flat":
            raise ValueError(
                f"aggregation={flcfg.aggregation!r} requires a mesh (build "
                "one with aggregation.make_mesh); without one there is no "
                "reduction topology")
        self.agg = aggregation_mod.make_aggregator(flcfg.aggregation_config,
                                                   mesh)
        # ---- round pacing (sync vs semi-sync buffered) -------------------
        # the latency model is host-side only: under mode="sync" it just
        # tracks a simulated wall clock and never touches the round math
        self.async_cfg = flcfg.async_config
        self.latency = latency_mod.LatencyModel(
            self.async_cfg.latency, flcfg.seed,
            latency_mod.payload_bytes(fcfg.num_params(), flcfg.quantize_bits,
                                      audited_bytes=audited_payload),
            churn=flcfg.churn)
        self.async_state = async_engine.SemiSyncState()
        if self.async_cfg.mode == "semi_sync":
            m_prime = self.dispatch_m(flcfg.clients_per_round)
            # buffer_frac resolves per round in semi_sync_step; buffer_k is
            # absolute (0 = wait for all dispatched)
            self.buffer_k = self.async_cfg.buffer_k or m_prime
            if self.async_cfg.buffer_k > m_prime:
                raise ValueError(
                    f"buffer_k={self.buffer_k} exceeds the dispatch size "
                    f"m'={m_prime} (= ceil(over_select * clients_per_round))"
                    " — the flush could never trigger; use buffer_frac for "
                    "a threshold relative to the actual round size")
        else:
            self.buffer_k = 0

    def dispatch_m(self, m: int, n_members: Optional[int] = None) -> int:
        """Per-round dispatch size: ``m`` under sync, the over-selected
        ``m' = ceil(over_select * m)`` (capped at the membership) under
        semi-sync."""
        if self.async_cfg.mode != "semi_sync":
            return m
        m_prime = int(np.ceil(self.async_cfg.over_select * m))
        return m_prime if n_members is None else min(m_prime, n_members)

    @property
    def sim_time(self) -> float:
        """Simulated wall-clock seconds consumed so far (event clock)."""
        return self.async_state.clock

    def reset_pacing(self) -> None:
        """Drop buffered stragglers and rewind the simulated clock (call
        between independent trainings, e.g. per cluster)."""
        self.async_state.reset()

    def _block(self, m: int):
        """``(lo, hi)``: the rows of an M-client round this rank runs (all
        of them without a mesh)."""
        if self.mesh is None:
            return 0, m
        n = self.mesh.size
        if m % n:
            raise ValueError(
                f"{m} clients do not split over the mesh's {n} ranks; pad "
                "the selection with weight-0 duplicates (as "
                "run_federated_training does)")
        b = m // n
        return self.mesh.index * b, (self.mesh.index + 1) * b

    def _rows(self, a, lo: int, hi: int) -> torch.Tensor:
        """Rows ``lo:hi`` of a round input (numpy or tensor) on the
        engine's device."""
        if isinstance(a, torch.Tensor):
            return a[lo:hi].to(self.device)
        return torch.as_tensor(np.asarray(a)[lo:hi], device=self.device)

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

    def base_round_key(self, round_idx: int, stream: int = 0):
        """The dispatch cohort's SHARED round key ``fold_in(fold_in(
        PRNGKey(seed), stream), round)`` (a Python key): the pairwise masks
        are a pure function of it and the slot pair."""
        rk = prng.fold_in(prng.PRNGKey(self.flcfg.seed), stream)
        return prng.fold_in(rk, round_idx)

    def rekey_key(self, round_idx: int, stream: int = 0,
                  generation: int = 0):
        """The shared cohort key at dropout-recovery generation ``g``:
        generation 0 is ``base_round_key``; after a timeout the survivors
        re-mask under ``fold_in(fold_in(base, _REKEY_DOMAIN), g)``."""
        rk = self.base_round_key(round_idx, stream)
        if generation == 0:
            return rk
        return prng.fold_in(prng.fold_in(rk, secure_agg_mod._REKEY_DOMAIN),
                            generation)

    def round_keys(self, round_idx: int, m: int, stream: int = 0):
        """Per-client transform keys of one round, (m, 2) on the engine's
        device: ``fold_in(base_round_key, slot)``.  ``stream`` (the driver
        passes the cluster id) keeps two clusters' round-t slot-i clients
        from drawing the same DP noise."""
        return prng.fold_in(self.base_round_key(round_idx, stream),
                            torch.arange(m, device=self.device))

    def attach_accountant(self, n_members: int, dispatch_m: int) -> None:
        """(Re)bind the (eps, delta) accountant for one training run:
        sampling rate ``q = dispatch_m / n_members``.

        With secure aggregation the central (``central:secure-agg``)
        accountant prices the masked sum when the protocol reduces the
        server's view to the uniform cohort sum: RING masking and uniform
        aggregation (``privacy.central_gate_reason``).  Otherwise the
        per-client accountant stands, with the reason as
        ``central_fallback_reason``.  Without clip and noise the accountant
        is disabled and reports ``epsilon = inf``.
        """
        q = min(1.0, dispatch_m / max(n_members, 1))
        if self.secure is not None:
            gate = privacy_mod.central_gate_reason(
                ring=self.stack.ring_spec is not None, weighted=self.weighted)
            if gate is None:
                self.accountant = privacy_mod.secure_agg_accountant(
                    self.transform, self.flcfg.privacy, q,
                    secure_enabled=True, cohort=dispatch_m)
                return
            self.accountant = privacy_mod.make_accountant(
                self.transform, self.flcfg.privacy, q)
            self.accountant.central_fallback_reason = gate
            return
        self.accountant = privacy_mod.make_accountant(
            self.transform, self.flcfg.privacy, q)

    def step(self, params, state, x, y, batch_idx, weights,
             round_idx: int = 0, stream: int = 0):
        """One full round on already-selected client data.

        x: (M, n_win, L, 1); y: (M, n_win, H); batch_idx: (M, steps, B),
        numpy arrays or tensors; weights: (M,) per-client sample counts —
        zero marks padding duplicates, which are excluded from aggregation
        AND loss on both the uniform and weighted paths, and upload zero
        under masking.  ``round_idx`` / ``stream`` key the transforms.
        Returns ``(new params, new server state, round loss)``.

        Dispatches on ``FLConfig.mode``: ``sync`` waits for every client
        (the slowest client's simulated latency advances the clock);
        ``semi_sync`` routes through the staleness-weighted buffered server
        (``core/async_engine.py``), where M is the over-selected ``m'``.
        """
        if self.accountant is not None:
            # one dispatch = one subsampled-Gaussian invocation; the central
            # accountant prices the sum at the REAL client count
            self.accountant.observe_cohort(
                int((np.asarray(weights) > 0).sum()))
            self.accountant.step()
        if self.async_cfg.mode == "semi_sync":
            return async_engine.semi_sync_step(
                self, params, state, x, y, batch_idx, weights, round_idx,
                stream)
        w_np = np.asarray(weights, np.float32)
        real = np.flatnonzero(w_np > 0)
        times = self.latency.times(round_idx, w_np[real],
                                   self.flcfg.client_opt.local_epochs,
                                   slots=real)
        self.async_state.clock += float(times.max(initial=0.0))
        return self._sync_step(params, state, x, y, batch_idx, weights,
                               round_idx, stream)

    def _sync_step(self, params, state, x, y, batch_idx, weights,
                   round_idx: int = 0, stream: int = 0):
        """The synchronous fused round (select-free part of paper Alg. 1);
        also the semi-sync fast path when a flush is a complete, fresh
        dispatch set.  On a mesh this rank runs its block of the clients,
        masking against the whole cohort (global ``slots``, the full weight
        vector and the shared round key), and reduces through ``agg``."""
        dev = self.device
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        if not self.weighted:             # uniform aggregation (pads stay 0)
            w = (w > 0).float()
        m = w.shape[0]
        lo, hi = self._block(m)
        x, y, batch_idx = (self._rows(a, lo, hi) for a in (x, y, batch_idx))
        keys = rk = None
        if not self.stack.is_identity:
            keys = self.round_keys(round_idx, m, stream)[lo:hi]
            rk = self.base_round_key(round_idx, stream)
        slots = None if self.mesh is None else torch.arange(lo, hi,
                                                            device=dev)
        w_agg, loss = pipeline_round(params, x, y, batch_idx, w[lo:hi], keys,
                                     self.flcfg.lr, self.prox_mu, self.fcfg,
                                     self.loss, self.transform,
                                     self.cell_impl, self.secure, rk,
                                     agg=self.agg, slots=slots, w_full=w)
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


def _restore_async_state(flat, n_pending: int, params):
    """Rebuild a ``SemiSyncState`` from a checkpoint's flat array view
    (keys under ``cur/async/``); ``params`` supplies the delta tree
    structure (a buffered delta has exactly the param tree's shape)."""
    delta_like = tree_map(lambda t: t.detach().cpu(), params)

    def arr(key):
        return flat[key].numpy()

    tree = {
        "clock": arr("cur/async/clock"),
        "counters": arr("cur/async/counters"),
        "pending": [
            {"delta": tree_map(lambda t: t.numpy(),
                               checkpoint_mod.unflatten_like(
                                   delta_like, flat,
                                   prefix=f"cur/async/pending/{i}/delta/")),
             "scalars": arr(f"cur/async/pending/{i}/scalars")}
            for i in range(n_pending)],
        "cohort_rounds": arr("cur/async/cohort_rounds"),
        "cohort_sizes": arr("cur/async/cohort_sizes"),
        "cohort_gens": arr("cur/async/cohort_gens"),
        "cohort_w": arr("cur/async/cohort_w"),
    }
    # dispatch-time weight sums (ring-decode geometry); absent in
    # pre-ring checkpoints: from_tree then falls back to sum(cohort_w)
    if "cur/async/cohort_W0" in flat:
        tree["cohort_W0"] = arr("cur/async/cohort_W0")
    return async_engine.SemiSyncState.from_tree(tree)


def run_federated_training(all_series, fcfg: ForecasterConfig,
                           flcfg: FLConfig, *, mesh=None,
                           log_every: int = 0, checkpoint_path=None,
                           checkpoint_every: int = 1, resume: bool = True,
                           stop_after_rounds: Optional[int] = None,
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
    id)``.  ``cell_impl`` / ``device`` as in :class:`RoundEngine`.

    ``mesh`` (``aggregation.make_mesh``): every rank calls this with the
    same arguments and runs its block of each round's clients; the
    selection is padded up to a multiple of the mesh size with cycled
    weight-0 duplicates.  ``aggregation="hierarchical"`` without a mesh
    builds one over the initialised process group (one rank without one).
    Churn (``absent_prob``): absent members sit a round out.

    **Checkpoint/resume** (``checkpoint_path``): every ``checkpoint_every``
    rounds the full engine state (params, server moments, the semi-sync
    buffer and its cohort books, the event clock, the accountant, the
    round rng, finished clusters) is written to one ``.npz`` in the JAX
    package's format (the mesh's first rank writes it); an existing
    checkpoint of the same ``FLConfig`` resumes the run (``resume``) and
    reproduces the rest of the loss / eps / sim histories bit for bit.
    ``stop_after_rounds`` ends the call after that many executed rounds
    (the returned dict then holds the partial current cluster).  Returns
    {cluster_id: FLResult}; cluster_id = -1 when clustering is off.
    """
    provider = _as_provider(all_series, fcfg)
    holdout_rng, rng = _seed_rngs(flcfg.seed)
    if mesh is None and flcfg.aggregation_config.kind != "flat":
        mesh = aggregation_mod.make_mesh(flcfg.aggregation_config)
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
    n_dev = 1 if mesh is None else mesh.size

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

    # -------- resume: load the full engine snapshot when one exists
    ckpt_flat = ckpt_meta = None
    if checkpoint_path is not None and resume and \
            checkpoint_mod._normalize(checkpoint_path).exists():
        ckpt_flat, ckpt_meta = checkpoint_mod.load_arrays(checkpoint_path)
        if ckpt_meta.get("flcfg") != repr(flcfg):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written by a different "
                "FLConfig — resuming would silently change the run; delete "
                "it or pass resume=False")
    writer = mesh is None or mesh.index == 0

    results: Dict[int, FLResult] = {}
    # finished clusters' accountant states (the central accountant's min
    # observed cohort is run history, so resume restores it)
    done_acct: Dict[int, Dict] = {}
    executed = 0

    def _save(cid, params, sstate, hist, sim_hist, eps_hist, t_done):
        tree = {
            "cur": {"params": params,
                    "server": {"m": sstate.m, "v": sstate.v,
                               "t": np.asarray(sstate.t, np.int32)},
                    "async": engine.async_state.to_tree(),
                    "hist": np.asarray(hist, np.float64),
                    "sim": np.asarray(sim_hist, np.float64),
                    "eps": np.asarray(eps_hist, np.float64)},
            "done": {str(dc): {
                "params": results[dc].params,
                "hist": np.asarray(results[dc].loss_history, np.float64),
                "sim": np.asarray(results[dc].sim_times, np.float64),
                "eps": np.asarray(results[dc].eps_history, np.float64)}
                for dc in results},
        }
        meta = {"version": 1, "flcfg": repr(flcfg), "cluster": int(cid),
                "rounds_done": int(t_done),
                # publish generation for serving-registry pollers: the
                # GLOBAL executed-round counter, monotone across clusters
                "generation": int(executed),
                "done": [int(dc) for dc in results],
                "rng": rng.bit_generator.state,
                "accountant": engine.accountant.state_dict(),
                "done_accountants": {str(dc): done_acct[dc]
                                     for dc in results},
                "n_pending": len(engine.async_state.pending)}
        checkpoint_mod.save(checkpoint_path, tree, metadata=meta)

    one_tree = init_params is not None and not (
        isinstance(init_params, dict) and "layers" not in init_params)
    for cid, members in groups.items():
        if init_params is None:
            params, sstate = engine.init(
                seeded_generator(flcfg.seed, cid if cid >= 0 else 0))
        else:
            params, sstate = engine.init(
                params=init_params if one_tree else init_params[cid])
        engine.reset_pacing()          # per-cluster event clock + buffer
        hist, sim_hist, eps_hist = [], [], []
        m = min(flcfg.clients_per_round, len(members))
        # semi-sync over-selects m' >= m; sync dispatches exactly m
        m_sel = engine.dispatch_m(m, len(members))
        engine.attach_accountant(len(members), m_sel)
        t0 = 0
        if ckpt_meta is not None and int(cid) in ckpt_meta["done"]:
            # finished before the kill: rebuild its result from the snapshot
            pref = f"done/{cid}/"
            engine.accountant.load_state(
                ckpt_meta.get("done_accountants", {}).get(
                    str(cid), {"rounds": flcfg.rounds}))
            done_acct[cid] = engine.accountant.state_dict()
            results[cid] = FLResult(
                forecaster.params_to_numpy(checkpoint_mod.unflatten_like(
                    params, ckpt_flat, prefix=pref + "params/")),
                ckpt_flat[pref + "hist"].numpy(),
                cents, assigns, held_ids if len(held_ids) else None,
                sim_times=ckpt_flat[pref + "sim"].numpy(),
                eps_history=ckpt_flat[pref + "eps"].numpy(),
                privacy=engine.accountant.report())
            continue
        if ckpt_meta is not None and int(cid) == int(ckpt_meta["cluster"]):
            # mid-cluster kill point: restore the live engine state and the
            # round rng, then continue the round loop where it stopped
            params = checkpoint_mod.unflatten_like(params, ckpt_flat,
                                                   prefix="cur/params/")
            sstate = server_opt_mod.ServerState(
                m=checkpoint_mod.unflatten_like(sstate.m, ckpt_flat,
                                                prefix="cur/server/m/"),
                v=checkpoint_mod.unflatten_like(sstate.v, ckpt_flat,
                                                prefix="cur/server/v/"),
                t=int(ckpt_flat["cur/server/t"]))
            engine.async_state = _restore_async_state(
                ckpt_flat, int(ckpt_meta["n_pending"]), params)
            engine.accountant.load_state(ckpt_meta["accountant"])
            rng.bit_generator.state = ckpt_meta["rng"]
            hist = [float(v) for v in ckpt_flat["cur/hist"]]
            sim_hist = [float(v) for v in ckpt_flat["cur/sim"]]
            eps_hist = [float(v) for v in ckpt_flat["cur/eps"]]
            t0 = int(ckpt_meta["rounds_done"])
        if (engine.async_cfg.mode == "semi_sync"
                and engine.async_cfg.buffer_k >= m_sel > 0
                and engine.async_cfg.buffer_k):
            print(f"[cluster {cid}] semi_sync: buffer_k="
                  f"{engine.async_cfg.buffer_k} >= dispatch size {m_sel} — "
                  "every flush waits for all (sync pacing); use buffer_frac "
                  "for a round-size-relative threshold")
        # mesh divisibility: round UP and pad the selection with cycled
        # duplicates of weight 0, so the math is unchanged
        m_run = -(-m_sel // n_dev) * n_dev
        stopped = False
        for t in range(t0, flcfg.rounds):
            # membership churn: absent members sit this round out (a pure
            # function of (seed, round, client id)); a wholly absent
            # cluster falls back to full membership.  Shapes stay at m_run:
            # a smaller selection just grows the zero-weight padding.
            avail = members
            if engine.latency.churn.absent_prob > 0.0:
                mask = engine.latency.available(t, members)
                if mask.any():
                    avail = members[mask]
            sel = engine.select(rng, avail, min(m_sel, len(avail)), t,
                                counts[avail])
            bidx = partition.ragged_minibatch_indices(
                rng, counts[sel], steps, ccfg.batch_size)
            pad_idx = np.resize(np.arange(len(sel)), m_run)
            x, y, c_sel = provider.round_batch(sel[pad_idx])
            w = c_sel.copy()
            w[len(sel):] = 0.0                        # mask padding clients
            params, sstate, l = engine.step(params, sstate, x, y,
                                            bidx[pad_idx], w, round_idx=t,
                                            stream=cid if cid >= 0 else 0)
            hist.append(float(l))
            sim_hist.append(engine.sim_time)
            eps_hist.append(engine.accountant.epsilon())
            if log_every and (t + 1) % log_every == 0:
                eps = eps_hist[-1]
                eps_s = f" eps {eps:.2f}" if np.isfinite(eps) else ""
                print(f"[cluster {cid}] round {t+1}/{flcfg.rounds} "
                      f"loss {hist[-1]:.5f} sim_t {sim_hist[-1]:.1f}s{eps_s}")
            executed += 1
            stopped = (stop_after_rounds is not None
                       and executed >= stop_after_rounds)
            if checkpoint_path is not None and writer and (
                    (t + 1) % max(checkpoint_every, 1) == 0
                    or t + 1 == flcfg.rounds or stopped):
                _save(cid, params, sstate, hist, sim_hist, eps_hist, t + 1)
            if stopped:
                break
        results[cid] = FLResult(forecaster.params_to_numpy(params),
                                np.array(hist), cents, assigns,
                                held_ids if len(held_ids) else None,
                                sim_times=np.array(sim_hist),
                                eps_history=np.array(eps_hist),
                                privacy=engine.accountant.report())
        done_acct[cid] = engine.accountant.state_dict()
        if stopped:
            break
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
