"""Semi-synchronous buffered rounds (``AsyncConfig``, ``FLConfig.mode``):
the counterpart of ``src/repro/core/async_engine.py``.

Synchronous FedAvg waits for every selected client, so the slowest straggler
gates each round.  The semi-sync engine (FedBuff-style, Nguyen et al. 2022)
instead:

1. **over-selects** ``m' = ceil(over_select * m)`` clients per round and
   dispatches them at the current simulated clock (``core/latency.py``
   assigns each a finish time: compute ∝ windows x epochs, uplink ∝
   post-quantize payload, a straggler multiplier);
2. **flushes** the aggregate as soon as the first ``buffer_k`` pending
   updates arrive: the event clock advances to the buffer_k-th finish
   time, never to the straggler's;
3. **folds late arrivals** into whichever later round they land in, with
   staleness-discounted weights ``w_i * (1 + tau_i)^(-alpha)`` (tau =
   rounds late).  A stale delta was computed against the *dispatch-round*
   params, so the buffer stores deltas, already run through the
   per-client transform stack AT DISPATCH with the dispatch-round keys, and
   the fold is ``w <- w + sum(w_tilde_i * delta_i) / sum(w_tilde_i)``
   through the pipeline's own ``fedavg._weighted_sums``.

When a flush holds exactly this round's dispatch set and nothing is
buffered (always so for ``buffer_k = m'`` with zero-jitter latency) the
step is the engine's fused synchronous round, so that configuration is
bit-identical to ``mode="sync"``.

The buffer lives on the host as numpy arrays, as in the reference (the
deltas come off the device once, at dispatch), so a checkpoint writes it
as it is.  On a rank mesh each rank computes its block of the dispatch and
one ``all_gather`` gives every rank the whole dispatch, so every rank holds
the same buffer and runs the same host schedule.

**Secure aggregation** (``SecureAggConfig``, ``AsyncConfig.cohort_atomic``):
pairwise masks are applied at dispatch under the DISPATCH round's shared
key and cancel only over a complete dispatch cohort, so folds are
cohort-ATOMIC: a round's updates wait until every member of its dispatch
set has arrived, then fold as one group with one staleness discount.  A
flush whose clock completes no cohort advances time without a server step
(``SemiSyncState.empty_flushes``).

**Failure injection** (``ChurnConfig``): with ``dropout_prob > 0`` some
uploads are lost mid-flight (``finish_time = inf``, replayable per
``(seed, round, slot)``).  The timeout sweep (:func:`_handle_timeouts`)
runs at the top of every step: plain semi-sync retries the client's
retained delta (uplink-only cost, up to ``max_retries``); cohort-atomic
folds RE-KEY the whole cohort (Bonawitz-style): unarrived members are
abandoned and the arrived survivors re-mask under the next key generation
restricted to the surviving slots, through
``secure_agg.mask_contribution``, without the server ever holding a
pre-mask delta.  With ``dropout_prob == 0`` none of this runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.configs.base import (AsyncConfig, ForecasterConfig,
                                      SecureAggConfig, TransformConfig)
from repro_torch.core import secure_agg as secure_agg_mod
from repro_torch.core import server_opt as server_opt_mod
from repro_torch.core import transforms as transforms_mod
from repro_torch.core.client import local_update
from repro_torch.models.layers import (sorted_leaves, tree_from_numpy,
                                       tree_map, unflatten_sorted)

PyTree = Any


def staleness_discount(tau, alpha: float):
    """Weight multiplier for an update arriving ``tau`` rounds late:
    ``(1 + tau)^(-alpha)`` in float64.  Non-increasing in tau (at an
    ``alpha`` below the float64 ulp of ``log(1 + tau)`` every tau rounds
    to 1.0); ``alpha = 0`` disables the discount; a fresh update (tau = 0)
    is never discounted."""
    return (1.0 + np.asarray(tau, np.float64)) ** (-float(alpha))


# ------------------------------------------------------------ client stage
def client_deltas(params, x, y, batch_idx, keys, lr, prox_mu,
                  cfg: ForecasterConfig, loss: Callable,
                  tcfg: TransformConfig = TransformConfig(),
                  cell_impl: str = "kernel",
                  scfg: SecureAggConfig = None, round_key=None,
                  w_full=None, slots=None):
    """Local-update + transform stages alone: per-client TRANSFORMED deltas
    ``stack(w_i - w_global)`` and losses, WITHOUT aggregation, since the
    buffered server releases each client's contribution on its own clock.
    The stack runs here, at dispatch, so only privatized / compressed
    deltas reach the server's straggler buffer.  ``keys``: (M, 2)
    dispatch-round transform keys.

    With secure aggregation the pairwise masks are applied HERE, under the
    dispatch cohort's shared ``round_key`` and gated / scaled by the cohort
    weight vector ``w_full``.  ``slots``: the clients' GLOBAL dispatch
    slots when ``x`` is one rank's block of the dispatch (None: the rows).
    """
    from repro_torch.core import fedavg as fedavg_mod
    locals_, client_loss = local_update(params, x, y, batch_idx, lr, cfg,
                                        loss, cell_impl, prox_mu)
    with torch.no_grad():
        deltas = tree_map(lambda l, g: l - g, locals_, params)
        stack = transforms_mod.make_stack(tcfg, scfg)
        if not stack.is_identity:
            deltas = fedavg_mod.apply_stack(stack, deltas, keys, slots=slots,
                                            w_full=w_full,
                                            round_key=round_key)
    return deltas, client_loss


def _gather_dispatch(mesh, deltas, closs):
    """Every rank's block of (transformed deltas, losses), as host numpy:
    one ``all_gather`` of each client's flattened leaves and loss, so every
    rank holds the whole dispatch in slot order."""
    leaves = sorted_leaves(deltas)
    b = closs.shape[0]
    flat = torch.cat([x.reshape(b, -1) for x in leaves]
                     + [closs.reshape(b, 1).to(leaves[0].dtype)], 1)
    rows = mesh.all_gather(flat).reshape(-1, flat.shape[1]).numpy()
    out, at = [], 0
    for x in leaves:
        n = x[0].numel()
        out.append(rows[:, at:at + n].reshape((-1,) + tuple(x.shape[1:])))
        at += n
    return unflatten_sorted(deltas, out), rows[:, at]


# --------------------------------------------------------- buffered server
def buffered_aggregate(params, deltas, weights):
    """Fold a flushed buffer of (already-transformed) client deltas into the
    global model: ``w + sum(w_i * delta_i) / sum(w_i)``.

    deltas: client-stacked tree (leading axis = arrivals, zero-padded);
    weights: (A,) staleness-discounted aggregation weights (0 marks pads).
    The weighting math is the pipeline's own ``_weighted_sums``.
    """
    from repro_torch.core import fedavg as fedavg_mod
    sums, wsum = fedavg_mod._weighted_sums(deltas, weights)
    return tree_map(lambda g, s: g + s / wsum, params, sums)


def buffered_aggregate_preweighted(params, deltas, discounts, wsum):
    """Fold PRE-WEIGHTED uploads (float masked path: each delta is already
    ``w_i * delta_i + masks``): the numerator weights are the staleness
    discounts alone (anything non-uniform within a cohort would break mask
    cancellation), the denominator ``wsum`` the sum of discounted
    aggregation weights, supplied by the caller."""
    from repro_torch.core import fedavg as fedavg_mod
    sums, _ = fedavg_mod._weighted_sums(deltas, discounts)
    return tree_map(lambda g, s: g + s / wsum, params, sums)


@dataclasses.dataclass(eq=False)     # identity eq: deltas are array trees
class PendingUpdate:
    """One dispatched-but-not-yet-aggregated client update (host-side).
    ``delta`` is already transformed at dispatch with the dispatch-round
    key.  ``finish_time = inf`` marks a mid-upload failure; ``retry_round``
    is the round of the latest (re)dispatch (the timeout baseline) and
    ``slot`` the client's dispatch slot, which keys its straggler / dropout
    draws and its place in the secure-agg mask cohort."""
    delta: PyTree                      # np arrays, computed at dispatch
    weight: float                      # base aggregation weight
    loss: float                        # client's local training loss
    dispatch_round: int
    finish_time: float                 # simulated arrival (absolute seconds)
    slot: int = 0                      # global dispatch slot
    retries: int = 0                   # re-dispatch attempts so far
    retry_round: int = 0               # round of the latest (re)dispatch


def _tree_slice(tree, i: int):
    return tree_map(lambda a: np.asarray(a[i]), tree)


def _ring_wrap_np(x: np.ndarray, bits: int) -> np.ndarray:
    """Host-side twin of ``transforms.ring_wrap``: reduce into the centered
    ring ``[-2^(b-1), 2^(b-1))`` (exact on float-encoded ints < 2^24)."""
    half = float(2 ** (bits - 1))
    return (np.mod(x + half, float(2 ** bits)) - half).astype(x.dtype)


def _stack_padded(pending: List[PendingUpdate], weights: np.ndarray):
    """Stack arrived updates into next-power-of-two batches (zero-padded,
    weight 0), the reference's fold shapes."""
    n = len(pending)
    cap = 1 << max(n - 1, 0).bit_length()
    deltas = tree_map(
        lambda *xs: np.stack(xs + (np.zeros_like(xs[0]),) * (cap - n)),
        *[p.delta for p in pending])
    w = np.zeros(cap, np.float32)
    w[:n] = weights
    return deltas, w


class SemiSyncState:
    """The buffered server's host-side event state: pending updates and the
    simulated clock.  One per :class:`~repro_torch.core.fedavg.RoundEngine`;
    reset between independent trainings (per cluster).

    ``cohort_sizes``: how many REAL clients each dispatch round still has in
    the running (cohort-atomic folds need it), decremented when a timeout
    abandons members.  ``cohort_w`` / ``cohort_gen``: each live cohort's
    current weight vector and re-key generation.  ``cohort_W0``: its
    dispatch-time weight sum (the ring decode's geometry).  All are swept
    once no pending update references their round.
    """

    def __init__(self) -> None:
        self.pending: List[PendingUpdate] = []
        self.clock = 0.0
        self.late_folds = 0            # stale updates folded so far
        self.max_staleness = 0         # largest tau seen
        self.cohort_sizes: dict = {}   # dispatch round -> # live dispatched
        self.cohort_w: dict = {}       # dispatch round -> (M,) weight vector
        self.cohort_gen: dict = {}     # dispatch round -> re-key generation
        self.cohort_W0: dict = {}      # dispatch round -> float
        self.empty_flushes = 0         # flushes with no server step
        self.rekeys = 0                # cohort re-keys (dropout recovery)
        self.abandoned = 0             # updates dropped for good (timeout)

    def reset(self) -> None:
        self.__init__()

    def _sweep(self) -> None:
        """Drop cohort bookkeeping no pending update references."""
        live = {p.dispatch_round for p in self.pending}
        for r in [r for r in self.cohort_sizes if r not in live]:
            self.cohort_sizes.pop(r)
            self.cohort_w.pop(r, None)
            self.cohort_gen.pop(r, None)
            self.cohort_W0.pop(r, None)

    # ---- checkpointing (fedavg.run_federated_training) -------------------
    def to_tree(self):
        """The full event state as a checkpointable tree of numpy arrays
        (float64 scalars: the clock and finish times round-trip exactly)."""
        rounds = sorted(self.cohort_sizes)
        return {
            "clock": np.asarray([self.clock], np.float64),
            "counters": np.asarray(
                [self.late_folds, self.max_staleness, self.empty_flushes,
                 self.rekeys, self.abandoned], np.int64),
            "pending": [
                {"delta": p.delta,
                 "scalars": np.asarray(
                     [p.weight, p.loss, p.dispatch_round, p.finish_time,
                      p.slot, p.retries, p.retry_round], np.float64)}
                for p in self.pending],
            "cohort_rounds": np.asarray(rounds, np.int64),
            "cohort_sizes": np.asarray(
                [self.cohort_sizes[r] for r in rounds], np.int64),
            "cohort_gens": np.asarray(
                [self.cohort_gen.get(r, 0) for r in rounds], np.int64),
            "cohort_W0": np.asarray(
                [self.cohort_W0.get(r, 0.0) for r in rounds], np.float64),
            "cohort_w": (np.stack([np.asarray(self.cohort_w[r], np.float32)
                                   for r in rounds])
                         if rounds else np.zeros((0, 0), np.float32)),
        }

    @classmethod
    def from_tree(cls, tree) -> "SemiSyncState":
        ss = cls()
        ss.clock = float(np.asarray(tree["clock"]).reshape(-1)[0])
        (ss.late_folds, ss.max_staleness, ss.empty_flushes, ss.rekeys,
         ss.abandoned) = (int(v) for v in np.asarray(tree["counters"]))
        for entry in tree["pending"]:
            w, l, dr, ft, slot, rt, rr = (
                float(v) for v in np.asarray(entry["scalars"]))
            ss.pending.append(PendingUpdate(
                delta=tree_map(np.asarray, entry["delta"]),
                weight=w, loss=l, dispatch_round=int(dr), finish_time=ft,
                slot=int(slot), retries=int(rt), retry_round=int(rr)))
        sizes = np.asarray(tree["cohort_sizes"])
        gens = np.asarray(tree["cohort_gens"])
        cw = np.asarray(tree["cohort_w"])
        for i, r in enumerate(np.asarray(tree["cohort_rounds"], np.int64)):
            ss.cohort_sizes[int(r)] = int(sizes[i])
            ss.cohort_gen[int(r)] = int(gens[i])
            ss.cohort_w[int(r)] = np.asarray(cw[i], np.float32)
            # pre-cohort_W0 checkpoints: the weight vector was never zeroed
            # before the field existed, so its sum is the dispatch-time W
            w0 = tree.get("cohort_W0")
            ss.cohort_W0[int(r)] = (float(np.asarray(w0)[i])
                                    if w0 is not None
                                    else float(ss.cohort_w[int(r)].sum()))
        return ss


def _to_host(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _handle_timeouts(engine, round_idx: int, stream: int) -> None:
    """Sweep the pending buffer for abandoned work (``ChurnConfig``): any
    update still unarrived ``timeout_rounds`` dispatches after its latest
    (re)dispatch is presumed lost.

    *Plain semi-sync*: the server asks the client to re-send its retained
    transformed delta (uplink-only cost on the re-upload latency stream, a
    fresh dropout draw per attempt), up to ``max_retries`` attempts, then
    abandons it.

    *Cohort-atomic folds* (secure aggregation): a lost member means the
    cohort's masks can never cancel, so the whole cohort re-keys: unarrived
    members are abandoned, and the arrived survivors re-mask under the next
    key generation restricted to the surviving slots, through
    :func:`~repro_torch.core.secure_agg.mask_contribution` (on the engine's
    device), and re-upload.  A cohort with no survivors is dropped.
    Without masking the same scheduling runs with no delta rewrite.
    """
    ss: SemiSyncState = engine.async_state
    churn = engine.latency.churn
    overdue = [p for p in ss.pending
               if p.finish_time > ss.clock
               and round_idx - p.retry_round >= churn.timeout_rounds]
    if not overdue:
        return

    if not engine.async_cfg.cohort_atomic:
        for p in overdue:
            if p.retries >= churn.max_retries:
                ss.pending.remove(p)
                ss.abandoned += 1
                continue
            p.retries += 1
            p.retry_round = round_idx
            re_t = float(engine.latency.reupload_times(
                round_idx, [p.slot], attempt=p.retries)[0])
            drop = bool(engine.latency.dropouts(
                round_idx, [p.slot], attempt=p.retries)[0])
            p.finish_time = float("inf") if drop else ss.clock + re_t
        ss._sweep()
        return

    # cohort-atomic: recover every cohort that lost a member
    ring = engine.stack.ring_spec
    masker = (secure_agg_mod.make_masker(
                  engine.secure, ring_bits=ring[0] if ring else 0)
              if engine.secure is not None else None)
    dev = engine.device
    for r in sorted({p.dispatch_round for p in overdue}):
        cohort = [p for p in ss.pending if p.dispatch_round == r]
        lost = [p for p in cohort if p.finish_time > ss.clock]
        survivors = [p for p in cohort if p.finish_time <= ss.clock]
        for p in lost:
            ss.pending.remove(p)
        ss.abandoned += len(lost)
        if not survivors:
            continue
        gen = ss.cohort_gen.get(r, 0)
        w_old = np.asarray(ss.cohort_w[r], np.float32)
        w_new = w_old.copy()
        w_new[[p.slot for p in lost]] = 0.0
        if masker is not None:
            # every survivor's old and new mask terms, each key's cohort
            # masks drawn once for all survivors
            like = tree_from_numpy(survivors[0].delta, dev)
            slots = [p.slot for p in survivors]
            old_m, new_m = (_to_host(secure_agg_mod.mask_contribution(
                masker, like, slots, torch.from_numpy(w).to(dev),
                engine.rekey_key(r, stream, g)))
                for w, g in ((w_old, gen), (w_new, gen + 1)))
            for j, p in enumerate(survivors):
                o, n = (tree_map(lambda a: a[j], m) for m in (old_m, new_m))
                if ring:
                    # exact ring algebra: wrap(v - old + new) is the upload
                    # the survivor would have made under the new key
                    p.delta = tree_map(
                        lambda d, o, n: _ring_wrap_np(
                            np.asarray(d - o + n), ring[0]),
                        p.delta, o, n)
                else:
                    p.delta = tree_map(lambda d, o, n: np.asarray(d - o + n),
                                       p.delta, o, n)
        # survivors re-upload their (re-masked) deltas: in flight again,
        # with a fresh dropout draw
        slots = np.asarray([p.slot for p in survivors])
        re_t = engine.latency.reupload_times(round_idx, slots,
                                             attempt=gen + 1)
        drop = engine.latency.dropouts(round_idx, slots, attempt=gen + 1)
        for p, t, d in zip(survivors, re_t, drop):
            p.finish_time = float("inf") if d else ss.clock + float(t)
            p.retry_round = round_idx
            p.retries += 1
        ss.cohort_sizes[r] = len(survivors)
        ss.cohort_w[r] = w_new
        ss.cohort_gen[r] = gen + 1
        ss.rekeys += 1
        if engine.accountant is not None:
            # the re-keyed fold carries only the survivors' noise draws
            engine.accountant.observe_cohort(len(survivors))
    ss._sweep()


def semi_sync_step(engine, params, state, x, y, batch_idx, weights,
                   round_idx: int = 0, stream: int = 0):
    """One semi-synchronous round (``RoundEngine.step`` dispatches here).

    Same contract as the sync step (already-selected, over-selected client
    data in; ``(params, server_state, loss)`` out) plus the simulated event
    clock advanced on ``engine.async_state``.  The loss is the
    discount-weighted mean local loss of the updates folded this round
    (``nan`` when nothing folds).
    """
    ss: SemiSyncState = engine.async_state
    acfg: AsyncConfig = engine.async_cfg
    ccfg = engine.flcfg.client_opt
    churn = engine.latency.churn
    if churn.faulty:
        # retry / re-key abandoned work BEFORE this round's dispatch, so a
        # recovered cohort can complete at this very flush
        _handle_timeouts(engine, round_idx, stream)
    w_in = np.asarray(weights, np.float32)
    real = np.flatnonzero(w_in > 0)    # padding duplicates excluded

    # -- dispatch: every real client's simulated finish time; a mid-upload
    # failure makes it infinite
    times = engine.latency.times(round_idx, w_in[real], ccfg.local_epochs,
                                 slots=real)
    finish = ss.clock + times
    if churn.faulty:
        finish = np.where(engine.latency.dropouts(round_idx, real),
                          np.inf, finish)

    # -- flush point: the k-th earliest arrival among everything in flight
    # (old stragglers + this dispatch); under cohort-atomic folds arrived
    # updates of incomplete cohorts do not gate the clock, nor do dropped
    # uploads (finish = inf)
    in_flight = [p.finish_time for p in ss.pending
                 if not acfg.cohort_atomic or p.finish_time > ss.clock]
    pend_finish = np.asarray(in_flight + list(finish))
    finite = pend_finish[np.isfinite(pend_finish)]
    if acfg.buffer_frac:
        k_cfg = max(1, int(np.ceil(acfg.buffer_frac * len(finish))))
    else:
        k_cfg = engine.buffer_k
    k = min(k_cfg, len(finite))
    have_flush = len(finite) > 0
    new_clock = (float(np.partition(finite, k - 1)[k - 1]) if have_flush
                 else ss.clock)
    arrive_now = finish <= new_clock

    if not ss.pending and bool(arrive_now.all()):
        # a complete flush of exactly this dispatch, nothing buffered: the
        # synchronous round's math (all tau = 0), through the fused round
        ss.clock = new_clock
        return engine._sync_step(params, state, x, y, batch_idx, weights,
                                 round_idx, stream)

    # -- slow path: every dispatched client's (transformed) delta now, on
    # this rank's block; buffer; fold
    dev = engine.device
    m = w_in.shape[0]
    lo, hi = engine._block(m)
    base_w = w_in if engine.weighted else (w_in > 0).astype(np.float32)
    keys = rk = None
    if not engine.stack.is_identity:
        keys = engine.round_keys(round_idx, m, stream)[lo:hi]
        rk = engine.base_round_key(round_idx, stream)
    xb, yb, bb = (engine._rows(a, lo, hi) for a in (x, y, batch_idx))
    slots = (None if engine.mesh is None
             else torch.arange(lo, hi, device=dev))
    deltas, closs = client_deltas(
        params, xb, yb, bb, keys, engine.flcfg.lr, engine.prox_mu,
        engine.fcfg, engine.loss, engine.transform, engine.cell_impl,
        engine.secure, rk, torch.from_numpy(base_w).to(dev), slots)
    if engine.mesh is not None and engine.mesh.distributed:
        deltas, closs = _gather_dispatch(engine.mesh, deltas, closs)
    else:
        deltas, closs = _to_host(deltas), closs.detach().cpu().numpy()
    for j, i in enumerate(real):
        ss.pending.append(PendingUpdate(
            delta=_tree_slice(deltas, int(i)), weight=float(base_w[i]),
            loss=float(closs[i]), dispatch_round=round_idx,
            finish_time=float(finish[j]), slot=int(i),
            retry_round=round_idx))
    ss.cohort_sizes[round_idx] = len(real)
    ss.cohort_w[round_idx] = np.asarray(base_w, np.float32).copy()
    ss.cohort_gen[round_idx] = 0
    ss.cohort_W0[round_idx] = float(np.asarray(base_w, np.float64).sum())

    nan = torch.tensor(float("nan"))
    if not have_flush:
        # everything in flight is a dropped upload: buffer the dispatch,
        # leave the clock, wait for the timeout sweep
        ss.empty_flushes += 1
        return params, state, nan

    arrived = [p for p in ss.pending if p.finish_time <= new_clock]
    if acfg.cohort_atomic:
        # fold only complete dispatch cohorts, each as one group with one
        # shared staleness (one discount scales every member's mask alike)
        got = {}
        for p in arrived:
            got[p.dispatch_round] = got.get(p.dispatch_round, 0) + 1
        complete = {r for r, n in got.items()
                    if n == ss.cohort_sizes.get(r)}
        arrived = [p for p in arrived if p.dispatch_round in complete]
        if not arrived:
            ss.clock = new_clock
            ss.empty_flushes += 1
            return params, state, nan
        ss.pending = [p for p in ss.pending
                      if p.dispatch_round not in complete]
    else:
        ss.pending = [p for p in ss.pending if p.finish_time > new_clock]
    # the ring decode needs each folded cohort's grid geometry: capture it
    # BEFORE the sweep drops the books of fully folded cohorts
    cohort_meta = {r: (int(ss.cohort_w[r].shape[0]),
                       float(ss.cohort_W0[r]))
                   for r in {p.dispatch_round for p in arrived}}
    ss._sweep()
    ss.clock = new_clock

    tau = np.asarray([round_idx - p.dispatch_round for p in arrived])
    ss.late_folds += int((tau > 0).sum())
    ss.max_staleness = max(ss.max_staleness, int(tau.max(initial=0)))
    disc = staleness_discount(tau, acfg.staleness_alpha)
    eff_w = (np.asarray([p.weight for p in arrived]) * disc
             ).astype(np.float32)
    denom = torch.tensor(eff_w.sum(), dtype=torch.float32, device=dev)
    ring = engine.stack.ring_spec
    with torch.no_grad():
        if ring is not None:
            # shared-grid ring uploads: decode per COHORT on the host: wrap
            # the cohort's summed uploads into the ring (exact integer mask
            # cancellation), rescale through its grid (scale * W0 recovers
            # sum(w_i * delta_i)), apply its shared discount, then divide
            # by the discounted weight sum
            bits, sensitivity, headroom = ring
            num = tree_map(lambda g: np.zeros(tuple(g.shape), np.float32),
                           params)
            for r in sorted(cohort_meta):
                members = [p for p in arrived if p.dispatch_round == r]
                m_r, w0_r = cohort_meta[r]
                s_r = transforms_mod.ring_scale(bits, sensitivity, m_r,
                                                headroom)
                d_r = float(staleness_discount(round_idx - r,
                                               acfg.staleness_alpha))
                coef = np.float32(d_r * s_r * w0_r)
                num = tree_map(
                    lambda a, *ds: a + coef * _ring_wrap_np(
                        np.sum(np.stack(ds), axis=0), bits),
                    num, *[p.delta for p in members])
            w_agg = tree_map(
                lambda g, s: g + torch.from_numpy(s).to(dev) / denom,
                params, num)
        elif engine.stack.pre_weighted:
            d_stack, disc_stack = _stack_padded(arrived,
                                                disc.astype(np.float32))
            w_agg = buffered_aggregate_preweighted(
                params, tree_from_numpy(d_stack, dev),
                torch.from_numpy(disc_stack).to(dev), denom)
        else:
            d_stack, w_stack = _stack_padded(arrived, eff_w)
            w_agg = buffered_aggregate(params, tree_from_numpy(d_stack, dev),
                                       torch.from_numpy(w_stack).to(dev))
    losses = np.asarray([p.loss for p in arrived])
    loss = float(np.sum(eff_w * losses) / eff_w.sum())
    params, state = server_opt_mod.server_update(params, w_agg, state,
                                                 engine.flcfg.server)
    return params, state, torch.tensor(loss, dtype=torch.float32)
