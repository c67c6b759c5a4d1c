"""Padded-bucket batching engine — the serving tier's hot path.

Forecast requests arrive one consumer at a time as RAW watt-hour windows;
the engine owns everything between that and the forward on the card:

* **Coalescing**: requests queue per model slot (the router's cluster id)
  and are served in batches of at most ``max_batch``.
* **Power-of-two shape buckets**: each batch is zero-padded up to the next
  power-of-two bucket in ``[min_bucket, max_batch]``, so the forward only
  ever sees a bounded set of batch shapes.  :meth:`ServingEngine.warmup`
  runs every bucket once (kernel build, first launches) before traffic.
* **Per-request normalization on the device**: callers send raw watt-hours
  plus (once per consumer) a raw history; the engine derives the consumer's
  min-max stats, normalizes inside the forward on the device and
  de-normalizes the forecast back to kWh there, so callers never touch
  model space.
* **Hot-swap safety**: a flush snapshots its :class:`ModelHandle` once and
  serves the whole batch from it; a registry publish lands at the next
  flush boundary, never mid-batch.  Parameters are arguments of the
  forward, so a swap changes no code path.

The forward steps through the hand-written CUDA cells; on a CPU engine the
same call takes their plain versions.  An int8 handle's weights are
dequantized inside the forward, a temporary of the flush: the registry
keeps only the int8 grid and its scales.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models import forecaster
from repro_torch.serving.registry import (GLOBAL_SLOT, ModelHandle,
                                          ModelRegistry, dequantize_params,
                                          resolve_device)

__all__ = ["ForecastRequest", "FlushStats", "EngineStats", "ServingEngine",
           "bucket_for", "bucket_ladder"]


def bucket_for(n: int, min_bucket: int, max_batch: int) -> int:
    """Power-of-two bucket for ``n`` requests, clamped to
    ``[min_bucket, max_batch]``.  ``n`` must fit one batch."""
    if n < 1 or n > max_batch:
        raise ValueError(f"n={n} outside [1, max_batch={max_batch}]")
    b = 1 << max(n - 1, 0).bit_length()
    return min(max(b, min_bucket), max_batch)


def bucket_ladder(min_bucket: int, max_batch: int) -> List[int]:
    """All bucket sizes the engine can emit: min_bucket, 2·min_bucket, …,
    max_batch."""
    out, b = [], min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


@dataclasses.dataclass
class ForecastRequest:
    """One pending forecast; doubles as the caller's result ticket.

    ``window`` is the consumer's most recent ``lookback`` RAW watt-hour
    readings; ``result`` is the (horizon,) kWh forecast once flushed;
    ``submit_ns`` the tracer's clock at submit, 0 while it is off.
    """
    consumer_id: Any
    window: np.ndarray
    lo: float
    hi: float
    slot: Any
    result: Optional[np.ndarray] = None
    submit_ns: int = 0

    @property
    def done(self) -> bool:
        return self.result is not None


@dataclasses.dataclass(frozen=True)
class FlushStats:
    """One executed batch: who ran, how padded, and how long it took."""
    slot: Any
    n_requests: int                       # real rows
    bucket: int                           # padded shape actually executed
    wall_s: float                         # host clock, result on the host
    generation: int                       # handle generation that served it
    weights: str                          # "fp32" or "int8"
    requests: Tuple[ForecastRequest, ...] = ()


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    flushes: int = 0
    busy_s: float = 0.0
    swaps_seen: int = 0                   # generation changes across flushes
    by_bucket: Dict[int, int] = dataclasses.field(default_factory=dict)

    def fill(self) -> float:
        """Mean batch occupancy: real rows / padded rows across flushes."""
        padded = sum(b * n for b, n in self.by_bucket.items())
        return self.requests / padded if padded else 0.0


def forecast_kwh(params, x, lo, hi, cfg):
    """(B, L) raw watt-hours + per-row (B, 1) (lo, hi) stats -> (B, horizon)
    kWh, all on the tensors' device, through the fused cells."""
    scale = torch.clamp_min(hi - lo, 1e-9)
    xn = (x - lo) / scale
    pred = forecaster.forecast(params, xn[..., None], cfg)
    return pred * scale + lo


class ServingEngine:
    """Queue + bucketed-batch executor over a :class:`ModelRegistry`.

    ``router`` (a :class:`repro_torch.serving.router.ClusterRouter`) maps a
    consumer's raw history to a model slot at first contact; without one
    (or without a history) everything runs on the global slot.  Consumer
    stats/slot assignments live in a bounded LRU (``consumer_cache``).

    ``auto_flush`` flushes a slot the moment its queue reaches
    ``max_batch``; replay harnesses that account queueing time themselves
    turn it off and drive :meth:`flush` explicitly.

    ``device=None`` means the card and raises without one; it must be the
    registry's device.
    """

    def __init__(self, registry: ModelRegistry, router=None, *,
                 max_batch: int = 256, min_bucket: int = 8,
                 auto_flush: bool = True, consumer_cache: int = 100_000,
                 device=None):
        for name, v in (("max_batch", max_batch), ("min_bucket", min_bucket)):
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name}={v} must be a power of two")
        if min_bucket > max_batch:
            raise ValueError(f"min_bucket={min_bucket} > max_batch={max_batch}")
        self.device = resolve_device(device)
        if self.device != registry.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"registry's {registry.device}")
        self.registry = registry
        self.router = router
        self.max_batch, self.min_bucket = int(max_batch), int(min_bucket)
        self.auto_flush = bool(auto_flush)
        self.stats = EngineStats()
        self._queues: Dict[Any, List[ForecastRequest]] = {}
        self._consumers: "OrderedDict[Any, Tuple[Any, float, float]]" = \
            OrderedDict()
        self._consumer_cache = int(consumer_cache)
        self._last_gen: Dict[Any, int] = {}

    # -------------------------------------------------------------- probes
    def pending(self, slot: Any = None) -> int:
        if slot is not None:
            return len(self._queues.get(slot, ()))
        return sum(len(q) for q in self._queues.values())

    # -------------------------------------------------------------- intake
    def _resolve(self, consumer_id, window: np.ndarray,
                 history) -> Tuple[Any, float, float]:
        """(slot, lo, hi) for one consumer: cached after first contact.

        With a raw ``history`` the min-max stats come from the full history
        (matching training-side per-building normalization) and the router
        assigns the cluster slot from its privacy-coarsened daily summary.
        Without either, the request window's own min-max is the documented
        fallback — fine for flat consumers, coarse for peaky ones.
        """
        if consumer_id is not None and history is None:
            hit = self._consumers.get(consumer_id)
            if hit is not None:
                self._consumers.move_to_end(consumer_id)
                return hit
        if history is not None:
            h = np.asarray(history, np.float32).reshape(-1)
            lo, hi = float(h.min()), float(h.max())
            slot = (self.router.route(h)
                    if self.router is not None and self.router.enabled
                    else GLOBAL_SLOT)
        else:
            lo, hi = float(window.min()), float(window.max())
            slot = GLOBAL_SLOT
        entry = (slot, lo, hi)
        if consumer_id is not None and history is not None \
                and self._consumer_cache > 0:
            self._consumers[consumer_id] = entry
            while len(self._consumers) > self._consumer_cache:
                self._consumers.popitem(last=False)
        return entry

    def submit(self, consumer_id, window, history=None) -> ForecastRequest:
        """Enqueue one forecast request (raw watt-hours) and return its
        ticket.  Pass ``history`` on a consumer's first contact so routing
        and normalization use their real range; later requests hit the
        consumer cache."""
        t0 = tracing.now() if tracing.on() else 0
        w = np.asarray(window, np.float32).reshape(-1)
        slot, lo, hi = self._resolve(consumer_id, w, history)
        handle = self.registry.handle(slot)
        if w.shape[0] != handle.cfg.lookback:
            raise ValueError(
                f"window has {w.shape[0]} readings; slot {handle.slot!r} "
                f"model wants lookback={handle.cfg.lookback}")
        req = ForecastRequest(consumer_id, w, lo, hi, handle.slot)
        self._queues.setdefault(handle.slot, []).append(req)
        self.stats.requests += 1
        if t0:
            req.submit_ns = t0
            tracing.count("engine.submit", tracing.now() - t0)
        if self.auto_flush and len(self._queues[handle.slot]) >= self.max_batch:
            self.flush(handle.slot)
        return req

    # --------------------------------------------------------------- flush
    def flush(self, slot: Any = None) -> List[FlushStats]:
        """Serve queued requests — one slot, or every non-empty queue."""
        slots = ([slot] if slot is not None
                 else [s for s, q in self._queues.items() if q])
        out: List[FlushStats] = []
        for s in slots:
            out.extend(self._flush_slot(s))
        return out

    def _flush_slot(self, slot) -> List[FlushStats]:
        q = self._queues.get(slot)
        if not q:
            return []
        # ONE handle snapshot for everything this flush executes: a publish
        # that lands mid-flush is observed at the next flush boundary, so a
        # batch can never mix generations
        handle = self.registry.handle(slot)
        last = self._last_gen.get(slot)
        if last is not None and handle.generation != last:
            self.stats.swaps_seen += 1
        # flcheck: disable=FLC008 (one int per routed slot; slots come from the registry's fixed cluster universe, not from request traffic)
        self._last_gen[slot] = handle.generation
        out = []
        while q:
            chunk, self._queues[slot] = q[:self.max_batch], q[self.max_batch:]
            q = self._queues[slot]
            out.append(self._run_batch(handle, chunk))
        return out

    def _forward(self, handle: ModelHandle, rows: np.ndarray) -> np.ndarray:
        """(b, L + 2) host rows [window | lo | hi] -> (b, horizon) host kWh;
        one copy to the device, one back."""
        L = handle.cfg.lookback
        with tracing.span("engine.forward"), torch.inference_mode():
            t = torch.from_numpy(rows).to(self.device)
            params = (dequantize_params(handle.params)
                      if handle.weights == "int8" else handle.params)
            pred = forecast_kwh(params, t[:, :L], t[:, L:L + 1],
                                t[:, L + 1:], handle.cfg)
            return pred.cpu().numpy()      # waits for the device

    def _run_batch(self, handle: ModelHandle,
                   chunk: List[ForecastRequest]) -> FlushStats:
        n = len(chunk)
        b = bucket_for(n, self.min_bucket, self.max_batch)
        with tracing.span("engine.flush", slot=handle.slot, rows=n,
                          bucket=b) as sp:
            if sp:
                waits = [sp.t0 - r.submit_ns for r in chunk if r.submit_ns]
                sp.attrs.update(wait_n=len(waits), wait_sum_ns=sum(waits),
                                wait_max_ns=max(waits, default=0))
            L = handle.cfg.lookback
            rows = np.zeros((b, L + 2), np.float32)
            rows[:, L + 1] = 1.0              # pad rows: scale 1, sliced off
            for j, r in enumerate(chunk):
                rows[j, :L] = r.window
                rows[j, L] = r.lo
                rows[j, L + 1] = r.hi
            t0 = time.perf_counter()
            pred = self._forward(handle, rows)
            dt = time.perf_counter() - t0
            for j, r in enumerate(chunk):
                r.result = pred[j]
            self.stats.flushes += 1
            self.stats.busy_s += dt
            self.stats.by_bucket[b] = self.stats.by_bucket.get(b, 0) + 1
            return FlushStats(handle.slot, n, b, dt, handle.generation,
                              handle.weights, tuple(chunk))

    # -------------------------------------------------------------- warmup
    def warmup(self, slots=None) -> int:
        """Run every (bucket, cfg, weights) shape the registry can serve
        once, so the kernels are built and the first launches are paid
        before traffic.  Returns the number of shapes run."""
        n = 0
        seen = set()
        for s in (self.registry.slots() if slots is None else slots):
            handle = self.registry.handle(s)
            sig = (handle.cfg, handle.weights)
            if sig in seen:
                continue
            seen.add(sig)
            L = handle.cfg.lookback
            for b in bucket_ladder(self.min_bucket, self.max_batch):
                rows = np.zeros((b, L + 2), np.float32)
                rows[:, L + 1] = 1.0
                self._forward(handle, rows)
                n += 1
        return n
