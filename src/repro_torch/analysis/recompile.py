"""Dynamic round-hot-path checks: the recompile guard and the host-read
guard; the counterpart of ``src/repro/analysis/recompile.py``.

Two performance contracts of the round engine:

* **Nothing is built per round.**  The JAX package jits the round once per
  execution geometry and counts new jit cache entries.  The port has no
  jit cache; what it makes on first use and must not make again in the
  steady state is: a kernel library (``kernels/_cuda.py::build``, one
  ``nvcc`` and a load per source), a launch plan
  (``_cuda.cell_plan``, an LRU cache keyed on the layer's shape: a batch
  size that changes every round misses it every round), and a CUDA graph
  capture.  :func:`count_recompiles` runs a callable for N steps after a
  warm-up and reports how much :func:`probe` grew at each.
* **No host read inside the round.**  The round body consumes device
  tensors; a ``.item()``, a Python float built from a tensor, a boolean
  mask or a copy to the CPU stalls the host on the device every round.
  :func:`check_transfers` warms the step up and re-runs it under
  :class:`HostReadGuard`, a ``TorchDispatchMode`` that raises on any op
  that reads device data to the host (it works on the CPU as well, where
  it catches the same calls), and on the card also under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises on the
  synchronizing calls the mode cannot see.

Both are dynamic (they run the function); the CLI drives them against the
real round next to the static passes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import taint

__all__ = ["RecompileReport", "HostReadGuard", "HostReadError", "probe",
           "count_recompiles", "check_transfers", "check_round_hot_path"]

aten = torch.ops.aten


class _CaptureCounter:
    """Counts ``torch.cuda.CUDAGraph.capture_begin`` calls while active."""

    def __init__(self):
        self.n = 0

    @contextlib.contextmanager
    def active(self):
        graph = torch.cuda.CUDAGraph
        orig = graph.capture_begin

        def counted(g, *a, **kw):
            self.n += 1
            return orig(g, *a, **kw)

        graph.capture_begin = counted
        try:
            yield self
        finally:
            graph.capture_begin = orig


def probe(captures: Optional[_CaptureCounter] = None) -> Dict[str, int]:
    """What the port has made so far: kernel libraries built or loaded,
    launch-plan cache misses, and CUDA graph captures (counted while
    :func:`count_recompiles` runs)."""
    from repro_torch.kernels import _cuda
    return {"builds": len(_cuda._libs),
            "plans": _cuda.cell_plan.cache_info().misses,
            "captures": captures.n if captures is not None else 0}


@dataclasses.dataclass
class RecompileReport:
    steps: int
    new_entries_per_step: List[int]      # probe growth AFTER the warm-up
    by_kind: List[Dict[str, int]] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(self.new_entries_per_step)

    def render(self) -> str:
        if self.ok:
            return (f"recompile guard OK: {self.steps} steps after warm-up "
                    "added 0 kernel builds, launch plans or graph captures")
        return ("recompile guard FAILED: post-warm-up steps added "
                f"{self.new_entries_per_step} ({self.by_kind}) — a shape "
                "changes every step (a new launch plan) or something is "
                "built / captured per step")


def count_recompiles(step: Callable[[int], Any],
                     steps: int = 3) -> RecompileReport:
    """Run ``step(i)`` for ``i in range(steps + 1)``; the first call is the
    warm-up (builds, plans and captures are expected), the rest must add
    none to :func:`probe`."""
    counter = _CaptureCounter()
    with counter.active():
        def read():
            return probe(counter)

        step(0)
        growth: List[int] = []
        kinds: List[Dict[str, int]] = []
        before = read()
        for i in range(1, steps + 1):
            step(i)
            now = read()
            kinds.append({k: now[k] - before[k] for k in now})
            growth.append(max(0, sum(kinds[-1].values())))
            before = now
    return RecompileReport(steps, growth, kinds)


class HostReadError(RuntimeError):
    """An op of the guarded step read device data to the host."""


def _bool_index(indices) -> bool:
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in indices or ())


class HostReadGuard(TorchDispatchMode):
    """Raises :class:`HostReadError` on any op that reads tensor data to
    the host: ``_local_scalar_dense`` (``.item()``, ``float(t)``,
    ``bool(t)``), ``nonzero`` / ``masked_select`` and indexing by a boolean
    mask (their output size is data), and a copy from the device to the
    CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        why = None
        if packet in (aten._local_scalar_dense, aten.nonzero,
                      aten.masked_select, aten.nonzero_static):
            why = "reads a value (or a data-dependent size) to the host"
        elif packet in (aten.index, aten.index_put, aten.index_put_) and \
                _bool_index(args[1] if len(args) > 1 else None):
            why = "indexes by a boolean mask (a data-dependent size)"
        elif taint.copies_to_host(func, args, kwargs):
            why = "copies device data to the CPU"
        if why is not None:
            raise HostReadError(f"{func} {why}")
        return func(*args, **kwargs)


def check_transfers(step: Callable[[int], Any]) -> Optional[str]:
    """Warm ``step`` up, then re-run it under :class:`HostReadGuard` (and,
    when the card is in use, ``set_sync_debug_mode("error")``).  Returns
    None when clean, else the error message."""
    step(0)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    try:
        with HostReadGuard():
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                step(1)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
        if cuda:
            torch.cuda.synchronize()
    except (HostReadError, RuntimeError) as e:
        return str(e)
    return None


def check_round_hot_path(steps: int = 3, device=None, fcfg=None,
                         m: int = 4, batch: int = 2, local_steps: int = 2,
                         n_win: int = 8, tcfg=None, scfg=None,
                         cell_impl: str = "kernel"):
    """Drive the REAL round (``fedavg.pipeline_round``) for ``steps``
    rounds after a warm-up and apply both guards.  Defaults: a small
    forecaster, 4 clients, the reference's guard config (clip 1.0, noise
    0.5, 4-bit quantize, no masking).  Every round input is on the device
    before the guarded call, and each round's keys are made on the device
    beforehand: the harness must not trip the guard it applies.  Returns
    ``(RecompileReport, host-read error or None, kernel launches inside
    the guarded round)``."""
    from repro_torch.configs.base import ForecasterConfig, TransformConfig
    from repro_torch.core import fedavg, losses, prng
    from repro_torch.kernels import _cuda
    from repro_torch.serving.registry import resolve_device

    device = resolve_device(device)
    fcfg = fcfg or ForecasterConfig(hidden_dim=8)
    tcfg = tcfg or TransformConfig(clip_norm=1.0, noise_multiplier=0.5,
                                   quantize_bits=4)
    loss = losses.make_loss("mse")
    params, x, y, bidx, w, _, root = taint.round_inputs(
        fcfg, m, device, n_win=n_win, steps=local_steps, batch=batch)
    rks = [prng.fold_in(root, i) for i in range(steps + 2)]
    keys = [prng.fold_in(rk, torch.arange(m, device=device)) for rk in rks]

    def step(i: int):
        return fedavg.pipeline_round(params, x, y, bidx, w, keys[i], 0.05,
                                     0.0, fcfg, loss, tcfg, cell_impl, scfg,
                                     rks[i])

    report = count_recompiles(step, steps=steps)
    window = {"launches": 0}

    def guarded(i: int):
        before = sum(_cuda.LAUNCHES.values())
        out = step(steps + i)
        if i:                               # the guarded call, not warm-up
            window["launches"] = sum(_cuda.LAUNCHES.values()) - before
        return out

    err = check_transfers(guarded)
    return report, err, window["launches"]
