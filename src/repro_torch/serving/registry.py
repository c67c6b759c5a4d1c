"""Serving model registry: per-slot model handles with atomic hot-swap.

A **slot** is any hashable routing key: the cluster ids the
:mod:`repro_torch.serving.router` produces (``GLOBAL_SLOT = -1`` is the
single global model, the FL trainer's cluster id for unclustered runs), or
richer keys like ``("CA", 2)``.  Each slot holds an immutable
:class:`ModelHandle`.  :meth:`ModelRegistry.publish` builds the replacement
handle completely (copy to the registry's device) before the swap, and the
swap is one dict assignment under a lock: a reader sees the old generation
or the new one, never a mix, and an in-flight batch that took its handle
finishes on the old parameters.

Generations are strictly monotone per slot: a stale publish (generation <=
the live one) raises, or is skipped with ``if_newer=True``, the polling
path where several pollers may race on the same checkpoint glob.

**int8 serving weights** (``weights="int8"``) store each leaf as an int8
grid plus one fp32 scale on the registry's device, a 4x cut in parameter
memory, on exactly the stochastic-rounding grid of the training-side
quantizer (:class:`repro_torch.core.transforms.StochasticQuantize`):
per-leaf max-abs scale, ``floor(x/s + u)`` rounding, per-leaf keys split as
the transform stack splits them.  ``dequantize_params(quantize_params(p,
key))`` is bit-identical to ``StochasticQuantize(8)`` of ``p`` under
``key``, and the draws are the JAX package's (``core/prng.py``), so the
int8 weights are the JAX package's bit for bit for the same params and
key.  The serving engine dequantizes inside its forward; no fp32 copy of an
int8 model is kept.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch import checkpoint
from repro_torch.configs.base import ForecasterConfig
from repro_torch.core import prng
from repro_torch.models import forecaster
from repro_torch.models.layers import sorted_leaves, unflatten_sorted

__all__ = ["GLOBAL_SLOT", "ModelHandle", "ModelRegistry", "resolve_device",
           "quantize_params", "dequantize_params"]

# FL training reports the unclustered run as cluster id -1; the serving
# tier reuses it as the fallback slot, so checkpoint polling needs no remap
GLOBAL_SLOT = -1

_WEIGHT_KINDS = ("fp32", "int8")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; a CUDA device raises when there is no
    card.  ``"cpu"`` runs the plain versions, only when the caller asks."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass "
            "device='cpu' to run the plain versions on the CPU")
    return device


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"q", "scale"}


def quantize_params(params, key: prng.Key, bits: int = 8):
    """fp32 param tree (tensors) -> tree of ``{"q": int8, "scale": fp32}``
    leaves on the params' device.

    Per-leaf max-abs scale to the signed ``2^(bits-1)-1`` grid, unbiased
    ``floor(x/s + u)`` rounding, per-leaf keys ``split(key, n_leaves)`` in
    ``jax.tree.flatten``'s leaf order: the transform stack's quantizer,
    with the integer grid materialized.
    """
    levels = float(2 ** (bits - 1) - 1)
    leaves = sorted_leaves(params)
    keys = prng.split(key, len(leaves))
    out = []
    for i, x in enumerate(leaves):
        x = x.float()
        scale = x.abs().max() / x.new_full((), levels)   # a true division
        safe = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
        u = prng.uniform(keys[i], x.shape, device=x.device)
        q = torch.clamp(torch.floor(x / safe + u), -levels, levels)
        out.append({"q": q.to(torch.int8), "scale": safe})
    return unflatten_sorted(params, out)


def dequantize_params(qparams):
    """int8 q-leaf tree -> fp32 param tree (``q * scale`` per leaf), on the
    q-leaves' device: the serving forward's temporary."""
    if _is_qleaf(qparams):
        return qparams["q"].to(torch.float32) * qparams["scale"]
    if isinstance(qparams, dict):
        return {k: dequantize_params(v) for k, v in qparams.items()}
    return [dequantize_params(v) for v in qparams]


@dataclasses.dataclass(frozen=True)
class ModelHandle:
    """One immutable serving model: parameters + config + generation.
    ``params`` is an fp32 tree (``weights="fp32"``) or a q-leaf tree
    (``weights="int8"``, see :func:`quantize_params`) on the registry's
    device."""
    slot: Any
    cfg: ForecasterConfig
    params: Any
    weights: str
    generation: int


def _to_fp32(tree, device):
    if isinstance(tree, dict):
        return {k: _to_fp32(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_fp32(v, device) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree)
    # clone: the handle must not alias a tree the caller may mutate later
    return t.detach().to(device=device, dtype=torch.float32, copy=True)


class ModelRegistry:
    """Slot -> :class:`ModelHandle` map with atomic, monotone hot-swap."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._slots: Dict[Any, ModelHandle] = {}
        self._lock = threading.Lock()
        # per-glob watermark: poll_checkpoint re-reads arrays only when the
        # (metadata-only) generation probe says something advanced
        self._poll_gen: Dict[str, int] = {}

    # ------------------------------------------------------------ publish
    def publish(self, params, cfg: ForecasterConfig, *, slot: Any = GLOBAL_SLOT,
                generation: int = 0, weights: str = "fp32",
                key: Optional[prng.Key] = None,
                if_newer: bool = False) -> Optional[ModelHandle]:
        """Build a fresh handle and atomically swap it into ``slot``.

        ``params`` is a forecaster tree of tensors or numpy arrays; the
        handle holds an fp32 copy on the registry's device, or with
        ``weights="int8"`` its int8 grid and scales, quantized there
        (``key`` required: the stochastic rounding; fold it from a config
        seed).  A stale ``generation`` raises ``ValueError``, or returns
        ``None`` with ``if_newer=True``.
        """
        if weights not in _WEIGHT_KINDS:
            raise ValueError(f"weights={weights!r}; pick from {_WEIGHT_KINDS}")
        stored = _to_fp32(params, self.device)
        if weights == "int8":
            if key is None:
                raise ValueError("int8 publish needs a PRNG key for "
                                 "stochastic rounding (derive from the "
                                 "config seed)")
            stored = quantize_params(stored, key)
        handle = ModelHandle(slot=slot, cfg=cfg, params=stored,
                             weights=weights, generation=int(generation))
        with self._lock:
            cur = self._slots.get(slot)
            if cur is not None and handle.generation <= cur.generation:
                if if_newer:
                    return None
                raise ValueError(
                    f"stale publish for slot {slot!r}: generation "
                    f"{handle.generation} <= live {cur.generation}")
            self._slots[slot] = handle
        return handle

    # ------------------------------------------------------------- lookup
    def handle(self, slot: Any = GLOBAL_SLOT) -> ModelHandle:
        """The live handle for ``slot``, falling back to ``GLOBAL_SLOT``
        when the slot has no model (the router's documented fallback)."""
        with self._lock:
            h = self._slots.get(slot)
            if h is None:
                h = self._slots.get(GLOBAL_SLOT)
        if h is None:
            raise KeyError(
                f"no model for slot {slot!r} and no {GLOBAL_SLOT} global "
                "fallback — publish one first")
        return h

    def slots(self) -> List[Any]:
        with self._lock:
            return sorted(self._slots, key=repr)

    def generation(self, slot: Any = GLOBAL_SLOT) -> int:
        """Live generation of ``slot`` (no fallback), -1 when empty."""
        with self._lock:
            h = self._slots.get(slot)
        return -1 if h is None else h.generation

    # ------------------------------------------------- checkpoint polling
    def poll_checkpoint(self, path_glob, cfg: ForecasterConfig, *,
                        weights: str = "fp32",
                        key: Optional[prng.Key] = None) -> List[ModelHandle]:
        """Publish new models from the freshest checkpoint under a glob.

        :func:`repro_torch.checkpoint.latest` finds the highest-generation
        match with metadata-only reads; arrays are loaded only when that
        generation beats this registry's per-glob watermark.  FL training
        checkpoints (written by either package) publish every finished
        cluster (``done/<cid>/params``) plus the in-progress one
        (``cur/params`` under ``metadata["cluster"]``); a bare param-tree
        checkpoint publishes ``GLOBAL_SLOT``.  An int8 publish of slot
        ``s`` rounds under ``fold_in(key, s + 1)``.  Returns the handles
        actually swapped in (stale slots are skipped).
        """
        found = checkpoint.latest(path_glob)
        if found is None:
            return []
        path, gen = found
        with self._lock:
            if gen <= self._poll_gen.get(str(path_glob), -1):
                return []
        flat, meta = checkpoint.load_arrays(path)
        meta = meta or {}
        template = forecaster.param_template(cfg)
        entries = [(int(cid), f"done/{cid}/params/")
                   for cid in meta.get("done", [])]
        if "cluster" in meta:
            entries.append((int(meta["cluster"]), "cur/params/"))
        if not entries:                     # plain params-tree checkpoint
            entries.append((GLOBAL_SLOT, ""))
        updated = []
        for slot, prefix in entries:
            try:
                params = checkpoint.unflatten_like(template, flat,
                                                   prefix=prefix)
            except KeyError:
                continue                    # slot absent from this snapshot
            # +1 keeps GLOBAL_SLOT=-1 and slot 0 on distinct key streams
            k = None if key is None else prng.fold_in(key, slot + 1)
            h = self.publish(params, cfg, slot=slot, generation=gen,
                             weights=weights, key=k, if_newer=True)
            if h is not None:
                updated.append(h)
        # the watermark is written back under the lock, which is not held
        # across publish() (the same non-reentrant lock): two racing pollers
        # may both publish, if_newer makes the second a no-op, and max()
        # keeps the watermark monotone
        with self._lock:
            prev = self._poll_gen.get(str(path_glob), -1)
            self._poll_gen[str(path_glob)] = max(gen, prev)
        return updated
