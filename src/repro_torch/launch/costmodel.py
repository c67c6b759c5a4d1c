"""Cost extraction for the roofline; the counterpart of
``src/repro/launch/costmodel.py``.

* :func:`step_cost` counts the GLOBAL step, un-sharded, as the reference
  walks the global jaxpr: it runs ``fn`` under a ``TorchDispatchMode``
  (on fake tensors, so nothing is allocated) and charges every aten op it
  dispatches.  Products (mm, bmm, addmm, baddbmm, and the einsums and
  matmuls that lower to them) cost 2·M·N·K·batch FLOPs, from
  ``torch.utils.flop_counter``'s formulas; every other op one FLOP per
  output element.  Bytes are the reference's structural HBM-traffic
  model: a product's operands and result, the results of gather / index /
  scatter / cat / pad, and elementwise results, each charged once
  (fusion-blind: an over-estimate for fused elementwise chains).  Views,
  reshapes, transposes, dtype casts, copies and fills cost nothing, as
  the reference's ``_ELTWISE_SKIP`` says.  Eager torch runs every loop
  trip, so trip counts come out right with no rule for loops.

* :func:`collective_bytes` counts, per device, the result bytes of each
  c10d functional collective that DTensor issues in the SHARDED step (the
  reference counts result-shape bytes of each collective in the compiled
  per-device HLO), by kind: ``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``.  The
  reference's HLO parser (``hlo_collective_bytes``) has no counterpart:
  there is no HLO, and this counter replaces it.

:class:`StepTracker` does both counts and also the sharded step's memory:
the local bytes that are live at each op, from which the dry run takes
its peak.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# free: views, casts, copies, fills and creations (the reference's
# broadcast_in_dim, reshape, transpose, squeeze, convert_element_type,
# slice, iota, copy, stop_gradient, bitcast_convert_type)
_FREE = {
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.permute,
    aten.transpose, aten.t, aten.squeeze, aten.unsqueeze, aten.slice,
    aten.select, aten.as_strided, aten.alias, aten.detach, aten.split,
    aten.split_with_sizes, aten.unbind, aten.narrow, aten.view_as_real,
    aten.view_as_complex, aten.unfold, aten.lift_fresh, aten._to_copy,
    aten.clone, aten.copy_, aten.copy, aten.fill_, aten.zero_, aten.empty,
    aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.zeros, aten.zeros_like, aten.new_zeros,
    aten.ones, aten.ones_like, aten.new_ones, aten.full, aten.full_like,
    aten.new_full, aten.arange, aten.scalar_tensor, aten.lift_fresh_copy,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
}
# charged their result bytes only (the reference's gather / take /
# dynamic_slice / dynamic_update_slice / scatter / concatenate / pad)
_MOVE = {
    aten.gather, aten.index, aten.index_select, aten.embedding,
    aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
    aten.index_put, aten.index_put_, aten.index_add, aten.index_add_,
    aten.cat, aten.stack, aten.constant_pad_nd, aten.pad,
    aten.embedding_dense_backward, aten.slice_scatter, aten.select_scatter,
    aten.index_copy, aten.index_copy_,
}

_c10d = torch.ops._c10d_functional
# result bytes of each collective DTensor issues, by the reference's kind
COLLECTIVES = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.all_gather_into_tensor_coalesced: "all-gather",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_coalesced: "all-reduce",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepTracker(TorchDispatchMode):
    """Counts FLOPs and bytes of every op it dispatches, the result bytes
    of every c10d functional collective by kind, and the bytes of local
    storages that are live, op by op.

    An op on DTensors is left to DTensor (the mode answers
    ``NotImplemented``), so the mode sees its local ops and the
    collectives that redistribute its operands: under DTensor every count
    is one device's.  Storages registered with :meth:`hold` (the step's
    arguments) are not counted as new; every other storage an op returns
    counts from its first appearance until it is freed."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0          # the products' share of ``flops``
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        # collective bytes by the DTensor op whose operands they re-laid
        # out (the op last seen on DTensors), to read where traffic is from
        self.collectives_by_op: Dict[str, float] = {}
        self._dtensor_op = "(outside any op)"
        self._booking = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._held = set()
        self._refs = {}
        self.paused = 0               # > 0: ops pass uncounted

    @contextlib.contextmanager
    def booking(self, name: str):
        """Collectives inside are booked under ``name`` in
        ``collectives_by_op`` (e.g. an explicit redistribute)."""
        prev, self._dtensor_op = self._dtensor_op, name
        self._booking += 1
        try:
            yield
        finally:
            self._booking -= 1
            self._dtensor_op = prev

    @contextlib.contextmanager
    def pause(self):
        """Ops run inside are not the step's (e.g. DTensor working out an
        output's global shape on a placeholder of that shape)."""
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    # ------------------------------------------------------------ memory
    def hold(self, tensors) -> int:
        """Mark the storages of ``tensors`` (DTensors: their local shards)
        as the step's arguments; returns their bytes, each storage once."""
        total = 0
        for t in tensors:
            st = _local(t).untyped_storage()
            if st._cdata not in self._held:
                self._held.add(st._cdata)
                total += st.nbytes()
        return total

    def new_bytes(self, tensors) -> int:
        """Bytes of the storages of ``tensors`` that are not arguments."""
        seen = set()
        for t in tensors:
            st = _local(t).untyped_storage()
            if st._cdata not in self._held:
                seen.add((st._cdata, st.nbytes()))
        return sum(n for _, n in seen)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held or key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key))

    def _free(self, key, _ref) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            if not (self.paused or self._booking):
                self._dtensor_op = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in COLLECTIVES:
            kind = COLLECTIVES[packet]
            n = sum(map(_nbytes, outs))
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            self.collectives_by_op[self._dtensor_op] = (
                self.collectives_by_op.get(self._dtensor_op, 0) + n)
        elif packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.dot_flops += f
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)) + outs))
        elif packet in _MOVE:
            self.bytes += sum(map(_nbytes, outs))
        elif packet not in _FREE and packet is not _c10d.wait_tensor:
            self.flops += sum(t.numel() for t in outs)
            self.bytes += sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def step_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes", "dot_flops"} of ``fn(*args, **kwargs)``: the
    global step, on plain (fake) tensors with no sharding rules active;
    ``dot_flops`` is the products' share of ``flops``."""
    with StepTracker() as tr:
        fn(*args, **kwargs)
    return {"flops": tr.flops, "bytes": tr.bytes, "dot_flops": tr.dot_flops}


def collective_bytes(fn, *args, **kwargs) -> Dict[str, float]:
    """{kind: bytes} per device of the collectives of ``fn(*args,
    **kwargs)``, the sharded step on DTensors."""
    with StepTracker() as tr:
        fn(*args, **kwargs)
    return dict(tr.collectives)
