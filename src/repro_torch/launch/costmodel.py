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
  the reference's ``_ELTWISE_SKIP`` says.

* The trip-count rule: the model's loops of identical trips (the sLSTM's
  steps, a stack's identical layers, the microbatches) run through
  ``models.scan.loop``, the port's ``lax.scan``.  Eager torch runs every
  trip; a tracker made with ``trip_rule=True`` answers a loop on fake
  tensors (the dry run) with three trips, the first, the second and the
  last, and counts the second once for every trip between the first and
  the last, as the reference's ``jaxpr_cost`` multiplies a scan body by
  its ``length``.  The counts of the backward follow: each autograd node
  that a trip made is marked with the trip's multiplier, and an op that
  a node's backward dispatches is charged at it; the skipped trips'
  outputs are the second trip's, detached, so that its backward takes
  one gradient.  The memory model stays that of the unrolled loop: a storage
  that the first trip made and that the second trip's twin of it finds
  still live at the end is one that every trip adds (a saved input, an
  output row), and counts once more for every trip the rule skips, until
  it is freed; a loop's collected outputs are stacked at full size.

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
import difflib
import functools
import weakref
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.models import scan
from repro_torch.sharding import rules

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
    counts from its first appearance until it is freed.

    While it is open it books the collectives of ``rules.all_reduce``
    (``rules.BOOKERS``) and, made with ``trip_rule=True``, answers the
    model's loops on fake tensors (``scan.HOOKS``, the module's
    docstring)."""

    def __init__(self, trip_rule: bool = False):
        super().__init__()
        self.trip_rule = trip_rule    # three trips of a loop, not all
        self.mult = 1                 # trips each forward op stands for
        self._trips: List[_Trip] = []         # open trips, innermost last
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

    def __enter__(self):
        rules.BOOKERS.append(self.booking)
        scan.HOOKS.append(self._loop)
        return super().__enter__()

    def __exit__(self, *exc):
        scan.HOOKS.remove(self._loop)
        rules.BOOKERS.remove(self.booking)
        return super().__exit__(*exc)

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
        ref = weakref.ref(st, functools.partial(self._free, key))
        self._refs[key] = ref
        for trip in self._trips:
            trip.made.append((key, ref))
        self._raise_peak(self.live)

    def _raise_peak(self, live) -> None:
        self.peak = max(self.peak, live)
        for trip in self._trips:
            trip.peak = max(trip.peak, live)

    def _free(self, key, _ref) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)

    # ------------------------------------------------------------ loops
    def _alive(self, key, ref) -> bool:
        return self._refs.get(key) is ref

    def _loop(self, n: int, body, carry):
        """``scan.HOOKS``' entry: a loop of more than three trips on fake
        tensors under the rule, else None (every trip runs)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        if n > 3 and self.trip_rule and any(
                isinstance(m, FakeTensorMode)
                for m in _get_current_dispatch_mode_stack()):
            return self.run_loop(n, body, carry)
        return None

    def _trip(self, body, i, carry, mult):
        """Trip ``i`` of a loop, each of its ops standing for ``mult``
        trips; returns (carry, y, the trip's record).  A trip of the
        forward marks the autograd nodes it made (:func:`_mark`)."""
        forward = not _in_backward()
        trip = _Trip(self.live, self._node_seq() if forward else None)
        outer, self.mult = self.mult, mult
        self._trips.append(trip)
        try:
            carry, y = body(i, carry)
        finally:
            self._trips.pop()
            self.mult = outer
        if forward:
            _mark((carry, y), trip.first, self._node_seq(), mult)
        return carry, y, trip

    def run_loop(self, n: int, body, carry):
        """A loop under the trip-count rule (``n`` > 3): the first and
        the last trip counted once, the second for the ``n`` - 2 between
        (the first takes the loop's input, the last's backward the
        gradient from past the loop: either may differ)."""
        outer = self._mult_now()
        carry, y0, t0 = self._trip(body, 0, carry, outer)
        carry, y1, t1 = self._trip(body, 1, carry, outer * (n - 2))
        carry, y2, t2 = self._trip(body, n - 1, carry, outer)
        # the storages of trips 0 and 1 still live, paired in order by
        # size (a trip may make what the other does not: a cache filled
        # once, a carry that the next trip replaces)
        kept0 = [k for k, r in t0.made if self._alive(k, r)]
        kept1 = [k for k, r in t1.made if self._alive(k, r)]
        match = difflib.SequenceMatcher(
            None, [self._sizes[k] for k in kept0],
            [self._sizes[k] for k in kept1], autojunk=False)
        grown = 0
        for i, j, size in match.get_matching_blocks():
            for k0, k1 in zip(kept0[i:i + size], kept1[j:j + size]):
                # kept by every trip: trip 0's stands for the n - 3 more
                extra = (n - 3) * self._sizes[k1]
                self._sizes[k0] += extra
                grown += extra
        self.live += grown
        self._raise_peak(t2.peak + grown)
        # the skipped trips' outputs: trip 1's, cut from its graph, whose
        # backward takes one gradient and counts it for them all
        cut = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                       else t, y1)
        return carry, [y0, y1] + [cut] * (n - 3) + [y2]

    def _node_seq(self) -> int:
        """The sequence number the next autograd node made on this
        thread will get (one past a scratch node's)."""
        with self.pause(), torch.enable_grad():
            probe = torch.zeros((), requires_grad=True) * 1
        return probe.grad_fn._sequence_nr() + 1

    def _mult_now(self) -> int:
        """The trips the op being dispatched stands for: in a backward,
        the multiplier marked on the node it runs, unless a loop that
        the backward opened is running (its trips set ``mult``); an
        unmarked node was made outside any finished trip, at ``mult``."""
        node = torch._C._current_autograd_node()
        if node is None or (self._trips and self._trips[-1].first is None):
            return self.mult
        return node.metadata.get("trip_mult", self.mult)

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
        m = self._mult_now()
        if packet in COLLECTIVES:
            kind = COLLECTIVES[packet]
            n = sum(map(_nbytes, outs)) * m
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            self.collectives_by_op[self._dtensor_op] = (
                self.collectives_by_op.get(self._dtensor_op, 0) + n)
        elif packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out) * m
            self.flops += f
            self.dot_flops += f
            self.bytes += sum(map(_nbytes,
                                  _tensors((args, kwargs)) + outs)) * m
        elif packet in _MOVE:
            self.bytes += sum(map(_nbytes, outs)) * m
        elif packet not in _FREE and packet is not _c10d.wait_tensor:
            self.flops += sum(t.numel() for t in outs) * m
            self.bytes += sum(map(_nbytes, outs)) * m
        for t in outs:
            self._track(t)
        return out


class _Trip:
    """One open trip of a loop: the storages it made, in order, and the
    peak of live bytes while it ran."""

    def __init__(self, live, first):
        self.made: List[tuple] = []
        self.peak = live
        self.first = first          # the seq of its first node (None: in
        #                             a backward, on another thread)


def _mark(outs, first: int, last: int, mult: int) -> None:
    """Mark the autograd nodes behind ``outs`` that a trip made (sequence
    numbers in [``first``, ``last``)) with its multiplier; the nodes of a
    loop inside the trip keep their own."""
    todo = [t.grad_fn for t in _tensors(outs) if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or not (
                first <= node._sequence_nr() < last):
            continue
        seen.add(node)
        node.metadata.setdefault("trip_mult", mult)
        todo.extend(f for f, _ in node.next_functions)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def step_cost(fn, *args, trip_rule: bool = False, **kwargs
              ) -> Dict[str, float]:
    """{"flops", "bytes", "dot_flops"} of ``fn(*args, **kwargs)``: the
    global step, on plain (fake) tensors with no sharding rules active;
    ``dot_flops`` is the products' share of ``flops``.  ``trip_rule``:
    the model's loops run three trips each on fake tensors."""
    with StepTracker(trip_rule) as tr:
        fn(*args, **kwargs)
    return {"flops": tr.flops, "bytes": tr.bytes, "dot_flops": tr.dot_flops}


def collective_bytes(fn, *args, **kwargs) -> Dict[str, float]:
    """{kind: bytes} per device of the collectives of ``fn(*args,
    **kwargs)``, the sharded step on DTensors."""
    with StepTracker() as tr:
        fn(*args, **kwargs)
    return dict(tr.collectives)
