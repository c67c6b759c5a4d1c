"""Level-1 flcheck: dataflow taint for the federated round bodies; the
counterpart of ``src/repro/analysis/taint.py``.

**The contract being proved**: a per-client update delta may only cross a
shard boundary (a cross-rank collective, or the local path's cross-client
reduction) after flowing through EVERY transform stage the config enables
(clip -> noise -> quantize -> mask).  Numeric tests pin that the stages
behave; this pass proves the dataflow, per config and topology, on the
round the port really runs.

**How.**  The production pipeline carries three markers:

* :func:`tag_private` on the local models after the local update
  (``core/fedavg.py::pipeline_round``, ``core/async_engine.py::
  client_deltas``),
* :func:`declassify` at each transform stage's output
  (``core/transforms.py``, ``core/secure_agg.py``), labelled ``clip`` /
  ``noise`` / ``quantize`` / ``mask`` and optionally declaring the wire
  encoding the stage leaves the upload in,
* :func:`boundary` on every aggregator's reduce input
  (``core/aggregation.py``) and on the semi-sync dispatch's uploads.

In production they return their argument, the same object: no op, no copy.
The JAX package interprets a jaxpr; the port runs eagerly, so the analysis
runs the REAL round under :class:`TaintTracer`, a ``TorchDispatchMode``
that sees every aten op.  Labels live in a side table keyed by tensor
storage, so views and in-place ops keep them.  Each op gives its outputs
the join of its tainted inputs (labels = intersection: mixing a masked and
an unmasked delta is only as sanitized as the weaker one; the wire widens
to the widest), an in-place op writes the join onto its target, and a
``boundary`` or a raw collective (``c10d.allreduce_`` and friends, which
``dist.all_reduce`` dispatches) reached with a required label missing is
a violation.  Loops are unrolled by running them, so the reference's scan
fixpoint is a plain walk.

**Fail closed.**  The dispatcher does not see a ctypes kernel launch
(``kernels/_cuda.py::launch``), nor ``.numpy()`` on a CPU tensor, so taint
could leak through either.  The tracer rules both out: a tainted value
that lacks a required label and is read to the host (``.item()``, a copy
to the CPU) is a violation; a tensor entering an op whose storage aliases
a tainted storage it does not carry the taint of (``from_numpy`` of a
``.numpy()`` view) is a violation and carries the taint on; and the report
records the kernel launches made after the first ``tag_private``, each one
a violation (the local update launches them all before it).

**What this does and does not prove**: marker placement relative to the
boundaries on the run dataflow, for the run config and topology; not the
transforms' numerics (the tests pin those), and not values never tagged
(the weighted scalar loss release, the accepted disclosure).

Import-light: ``repro_torch.core`` imports this module for the markers,
so nothing here imports ``repro_torch.core`` at module level.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Dict, FrozenSet, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PyTree = Any
aten = torch.ops.aten

# the tracer of the running analysis; None in production
_ACTIVE: Optional["TaintTracer"] = None


# --------------------------------------------------------------- markers
def tag_private(tree: PyTree) -> PyTree:
    """Mark a per-client value tree as the private taint source."""
    if _ACTIVE is not None:
        _ACTIVE.source(tree)
    return tree


def declassify(tree: PyTree, label: str,
               wire: Optional[str] = None) -> PyTree:
    """Record that ``tree`` passed the transform stage ``label``.

    ``wire`` optionally declares the WIRE ENCODING the stage leaves the
    upload in (``"int8+scale"`` for the quantizer's int grid plus one fp32
    scale a leaf, ``"float32"`` for a stage that re-widens).  The level-3
    cost auditor (``analysis/costs.py``) reads it off the boundary
    crossings; ``wire=None`` keeps whatever encoding the value carried
    (``None`` = raw fp32)."""
    if _ACTIVE is not None:
        _ACTIVE.declassify(tree, label, wire)
    return tree


def boundary(tree: PyTree) -> PyTree:
    """Mark a shard-boundary crossing (aggregator reductions, or the
    semi-sync path's per-client uploads leaving the round body)."""
    if _ACTIVE is not None:
        _ACTIVE.boundary(tree)
    return tree


# ------------------------------------------------------------ the lattice
@dataclasses.dataclass(frozen=True)
class Taint:
    """Labels of the sanitizer stages this value has passed through, plus
    the declared wire encoding (``None`` = undeclared, i.e. raw fp32)."""
    labels: FrozenSet[str]
    wire: Optional[str] = None


def _wire_rank(wire: Optional[str]) -> int:
    """Width order of wire declarations: an ``int<k>+scale`` grid is
    narrower than an undeclared / float32 payload; mixing widens."""
    if wire and wire.startswith("int") and wire.endswith("+scale"):
        try:
            return int(wire[3:-len("+scale")])
        except ValueError:
            return 1 << 10
    return 1 << 10


def _join_wire(a: Optional[str], b: Optional[str]) -> Optional[str]:
    return a if _wire_rank(a) >= _wire_rank(b) else b


def _join(taints: Sequence[Optional[Taint]]) -> Optional[Taint]:
    """Tainted if ANY operand is; labels = intersection over the tainted
    ones; the wire widens to the widest tainted operand."""
    labels: Optional[FrozenSet[str]] = None
    wire: Optional[str] = None
    for t in taints:
        if t is None:
            continue
        if labels is None:
            labels, wire = t.labels, t.wire
        else:
            labels, wire = labels & t.labels, _join_wire(wire, t.wire)
    return None if labels is None else Taint(labels, wire)


@dataclasses.dataclass(frozen=True)
class Crossing:
    """One boundary / collective operand the tracer saw: the raw material
    of the level-3 cost audit (``analysis/costs.py``)."""
    primitive: str
    shape: tuple
    dtype: str
    tainted: bool
    labels: Optional[FrozenSet[str]] = None
    wire: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TaintViolation:
    primitive: str
    missing: FrozenSet[str]
    applied: FrozenSet[str]

    def render(self) -> str:
        return (f"tainted value reaches {self.primitive} with stages "
                f"{sorted(self.applied)} applied but "
                f"{sorted(self.missing)} missing")


@dataclasses.dataclass
class TaintReport:
    required: FrozenSet[str]
    violations: List[TaintViolation]
    checked: int       # boundary / collective operands that were tainted
    sources: int       # leaves tagged by tag_private
    crossings: List[Crossing] = dataclasses.field(default_factory=list)
    # kernel launches of the traced round before / after the first source
    launches_before_source: int = 0
    launches_after_source: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def proved(self) -> bool:
        """True when the pass proved something: the source was reached, a
        tainted value crossed a checked boundary, and every crossing
        carried every required label."""
        return self.ok and self.sources > 0 and self.checked > 0

    def render(self) -> str:
        state = ("PROVED" if self.proved
                 else ("VACUOUS" if self.ok else "VIOLATED"))
        head = (f"taint {state}: required={sorted(self.required)} "
                f"sources={self.sources} tainted-crossings={self.checked} "
                f"launches before/after source="
                f"{self.launches_before_source}/"
                f"{self.launches_after_source}")
        return "\n".join([head] + ["  " + v.render()
                                   for v in self.violations])


# ------------------------------------------------------------- the tracer
_c10d = torch.ops.c10d
_c10d_f = torch.ops._c10d_functional
# cross-rank collectives checked beside the boundary markers
COLLECTIVES = frozenset({
    _c10d.allreduce_, _c10d.allreduce_coalesced_, _c10d.allgather_,
    _c10d._allgather_base_, _c10d.allgather_into_tensor_coalesced_,
    _c10d.reduce_scatter_, _c10d._reduce_scatter_base_, _c10d.broadcast_,
    _c10d.alltoall_, _c10d.alltoall_base_, _c10d.gather_, _c10d.scatter_,
    _c10d.reduce_, _c10d.send, _c10d_f.all_reduce,
    _c10d_f.all_gather_into_tensor, _c10d_f.reduce_scatter_tensor,
    _c10d_f.all_to_all_single,
})


def _launch_total() -> int:
    from repro_torch.kernels import _cuda
    return sum(_cuda.LAUNCHES.values())


def copies_to_host(func, args, kwargs) -> bool:
    """Whether the aten call copies device data to the CPU."""
    packet = func._overloadpacket
    if packet not in (aten._to_copy, aten.copy_):
        return False
    src = args[1] if packet is aten.copy_ else args[0]
    dst = args[0].device if packet is aten.copy_ else kwargs.get("device")
    return (dst is not None and torch.device(dst).type == "cpu"
            and src.device.type != "cpu")


def _is_host_read(func, args, kwargs) -> bool:
    """A read of tensor data into host memory: a Python scalar, or a copy
    from the device."""
    return (func._overloadpacket is aten._local_scalar_dense
            or copies_to_host(func, args, kwargs))


class TaintTracer(TorchDispatchMode):
    """Propagates taint through every aten op of the round it runs; see
    the module docstring.  ``with TaintTracer(required) as tr: ...`` then
    :meth:`report`."""

    def __init__(self, required: FrozenSet[str]):
        super().__init__()
        self.required = frozenset(required)
        self.violations: List[TaintViolation] = []
        self.crossings: List[Crossing] = []
        self.checked = 0
        self.sources = 0
        self._taint: Dict[int, Taint] = {}
        self._ptr: Dict[int, int] = {}     # data_ptr -> storage key
        self._refs: Dict[int, Any] = {}
        self._launches0 = 0
        self._launches1: Optional[int] = None
        self._launches_at_source: Optional[int] = None

    # ---- the side table ----------------------------------------------
    def _key(self, t: torch.Tensor):
        st = t.untyped_storage()
        return st._cdata, st

    def _get(self, t: torch.Tensor) -> Optional[Taint]:
        key, st = self._key(t)
        hit = self._taint.get(key)
        if hit is None:
            alias = self._ptr.get(st.data_ptr()) if st.data_ptr() else None
            if alias is not None and alias != key:
                hit = self._taint.get(alias)
                if hit is not None:
                    # a host alias of a tainted storage re-entering
                    self._violate("host_alias", hit)
        return hit

    def _set(self, t: torch.Tensor, taint: Taint) -> None:
        key, st = self._key(t)
        if key not in self._refs:
            self._refs[key] = weakref.ref(
                st, functools.partial(self._drop, key, st.data_ptr()))
            if st.data_ptr():
                self._ptr[st.data_ptr()] = key
        self._taint[key] = taint

    def _drop(self, key, ptr, _ref) -> None:
        self._taint.pop(key, None)
        self._refs.pop(key, None)
        if self._ptr.get(ptr) == key:
            del self._ptr[ptr]

    def _violate(self, prim: str, taint: Taint) -> None:
        missing = self.required - taint.labels
        if missing:
            self.violations.append(
                TaintViolation(prim, frozenset(missing), taint.labels))

    def _check(self, prim: str, tensors: Sequence[torch.Tensor]) -> None:
        joined = _join([self._get(t) for t in tensors])
        for t in tensors:
            self.crossings.append(Crossing(
                prim, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                joined is not None,
                None if joined is None else joined.labels,
                None if joined is None else joined.wire))
        if joined is not None:
            self.checked += 1
            self._violate(prim, joined)

    # ---- the markers ---------------------------------------------------
    def source(self, tree) -> None:
        if self._launches_at_source is None:
            self._launches_at_source = _launch_total()
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self.sources += 1
                self._set(t, Taint(frozenset()))

    def declassify(self, tree, label: str, wire: Optional[str]) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                old = self._get(t)
                if old is not None:
                    self._set(t, Taint(old.labels | {label},
                                       old.wire if wire is None else wire))

    def boundary(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._check("boundary", [t])

    # ---- dispatch --------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        self._launches0 = _launch_total()
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        self._launches1 = _launch_total()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func._overloadpacket in COLLECTIVES:
            self._check(str(func._overloadpacket), ins)
        joined = _join([self._get(t) for t in ins])
        if joined is not None and _is_host_read(func, args, kwargs):
            self._violate(f"host_read:{func._overloadpacket.__name__}",
                          joined)
        out = func(*args, **kwargs)
        if joined is not None:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._set(t, joined)
        return out

    def report(self) -> TaintReport:
        at = self._launches_at_source
        end = _launch_total() if self._launches1 is None else self._launches1
        before = (end if at is None else at) - self._launches0
        after = 0 if at is None else end - at
        violations = list(self.violations)
        if after:
            violations.append(TaintViolation(
                f"kernel_launch x{after} after the source",
                self.required | {"(invisible to the tracer)"},
                frozenset()))
        return TaintReport(self.required, violations, self.checked,
                           self.sources, list(self.crossings), before,
                           after)


def analyze(fn, required: FrozenSet[str], *args, **kwargs) -> TaintReport:
    """Run ``fn(*args, **kwargs)`` under a :class:`TaintTracer` and report
    the sanitize-before-boundary contract for ``required``."""
    with TaintTracer(required) as tr:
        fn(*args, **kwargs)
    return tr.report()


# -------------------------------------------------------- pipeline proofs
def required_labels(tcfg, scfg=None) -> FrozenSet[str]:
    """The stage labels a config demands on every boundary crossing."""
    req = set()
    if tcfg.clip_norm > 0.0:
        req.add("clip")
    if tcfg.noise_multiplier > 0.0:
        req.add("noise")
    if tcfg.quantize_bits:
        req.add("quantize")
    if scfg is not None and scfg.enabled:
        req.add("mask")
    return frozenset(req)


def round_inputs(fcfg, m: int, device, n_win: int = 4, steps: int = 2,
                 batch: int = 2, seed: int = 0):
    """Seeded inputs of one M-client round on ``device``: (params, x, y,
    batch_idx, weights, keys, round_key); keys as ``RoundEngine`` makes
    them (``fold_in(round_key, slot)``)."""
    from repro_torch.core import prng
    from repro_torch.models import forecaster
    from repro_torch.models.layers import seeded_generator, tree_map

    g = seeded_generator(seed, 0)
    params = tree_map(lambda t: t.to(device),
                      forecaster.init_forecaster(g, fcfg))
    x = torch.randn((m, n_win, fcfg.lookback, 1), generator=g).to(device)
    y = torch.randn((m, n_win, fcfg.horizon), generator=g).to(device)
    bidx = torch.randint(0, n_win, (m, steps, batch), generator=g)
    w = torch.ones((m,), dtype=torch.float32, device=device)
    rk = prng.fold_in(prng.PRNGKey(seed), 1)
    keys = prng.fold_in(rk, torch.arange(m, device=device))
    return params, x, y, bidx.to(device), w, keys, rk


def _mode(mode, required):
    return mode if mode is not None else TaintTracer(required)


def trace_pipeline_round(fcfg, tcfg, scfg=None, acfg=None, mesh=None,
                         m: Optional[int] = None, cell_impl: str = "kernel",
                         device=None, mode=None):
    """Run the REAL round (``fedavg.pipeline_round``; on ``mesh``, this
    rank's block of it, reduced over the ranks) under ``mode``, a
    ``TorchDispatchMode`` (default: a :class:`TaintTracer` for the
    config's required labels), and return the mode.  ``m`` clients
    (default 4, or one a rank of ``mesh``); ``device`` defaults to the
    card."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import aggregation, fedavg, losses
    from repro_torch.serving.registry import resolve_device

    device = resolve_device(device)
    m = m or (mesh.size if mesh is not None else 4)
    params, x, y, bidx, w, keys, rk = round_inputs(fcfg, m, device)
    agg, lo, hi, slots = aggregation.LocalAggregator(), 0, m, None
    if mesh is not None:
        agg = aggregation.make_aggregator(acfg or AggregationConfig(), mesh)
        b = m // mesh.size
        lo, hi = mesh.index * b, (mesh.index + 1) * b
        slots = torch.arange(lo, hi, device=device)
    mode = _mode(mode, required_labels(tcfg, scfg))
    with mode:
        fedavg.pipeline_round(params, x[lo:hi], y[lo:hi], bidx[lo:hi],
                              w[lo:hi], keys[lo:hi], 0.05, 0.0, fcfg,
                              losses.make_loss("mse"), tcfg, cell_impl, scfg,
                              rk, agg=agg, slots=slots, w_full=w)
    return mode


def trace_client_deltas(fcfg, tcfg, scfg=None, m: int = 4,
                        cell_impl: str = "kernel", device=None, mode=None):
    """Run the semi-sync dispatch stage (``async_engine.client_deltas``),
    whose boundary is its RETURN, then the move of the uploads into the
    server's host buffer, under ``mode``; return the mode."""
    from repro_torch.core import async_engine, losses
    from repro_torch.serving.registry import resolve_device

    device = resolve_device(device)
    params, x, y, bidx, w, keys, rk = round_inputs(fcfg, m, device)
    mode = _mode(mode, required_labels(tcfg, scfg))
    with mode:
        deltas, _ = async_engine.client_deltas(
            params, x, y, bidx, keys, 0.05, 0.0, fcfg,
            losses.make_loss("mse"), tcfg, cell_impl, scfg, rk, w)
        async_engine._to_host(deltas)
    return mode


TOPOLOGIES = ("vmap", "semi_sync", "flat", "hier")
# ranks of the mesh proofs and audits: flat over 8, hierarchical 2 x 4 (the
# reference's 8-device geometry)
MESH_RANKS = 8


def full_stack():
    """The full transform stack of the proofs: clip 1.0, noise 0.5, 8-bit
    quantize (the ring under masking).  8 bits: the ring reserves one step
    of rounding headroom per cohort member, and an int4 ring holds no
    cohort of 8 (2^3 - 1 - 8 < 1)."""
    from repro_torch.configs.base import TransformConfig
    return TransformConfig(clip_norm=1.0, noise_multiplier=0.5,
                           quantize_bits=8)


def clip_only():
    from repro_torch.configs.base import TransformConfig
    return TransformConfig(clip_norm=1.0)


def secure():
    from repro_torch.configs.base import SecureAggConfig
    return SecureAggConfig(enabled=True)


def verify_pipeline(topology: str, tcfg, scfg=None, fcfg=None,
                    cell_impl: str = "kernel", device=None,
                    m: Optional[int] = None) -> TaintReport:
    """Prove sanitize-before-boundary for one topology x config.

    ``"vmap"``: the local round (``LocalAggregator``: the boundary is the
    cross-client reduction); ``"semi_sync"``: the dispatch stage whose
    returned uploads feed the server's straggler buffer; ``"flat"`` (1-D
    ``clients`` mesh over every rank) and ``"hier"`` (2-D ``(region,
    clients)``, 2 regions): this rank's part of the round, so every rank
    of the initialised process group calls it, in the same order.
    """
    from repro_torch.configs.base import AggregationConfig, ForecasterConfig
    from repro_torch.core import aggregation

    fcfg = fcfg or ForecasterConfig(hidden_dim=8)
    if topology == "semi_sync":
        tr = trace_client_deltas(fcfg, tcfg, scfg, m=m or 4,
                                 cell_impl=cell_impl, device=device)
    elif topology == "vmap":
        tr = trace_pipeline_round(fcfg, tcfg, scfg, m=m,
                                  cell_impl=cell_impl, device=device)
    elif topology in ("flat", "hier"):
        acfg = (AggregationConfig() if topology == "flat" else
                AggregationConfig(kind="hierarchical", n_regions=2))
        mesh = aggregation.make_mesh(acfg)
        if topology == "hier" and mesh.shape["region"] != 2:
            raise ValueError("hier topology needs an even rank count")
        tr = trace_pipeline_round(fcfg, tcfg, scfg, acfg=acfg, mesh=mesh,
                                  m=m, cell_impl=cell_impl, device=device)
    else:
        raise ValueError(f"unknown topology {topology!r} "
                         f"({' | '.join(TOPOLOGIES)})")
    return tr.report()


def mesh_proofs(cases, device=None) -> List[TaintReport]:
    """This rank's :func:`verify_pipeline` report of each ``(topology,
    tcfg, scfg)`` of ``cases``; every rank calls it in the same order."""
    return [verify_pipeline(topo, tcfg, scfg, device=device)
            for topo, tcfg, scfg in cases]


def _rank_main(rank, world, tmp_dir, fn, args):
    import datetime
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_dir}/pg_init", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = fn(*args)
        with open(f"{tmp_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def on_ranks(fn, world: int, *args, timeout_s: float = 900.0) -> List[Any]:
    """``fn(*args)`` on each of ``world`` gloo ranks spawned here (a file
    rendezvous in a temporary directory); returns each rank's result in
    rank order.  A rank that fails raises here; ranks still running after
    ``timeout_s`` are killed and the call raises ``TimeoutError``.
    ``fn`` must be importable by name (a module-level function)."""
    import pickle
    import tempfile
    import time

    import torch.multiprocessing as tmp

    with tempfile.TemporaryDirectory() as d:
        ctx = tmp.start_processes(_rank_main, args=(world, d, fn, args),
                                  nprocs=world, join=False,
                                  start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.05)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout_s} s")
        out = []
        for r in range(world):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
