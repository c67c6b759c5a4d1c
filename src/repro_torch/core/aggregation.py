"""Aggregate stage of the federated pipeline (select -> local-update ->
transform -> **aggregate** -> server-update): pluggable cross-client
reduction topologies behind one tiny protocol; the counterpart of
``src/repro/core/aggregation.py``.

The JAX package shards the client axis of a round over a device ``Mesh``
with ``shard_map`` and sums with ``psum``.  Here the mesh is one process
per rank of a ``torch.distributed`` process group (multi-process SPMD):
every rank runs the same round program on the same global round inputs,
computes its own contiguous block of the client axis, and the collective
is ``dist.all_reduce`` over a process group.  A :class:`ClientMesh` holds
the axis names, their sizes, this rank's coordinates and the process
groups of its axes; an :class:`Aggregator` turns per-rank weighted sums
into the global sum.  The weighting math lives in
``core/fedavg.py::_weighted_sums``, shared by every topology.

``flat`` (:class:`FlatAggregator`)
    One ``all_reduce`` over the 1-D ``clients`` axis: edge->cloud upload and
    cloud aggregation in one step.
``hierarchical`` (:class:`HierarchicalAggregator`)
    Two-level edge->region->cloud reduction over a 2-D ``(region,
    clients)`` mesh: an ``all_reduce`` within the rank's region (the
    ranks of one region), then one across regions (the ranks at the same
    position in every region), the reference's psum order.  Rank
    ``r * C + c`` holds block ``r * C + c`` of the leading client axis, as
    ``P((region, clients))`` lays it out.
``local`` (:class:`LocalAggregator`)
    No mesh: the round runs every client in one process, the sums are
    already global and the collective is the identity.

**Linearity contract (mask cancellation).**  ``reduce`` MUST be a plain
linear sum of the per-rank values (all_reduce / all_reduce of all_reduce /
identity): no clipping, averaging or reordering beyond float summation
order.  Secure aggregation (``core/secure_agg.py``) relies on it: the
pairwise masks of a dispatch cohort sum to zero however the cohort is
split over ranks, so they cancel in ``reduce`` on every topology (on the
ring exactly, since the uploads are integers).

Backends: gloo on the CPU, NCCL on the card (one rank per card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.analysis import taint
from repro_torch.configs.base import AggregationConfig, FLConfig


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """The ranks of a round as a named grid, the counterpart of a JAX
    ``Mesh`` of devices: ``axis_names`` and their sizes (``shape``, axis ->
    size, in axis order), this rank's ``coords`` (axis -> index), and the
    process group of each axis that this rank belongs to (``groups``;
    ``None`` where no process group is initialised, a one-rank mesh whose
    reduce is the identity).  The rank at coordinates ``(r, c)`` of a
    ``(region, clients)`` grid is the default group's rank ``r * C + c``.
    """
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]

    @property
    def size(self) -> int:
        """Ranks in the mesh (the JAX package's ``n_dev``)."""
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    @property
    def index(self) -> int:
        """This rank's block of the leading client axis: its coordinates in
        row-major axis order."""
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + self.coords[a]
        return i

    @property
    def distributed(self) -> bool:
        return any(g is not None for g in self.groups.values())

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
        group = self.groups[axis]
        if group is None:
            return x
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on every rank), stacked along a
        new leading axis in block order, on the host.  Under gloo the rows
        cross through host memory; under NCCL on the card."""
        if not self.distributed:
            return x.cpu()[None]
        if dist.get_backend() == "gloo":
            x = x.cpu()
        world = dist.get_world_size()
        out = x.new_empty((world * x.numel(),))
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1))
        return out.cpu().reshape((world,) + tuple(x.shape))


class Aggregator(Protocol):
    """Reduction topology for the aggregate stage."""

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        """Mesh axis names this topology reduces over (() = no mesh)."""
        ...

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum one per-rank tensor across all client ranks.

        Must be a LINEAR sum (see the module's mask-cancellation contract):
        secure-aggregation masks cancel in this reduction.
        """
        ...


@dataclasses.dataclass(frozen=True)
class LocalAggregator:
    """No mesh: sums are already global, the collective is the identity."""

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return ()

    def reduce(self, x):
        # the identity, but still THE cross-client boundary of the local
        # round: flcheck checks sanitization here (production no-op)
        return taint.boundary(x)


@dataclasses.dataclass(frozen=True, eq=False)
class FlatAggregator:
    """One all_reduce over the 1-D ``clients`` axis of ``mesh``."""
    mesh: ClientMesh
    client_axis: str = "clients"

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return (self.client_axis,)

    def reduce(self, x):
        return self.mesh.all_reduce(taint.boundary(x), self.client_axis)


@dataclasses.dataclass(frozen=True, eq=False)
class HierarchicalAggregator:
    """Two-level edge->region->cloud reduction on a 2-D (region, clients)
    mesh: an all_reduce within each region (edge aggregation), then one
    across regions (cloud aggregation)."""
    mesh: ClientMesh
    region_axis: str = "region"
    client_axis: str = "clients"

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return (self.region_axis, self.client_axis)

    def reduce(self, x):
        regional = self.mesh.all_reduce(taint.boundary(x),
                                        self.client_axis)    # edge->region
        return self.mesh.all_reduce(regional, self.region_axis)  # ->cloud


def _as_agg_config(cfg) -> AggregationConfig:
    if cfg is None:
        return AggregationConfig()
    if isinstance(cfg, FLConfig):
        return cfg.aggregation_config
    if isinstance(cfg, str):
        return AggregationConfig(kind=cfg)
    return cfg


def make_aggregator(cfg: Union[FLConfig, AggregationConfig, str, None],
                    mesh: Optional[ClientMesh] = None) -> Aggregator:
    """Resolve the aggregate stage: config (or kind name) + mesh ->
    Aggregator.

    ``mesh=None`` always yields the :class:`LocalAggregator`.  With a mesh,
    the topology's axis names are validated against the mesh's eagerly, so
    a flat engine handed a 2-D mesh (or vice versa) fails at construction.
    """
    cfg = _as_agg_config(cfg)
    if mesh is None:
        return LocalAggregator()
    agg: Aggregator = (FlatAggregator(mesh) if cfg.kind == "flat"
                       else HierarchicalAggregator(mesh))
    missing = [a for a in agg.mesh_axes if a not in mesh.axis_names]
    if missing or len(mesh.axis_names) != len(agg.mesh_axes):
        raise ValueError(
            f"{cfg.kind!r} aggregation needs mesh axes {agg.mesh_axes}, got "
            f"mesh axes {tuple(mesh.axis_names)} — build the mesh with "
            f"aggregation.make_mesh(cfg)")
    return agg


def make_mesh(cfg: Union[AggregationConfig, FLConfig, None] = None
              ) -> ClientMesh:
    """Build the rank mesh an ``AggregationConfig`` asks for over the
    initialised default process group (``dist.init_process_group``).

    Flat -> 1-D ``(clients,)`` over all ranks.  Hierarchical -> 2-D
    ``(region, clients)`` with ``n_regions`` region groups (``n_regions=0``
    picks the largest divisor of the world size that is <= sqrt(world),
    so 8 ranks become the 2x4 edge/region grid).  Every rank must call it,
    in the same order: it creates every region group and every
    cross-region group on every rank (``dist.new_group`` is collective),
    and keeps the two this rank belongs to.

    With no process group initialised it gives a one-rank mesh whose
    reduce is the identity: the counterpart of a one-device JAX mesh.
    """
    cfg = _as_agg_config(cfg)
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    if cfg.kind == "flat":
        return ClientMesh(("clients",), {"clients": world},
                          {"clients": rank},
                          {"clients": dist.group.WORLD if live else None})
    r = cfg.n_regions
    if r == 0:
        r = max(d for d in range(1, int(world ** 0.5) + 1) if world % d == 0)
    if world % r:
        raise ValueError(f"n_regions={r} does not divide the world size "
                         f"{world}")
    c = world // r
    groups: Dict[str, Optional[object]] = {"region": None, "clients": None}
    if live:
        # collective on every rank, in one order: each region's ranks (the
        # edge reduction), then each position's ranks across regions
        edge = [dist.new_group([i * c + j for j in range(c)])
                for i in range(r)]
        cloud = [dist.new_group([i * c + j for i in range(r)])
                 for j in range(c)]
        groups = {"region": cloud[rank % c], "clients": edge[rank // c]}
    return ClientMesh(("region", "clients"), {"region": r, "clients": c},
                      {"region": rank // c, "clients": rank % c}, groups)
