"""Local-SGD / DiLoCo-style periodic aggregation: the paper's FedAvg
schedule as a cross-pod training feature; the counterpart of
``src/repro/core/local_sgd.py``.

FedAvg is local SGD with an H-step communication period.  Pods train on
their own for H inner steps; then their parameters are averaged across
pods, optionally through an outer Nesterov optimizer (DiLoCo), so the
cross-pod traffic is 1/H of per-step synchronization.

The pod axis is either

* a leading axis of stacked replicas in one process (``axis`` an int, 0
  by default): every leaf of ``params`` is (n_pods, ...), and the
  cross-pod mean is a sum over that axis divided by its size; or
* a ``torch.distributed`` process group (``axis`` the group, e.g.
  ``dist.group.WORLD`` or one axis group of
  ``core.aggregation.make_mesh``'s mesh): each rank holds its pod's tree,
  and the mean is an ``all_reduce`` sum divided by the group's size, the
  reference's ``pmean``.

The anchor and the momentum are shared by every pod (replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_map

PodAxis = Union[int, Any]          # a stacked axis, or a process group


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    inner_steps: int = 20          # H: steps between cross-pod syncs
    outer_lr: float = 0.7          # DiLoCo outer learning rate
    outer_momentum: float = 0.9    # Nesterov momentum on the outer delta
    nesterov: bool = True


class OuterState(NamedTuple):
    anchor: Any                    # params at the last sync (the "global" model)
    momentum: Any                  # outer momentum buffer


def init_outer_state(params) -> OuterState:
    """The anchor is a copy of ``params``: the port trains in place, so an
    alias would move with the pods."""
    return OuterState(anchor=tree_map(torch.clone, params),
                      momentum=tree_map(torch.zeros_like, params))


def pod_mean(t, axis: PodAxis = 0):
    """The mean of ``t`` across pods: over the stacked ``axis``, or across
    the ranks of the process group ``axis``."""
    if isinstance(axis, int):
        return t.sum(axis) / t.shape[axis]
    s = t.clone()
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=axis)
    return s / dist.get_world_size(axis)


def outer_step(params, state: OuterState, cfg: LocalSGDConfig,
               axis: PodAxis = 0) -> Tuple[Any, OuterState]:
    """Cross-pod sync: average the per-pod parameter drift and apply it to
    the anchor with an outer Nesterov optimizer.  With outer_lr=1,
    momentum=0 this is FedAvg over pods (paper Alg. 1: w <- mean(w_i)),
    up to the rounding of ``anchor - mean(anchor - w_i)``."""
    delta = tree_map(lambda p, a: pod_mean(a - p, axis), params,
                     state.anchor)                       # anchor - local
    m = tree_map(lambda mom, d: cfg.outer_momentum * mom + d,
                 state.momentum, delta)
    if cfg.nesterov:
        upd = tree_map(lambda mom, d: cfg.outer_momentum * mom + d, m, delta)
    else:
        upd = m
    new_anchor = tree_map(lambda a, u: a - cfg.outer_lr * u, state.anchor,
                          upd)
    return new_anchor, OuterState(anchor=new_anchor, momentum=m)


def fedavg_outer(params, axis: PodAxis = 0):
    """Plain FedAvg across pods (outer_lr=1, no momentum)."""
    return tree_map(lambda p: pod_mean(p, axis), params)


def make_sharded_outer(group, cfg: LocalSGDConfig):
    """The cross-pod sync over the ranks of ``group``, one pod a rank:
    ``sync(local_params, outer_state) -> (new_anchor, new_state)``, the
    anchor and state the same on every rank.  Every rank of the group
    must call it with its own pod's tree."""
    def sync(local_params, state: OuterState):
        return outer_step(local_params, state, cfg, axis=group)
    return sync
