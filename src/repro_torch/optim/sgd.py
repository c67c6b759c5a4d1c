"""SGD (+momentum), the paper's client-side optimizer (Alg. 1), and the
functional ``Optimizer`` every optimizer of the port is; the counterpart of
``src/repro/optim/sgd.py``.

Parameter trees are the port's nested dicts of tensors with the JAX
package's keys, so states and updates line up leaf for leaf with the
reference's.  :func:`update_in_place` applies any of them one leaf at a
time, writing into the parameter and state tensors, for models whose
state leaves no room for a second copy of the tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.layers import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable           # (grads, state, params, lr) -> (updates, state)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return (tree_map(torch.zeros_like, params),)

    def update(grads, state, params, lr):
        del params
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), ()
        (m,) = state
        m = tree_map(lambda mm, g: momentum * mm + g, m, grads)
        if nesterov:
            upd = tree_map(lambda mm, g: momentum * mm + g, m, grads)
        else:
            upd = m
        return tree_map(lambda u: -lr * u, upd), (m,)

    return Optimizer(init, update)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _copy_into(dst, src) -> None:
    """Copy a per-leaf state entry (a tensor, or a tuple / list of tensors
    and ``None``) into the tensors it replaces."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for d, s in zip(dst, src):
            _copy_into(d, s)


@torch.no_grad()
def update_in_place(opt: Optimizer, grads, state, params, lr):
    """``opt.update`` then ``p + u`` in the param's dtype (the reference's
    train step), one leaf at a time: each param tensor and each per-leaf
    state entry is overwritten with its new value, so the temporaries are
    one leaf's, never a second tree.  The values are the functional
    update's (the same elementwise operations).

    ``state`` is the optimizer's tuple: entries that are trees shaped like
    ``params`` (moments, factors) are updated in place; the others (the
    step count) are shared by every leaf and replaced.  Returns the new
    state."""
    shared = tuple(s for s in state if not isinstance(s, dict))
    for path in _paths(params):
        p = _at(params, path)
        leaf_state = tuple(_at(s, path) if isinstance(s, dict) else s
                           for s in state)
        u, new = opt.update(_at(grads, path), leaf_state, p, lr)
        p.add_(u.to(p.dtype))
        for s, old, n in zip(state, leaf_state, new):
            if isinstance(s, dict):
                _copy_into(old, n)
        shared = tuple(n for s, n in zip(state, new)
                       if not isinstance(s, dict))
    it = iter(shared)
    return tuple(s if isinstance(s, dict) else next(it) for s in state)
