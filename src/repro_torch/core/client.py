"""Local-update stage of the federated pipeline (paper Alg. 1,
``ClientUpdate``): select -> **local-update** -> transform -> aggregate ->
server-update.  The counterpart of ``src/repro/core/client.py``.

E epochs of minibatch SGD on each client's private windows, over a fixed
schedule of precomputed minibatch indices, for all M selected clients at
once.  The JAX package vmaps one client's ``lax.scan`` over clients; here
the client axis is written out: the params are client-stacked (a leading M
on every leaf, one model per client), every step gathers each client's
minibatch, and the forward is one call of the recurrent layer per layer
for all M clients (on the card, one launch of the CUDA layer kernel with
the clients on its grid).  The gradient is that of the SUM of the
per-client mean losses: the clients own disjoint slices of the stacked
params, so each slice gets its own client's gradient.

FedProx (Li et al. 2020) is supported via ``prox_mu``: the local objective
gains ``mu/2 ||w - w_global||^2`` anchored at the round's incoming global
params, realized as an extra ``mu * (w - w_global)`` gradient term.  With
``mu = 0`` the term is skipped, so FedAvg semantics are unchanged.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ForecasterConfig
from repro_torch.models import forecaster
from repro_torch.models.layers import tree_leaves, tree_map


def _rebuild(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def sgd_step(params, batch, lr, cfg: ForecasterConfig, loss: Callable,
             cell_impl: str = "kernel", anchor=None, prox_mu=0.0):
    """One SGD step of every client.  params: client-stacked tree; batch:
    {"x": (M, B, L, 1), "y": (M, B, horizon)}; ``anchor``/``prox_mu`` add
    the FedProx proximal gradient.  Returns (new stacked params, the step's
    loss of each client (M,))."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        per_client = forecaster.loss_fn(_rebuild(params, leaves), batch, cfg,
                                        loss, cell_impl, dim=(-2, -1))
        grads = torch.autograd.grad(per_client.sum(), leaves)
    with torch.no_grad():
        g = _rebuild(params, grads)
        if anchor is not None and prox_mu:
            g = tree_map(lambda gw, w, a: gw + prox_mu * (w - a),
                         g, params, anchor)
        new = tree_map(lambda w, gw: w - lr * gw, params, g)
    return new, per_client.detach()


def local_update(params, x, y, batch_idx, lr, cfg: ForecasterConfig,
                 loss: Callable, cell_impl: str = "kernel", prox_mu=0.0):
    """Run every selected client's local schedule.

    params: the round's global model (one tree, shared by all clients);
    x: (M, n_win, L, 1); y: (M, n_win, H); batch_idx: (M, steps, B) int
    tensors, all on one device; prox_mu: FedProx strength (0 = plain
    FedAvg).  ``loss`` takes ``(pred, target, dim)``
    (``core/losses.py::make_loss``).  Returns (client-stacked local params,
    each client's mean local loss (M,)).
    """
    M = x.shape[0]
    anchor = params                      # round-start global model (FedProx)
    local = tree_map(lambda w: w.detach().expand((M,) + w.shape).clone(),
                     params)
    rows = torch.arange(M, device=x.device)[:, None]
    losses = []
    for s in range(batch_idx.shape[1]):
        idx = batch_idx[:, s]                           # (M, B)
        local, l = sgd_step(local, {"x": x[rows, idx], "y": y[rows, idx]},
                            lr, cfg, loss, cell_impl, anchor=anchor,
                            prox_mu=prox_mu)
        losses.append(l)
    return local, torch.stack(losses).mean(0)
