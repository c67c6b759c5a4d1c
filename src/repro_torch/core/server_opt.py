"""Pluggable server-side update rules for the federated round engine: the
counterpart of ``src/repro/core/server_opt.py``.

Each round the engine produces an aggregated client model ``w_agg`` (sample-
count-weighted average of the returned local models).  The server then treats

    g = w_global - w_agg            (the "pseudo-gradient", Reddi et al. 2021)

as a gradient estimate and applies one step of a server optimizer.  Selected
via ``FLConfig.server_opt``:

``fedavg``
    Uniform FedAvg (paper Alg. 1).  The engine aggregates with equal client
    weights and the server applies ``w <- w - server_lr * g`` (with
    ``server_lr=1`` this is exactly ``w <- w_agg``).  ``server_momentum > 0``
    turns this into FedAvgM (server momentum on the pseudo-gradient).
``fedavg_weighted``
    Same server step, but aggregation weights clients by their local sample
    counts (the classic McMahan et al. weighting for unbalanced data).
``fedprox``
    Weighted FedAvg aggregation + a proximal term ``mu/2 ||w - w_global||^2``
    added to each client's local objective (see ``core/client.py``;
    ``FLConfig.prox_mu``).  ``mu=0`` recovers FedAvg exactly.
``fedadam`` / ``fedyogi``
    Adaptive server optimizers (Reddi et al., "Adaptive Federated
    Optimization"): first/second moments of the pseudo-gradient, no bias
    correction; yogi uses the sign-damped second-moment update.

All rules are functions of ``(w_global, w_agg, state)`` on param trees of
tensors (dicts and lists), run on the device the params live on.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple, Union

import torch

# canonical name list lives with the configs (eager facade validation);
# re-exported here so `server_opt.SERVER_OPTS` keeps working
from repro_torch.configs.base import SERVER_OPTS, FLConfig, ServerOptConfig
from repro_torch.models.layers import tree_map

# opts whose aggregation weights clients by local sample count
WEIGHTED_AGG_OPTS = ("fedavg_weighted", "fedprox", "fedadam", "fedyogi")


def as_server_config(cfg: Union[FLConfig, ServerOptConfig]) -> ServerOptConfig:
    """Normalize to the typed server-update stage config (facade-friendly)."""
    return cfg.server if isinstance(cfg, FLConfig) else cfg


class ServerState(NamedTuple):
    """Server optimizer state (zeros where a rule has no such moment)."""
    m: Any                      # first moment / momentum buffer
    v: Any                      # second moment (fedadam / fedyogi)
    t: int                      # step count


def uses_weighted_aggregation(flcfg: Union[FLConfig, ServerOptConfig]) -> bool:
    return as_server_config(flcfg).name in WEIGHTED_AGG_OPTS


def init_server_state(params) -> ServerState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return ServerState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                       t=0)


@torch.no_grad()
def server_update(w_global, w_agg, state: ServerState,
                  flcfg: Union[FLConfig, ServerOptConfig]
                  ) -> Tuple[Any, ServerState]:
    """Apply one server step to the pseudo-gradient ``w_global - w_agg``.

    Accepts the flat ``FLConfig`` facade or the typed ``ServerOptConfig``
    stage view.  Returns ``(new_global_params, new_state)``.
    """
    cfg = as_server_config(flcfg)
    opt = cfg.name
    if opt not in SERVER_OPTS:
        raise ValueError(f"unknown server_opt {opt!r}; expected one of "
                         f"{SERVER_OPTS}")
    lr = cfg.lr
    g = tree_map(lambda w, a: w - a, w_global, w_agg)
    t = state.t + 1

    if opt in ("fedavg", "fedavg_weighted", "fedprox"):
        if cfg.momentum > 0.0:             # FedAvgM
            m = tree_map(lambda mm, gg: cfg.momentum * mm + gg, state.m, g)
            new = tree_map(lambda w, mm: w - lr * mm, w_global, m)
            return new, ServerState(m=m, v=state.v, t=t)
        if lr == 1.0:                      # exact Alg. 1: w <- w_agg
            return w_agg, ServerState(m=state.m, v=state.v, t=t)
        new = tree_map(lambda w, gg: w - lr * gg, w_global, g)
        return new, ServerState(m=state.m, v=state.v, t=t)

    # adaptive rules (Reddi et al. 2021, no bias correction)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    m = tree_map(lambda mm, gg: b1 * mm + (1 - b1) * gg, state.m, g)
    if opt == "fedadam":
        v = tree_map(lambda vv, gg: b2 * vv + (1 - b2) * gg * gg, state.v, g)
    else:                                  # fedyogi: sign-damped v update
        v = tree_map(
            lambda vv, gg: vv - (1 - b2) * gg * gg * torch.sign(vv - gg * gg),
            state.v, g)
    new = tree_map(lambda w, mm, vv: w - lr * mm / (torch.sqrt(vv) + eps),
                   w_global, m, v)
    return new, ServerState(m=m, v=v, t=t)
