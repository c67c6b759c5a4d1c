"""The federated core: the composable pipeline (select -> local-update ->
transform(deltas) -> aggregate -> server-update) with pluggable samplers
(``sampling``), delta transforms (``transforms``: clip / DP noise /
quantize; ``secure_agg``: pairwise masks), aggregation topologies
(``aggregation``: local, or flat / hierarchical over ``torch.distributed``
ranks), server optimizers (``server_opt``), synchronous and semi-synchronous
round pacing (``fedavg``, ``async_engine``, ``latency``), the (eps, delta)
accountant (``privacy``), losses and metrics (``losses``), k-means client
clustering (``clustering``), the paper's seasonal-ARIMA baseline
(``sarima``), and cross-pod local-SGD training (``local_sgd``).

The names of ``repro.core`` are re-exported, resolved on first access:
``fedavg`` imports ``serving.registry``, which imports ``core.prng``, so an
eager import here would make ``import repro_torch.serving`` circular.
The reference's JAX-only names have no counterpart
(``repro_torch.JAX_ONLY``).
"""
import importlib

# name -> the submodule that defines it
_EXPORTS = {
    **{n: "aggregation" for n in (
        "Aggregator", "FlatAggregator", "HierarchicalAggregator",
        "LocalAggregator", "make_aggregator")},
    **{n: "transforms" for n in (
        "DeltaTransform", "GaussianNoise", "L2Clip", "StochasticQuantize",
        "TransformStack", "make_stack")},
    **{n: "fedavg" for n in (
        "FLResult", "RoundEngine", "engine_round", "evaluate_global",
        "evaluate_unseen_clients", "fedavg_aggregate", "fedavg_round",
        "pipeline_round", "run_federated_training", "weighted_aggregate")},
    **{n: "local_sgd" for n in (
        "LocalSGDConfig", "OuterState", "fedavg_outer", "init_outer_state",
        "outer_step")},
    **{n: "losses" for n in (
        "accuracy", "ew_mse", "make_loss", "mape", "mse",
        "per_horizon_accuracy", "rmse", "weighted_ce")},
    **{n: "sampling" for n in ("SAMPLING_STRATEGIES", "make_sampler")},
    **{n: "server_opt" for n in (
        "SERVER_OPTS", "ServerState", "init_server_state", "server_update")},
}
_SUBMODULES = ("aggregation", "async_engine", "client", "clustering",
               "fedavg", "latency", "local_sgd", "losses", "privacy", "prng",
               "sampling", "sarima", "secure_agg", "server_opt",
               "transforms")
__all__ = sorted(set(_EXPORTS) | set(_SUBMODULES))


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
