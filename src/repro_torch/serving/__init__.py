"""Forecast-serving tier (paper §5.4: the FL-trained model serves thousands
of unseen consumers with no client-side retraining), on the card.

* :class:`~repro_torch.serving.engine.ServingEngine`: request coalescing
  into padded power-of-two batch buckets, per-request normalization on the
  device, forward through the fused CUDA cells.
* :class:`~repro_torch.serving.registry.ModelRegistry`: per-slot model
  handles with atomic hot-swap and checkpoint polling.
* :class:`~repro_torch.serving.router.ClusterRouter`: nearest-centroid
  cluster assignment for unseen consumers on daily summaries.
"""
from repro_torch.serving.engine import (EngineStats, FlushStats,
                                        ForecastRequest, ServingEngine,
                                        bucket_for, bucket_ladder)
from repro_torch.serving.registry import (GLOBAL_SLOT, ModelHandle,
                                          ModelRegistry, dequantize_params,
                                          quantize_params, resolve_device)
from repro_torch.serving.router import ClusterRouter, daily_summary_of

__all__ = [
    "ServingEngine", "ForecastRequest", "FlushStats", "EngineStats",
    "bucket_for", "bucket_ladder",
    "ModelRegistry", "ModelHandle", "GLOBAL_SLOT", "resolve_device",
    "quantize_params", "dequantize_params",
    "ClusterRouter", "daily_summary_of",
]
