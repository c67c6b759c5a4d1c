"""Model FLOPs of a step, for its share of the card's peak; the
``model_flops`` of ``src/repro/launch/roofline.py``: 6·N·D for training
(N = active params for MoE, D = tokens), 2·N·D for prefill, 2·N a decode
request.  The terms and table of the reference read dry-run records and
come with the port's dry run.
"""
from __future__ import annotations

from typing import Union

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import PEAK_FLOPS


def model_flops(arch: Union[str, ModelConfig],
                shape: Union[str, InputShape]) -> float:
    """``arch`` an id or a config (e.g. one cut in depth), ``shape`` a
    name of ``SHAPES_BY_NAME`` or an ``InputShape``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token per request


def peak_share(flops: float, seconds: float) -> float:
    """FLOPs done in ``seconds`` as a share of the card's bf16 peak."""
    return flops / (seconds * PEAK_FLOPS)
