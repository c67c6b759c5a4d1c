"""Architecture registry: --arch <id> -> ModelConfig; the counterpart of
``src/repro/configs/registry.py``.

The port holds two dense GQA decoders so far.  The other architecture ids
of the JAX package are known but not ported: ``get_config`` raises
``NotImplementedError`` for them, naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
}

# architecture ids of the JAX package that need model code the port lacks
NOT_PORTED = {
    "codeqwen1.5-7b": "dense; its config is not copied yet",
    "qwen2-72b": "dense; its config is not copied yet",
    "llava-next-34b": "VLM frontend",
    "musicgen-medium": "audio frontend",
    "zamba2-7b": "Mamba2 SSM hybrid",
    "xlstm-1.3b": "xLSTM",
    "dbrx-132b": "mixture of experts",
    "deepseek-v3-671b": "MLA and mixture of experts",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} ({NOT_PORTED[arch_id]}) is not ported yet: "
            f"ROADMAP A13 ports it; ported: {list(ARCH_IDS)}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
