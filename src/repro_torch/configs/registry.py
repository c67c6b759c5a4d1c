"""Architecture registry: --arch <id> -> ModelConfig; the counterpart of
``src/repro/configs/registry.py``, with the same ten architecture ids."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
