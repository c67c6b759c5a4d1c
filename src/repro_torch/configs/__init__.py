from repro_torch.configs.base import (INPUT_SHAPES, SHAPES_BY_NAME,
                                      ForecasterConfig, InputShape,
                                      ModelConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ARCH_IDS", "ForecasterConfig", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "SHAPES_BY_NAME", "get_config"]
