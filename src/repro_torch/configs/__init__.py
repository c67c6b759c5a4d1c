from repro_torch.configs.base import (INPUT_SHAPES, SHAPES_BY_NAME,
                                      AggregationConfig, ClientOptConfig,
                                      FLConfig, ForecasterConfig,
                                      FrontendConfig, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, SamplingConfig,
                                      ServerOptConfig, SSMConfig,
                                      TransformConfig, XLSTMConfig)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = ["AggregationConfig", "ClientOptConfig", "FLConfig",
           "ForecasterConfig", "FrontendConfig", "InputShape", "INPUT_SHAPES",
           "MLAConfig", "ModelConfig", "MoEConfig", "SamplingConfig",
           "ServerOptConfig", "SHAPES_BY_NAME", "SSMConfig",
           "TransformConfig", "XLSTMConfig", "ARCH_IDS", "all_configs",
           "get_config"]
