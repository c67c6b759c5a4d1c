from repro_torch.configs.base import ForecasterConfig

__all__ = ["ForecasterConfig"]
