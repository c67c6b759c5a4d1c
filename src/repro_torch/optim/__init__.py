"""Functional optimizers over the port's parameter trees; the counterpart
of ``src/repro/optim/``."""
from repro_torch.optim.adam import adam, adamw
from repro_torch.optim.factored import adafactor
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.optim.sgd import Optimizer, sgd, update_in_place

__all__ = ["Optimizer", "sgd", "adam", "adamw", "adafactor", "constant",
           "warmup_cosine", "update_in_place"]
