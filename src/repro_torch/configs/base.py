"""Config dataclasses for the PyTorch port.

Only the forecaster's config lives here so far: the serving path needs
nothing else.  The federated stage configs come with the training slice.
Configs are frozen dataclasses, hashable and safe to share between threads.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ForecasterConfig:
    """The paper's RNN demand-forecasting model (§3.2)."""
    cell: str = "lstm"                 # "lstm" | "gru"
    input_dim: int = 1
    hidden_dim: int = 64
    n_layers: int = 1
    lookback: int = 8                  # 2 h of 15-min steps (§4.2)
    horizon: int = 4                   # 1 h ahead (§4.2)

    def num_params(self) -> int:
        h, i = self.hidden_dim, self.input_dim
        gates = 4 if self.cell == "lstm" else 3
        n = 0
        for l in range(self.n_layers):
            inp = i if l == 0 else h
            n += gates * h * (inp + h + 1)
        n += h * self.horizon + self.horizon
        return n
