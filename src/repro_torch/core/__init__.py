"""The federated core, synchronous and on one device: the round engine and
driver (``fedavg``), the local update (``client``), the server optimizers
(``server_opt``), client selection (``sampling``), the simulated latency
clock (``latency``), the (eps, delta) accountant (``privacy``), losses and
metrics (``losses``), k-means client clustering (``clustering``), and the
paper's seasonal-ARIMA baseline (``sarima``)."""
from repro_torch.core import clustering

__all__ = ["clustering"]
