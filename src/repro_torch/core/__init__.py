"""The federated core, synchronous and on one device: the round engine and
driver (``fedavg``), the local update (``client``), the server optimizers
(``server_opt``), client selection (``sampling``), the simulated latency
clock (``latency``), the (eps, delta) accountant (``privacy``), losses and
metrics (``losses``), and k-means client clustering (``clustering``)."""
from repro_torch.core import clustering

__all__ = ["clustering"]
