"""Host-side numpy pieces of the federated core.  So far only k-means
client clustering, which the serving router's centroids come from."""
from repro_torch.core import clustering

__all__ = ["clustering"]
