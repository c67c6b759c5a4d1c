from repro_torch.data.partition import (ragged_minibatch_indices,
                                        sample_clients)
from repro_torch.data.synthetic import (STATES, generate_buildings,
                                        mean_consumption)
from repro_torch.data.windows import (ClientWindowProvider,
                                      batched_client_windows, client_dataset,
                                      daily_average_vector, make_windows,
                                      minmax_normalize, train_test_split)

__all__ = ["STATES", "generate_buildings", "mean_consumption",
           "ClientWindowProvider", "batched_client_windows", "client_dataset",
           "daily_average_vector", "make_windows", "minmax_normalize",
           "train_test_split", "sample_clients", "ragged_minibatch_indices"]
