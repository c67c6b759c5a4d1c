"""PyTorch/CUDA port of the federated demand-forecasting system.

Each ``repro_torch/<path>.py`` is the counterpart of ``repro/<path>.py`` in
the JAX package, which stays the reference.  The package imports torch and
numpy, never JAX.  The fused LSTM/GRU cells are hand-written CUDA kernels
for Hopper (``csrc/``), built at first use.
"""
