"""Hand-written CUDA kernels for the fused LSTM/GRU cells (``csrc/``), their
wrappers, and the plain PyTorch versions they are held against."""
from repro_torch.kernels import ops, ref
