"""Hand-written CUDA kernels (``csrc/``: the fused LSTM/GRU cells and causal
flash attention), their wrappers, and the plain PyTorch versions they are
held against."""
from repro_torch.kernels import ops, ref
