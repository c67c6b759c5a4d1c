"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention block every 6 layers.

Copy of ``src/repro/configs/zamba2_7b.py``.
Source: [arXiv:2411.15242] (Zamba2). 81 Mamba2 layers, d=3584, ssm_state=64;
a single SHARED full attention+MLP block (32H MHA) is invoked periodically
(every 6 Mamba2 layers) — parameters are shared across invocations, as in the
paper. We fold the paper's per-invocation LoRA deltas into the shared block
(simplification recorded in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,                 # shared block MLP width
    vocab_size=32000,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=2),
    source="arXiv:2411.15242",
)
