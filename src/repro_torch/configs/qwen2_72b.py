"""Qwen2-72B — dense decoder, GQA (kv=8), QKV bias.

Copy of ``src/repro/configs/qwen2_72b.py``.
Source: [arXiv:2407.10671] (Qwen2 technical report).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)
