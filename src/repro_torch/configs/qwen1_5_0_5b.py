"""Qwen1.5-0.5B — small dense decoder with QKV bias, full MHA.

Copy of ``src/repro/configs/qwen1_5_0_5b.py``.
Source: [hf:Qwen/Qwen1.5-0.5B] config.json.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
