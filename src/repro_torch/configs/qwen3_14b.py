"""Qwen3-14B — dense decoder with qk-norm, GQA kv=8, no QKV bias.

Copy of ``src/repro/configs/qwen3_14b.py``.
Source: [hf:Qwen/Qwen3-8B] family card, 14B dims per assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
