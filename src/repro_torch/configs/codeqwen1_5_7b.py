"""CodeQwen1.5-7B — dense decoder, Qwen1.5 architecture (QKV bias, full MHA).

Copy of ``src/repro/configs/codeqwen1_5_7b.py``.
Source: [hf:Qwen/CodeQwen1.5-7B] model card / config.json.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
)
