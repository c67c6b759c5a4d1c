"""DBRX-132B — fine-grained MoE: 16 experts, top-4, GQA kv=8.

Copy of ``src/repro/configs/dbrx_132b.py``.
Source: [hf:databricks/dbrx-base] config.json.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,                      # every FFN is MoE
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                  n_shared_experts=0, capacity_factor=1.25, group_size=512),
    source="hf:databricks/dbrx-base",
)
