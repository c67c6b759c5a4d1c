"""DeepSeek-V3-671B — MLA + fine-grained MoE (1 shared + 256 routed, top-8) + MTP.

Copy of ``src/repro/configs/deepseek_v3_671b.py``.
Source: [arXiv:2412.19437] (DeepSeek-V3 technical report). 61 layers, first 3
dense (d_ff=18432 per report; the assigned card's d_ff=2048 is the EXPERT width,
used for all routed/shared experts). MLA: q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128. MTP = one extra depth of multi-token prediction.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                  # the 3 dense layers
    vocab_size=129280,
    dense_layers=3,
    mtp=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, capacity_factor=1.25, group_size=512),
    source="arXiv:2412.19437",
)
