"""LLaVA-NeXT-34B — VLM: dense LM backbone + anyres-tiled vision frontend stub.

Copy of ``src/repro/configs/llava_next_34b.py``.
Source: [hf:llava-hf/llava-v1.6-mistral-7b-hf] (anyres tiling scheme); backbone
dims per the assigned 34B card (Yi-34B-like: 60L, d=7168, 56H GQA kv=8).
The ViT/SigLIP encoder is a STUB — ``input_specs`` supplies pre-projector patch
embeddings (embed_dim=1024); the multimodal projector (1024 -> d_model) is real.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    frontend=FrontendConfig(kind="vlm", embed_dim=1024, n_media_tokens=1152),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
