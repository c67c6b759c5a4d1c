"""MusicGen-medium — decoder-only LM over EnCodec tokens (4 codebooks).

Copy of ``src/repro/configs/musicgen_medium.py``.
Source: [arXiv:2306.05284] (MusicGen). 48L, d=1536, 24H MHA, vocab=2048 per
codebook, 4 codebooks with the delay interleaving pattern (handled in the data
pipeline stub). The EnCodec codec itself is a STUB; per-codebook embeddings are
summed at input and 4 per-codebook LM heads produce logits.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend=FrontendConfig(kind="audio", n_codebooks=4),
    source="arXiv:2306.05284",
)
