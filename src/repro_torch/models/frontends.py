"""Modality frontends; the counterpart of ``src/repro/models/frontends.py``.

VLM (llava-next): the vision encoder is a stub, as in the JAX package: the
batch carries pre-projector patch embeddings (B, n_media_tokens,
embed_dim).  The multimodal projector (a 2-layer MLP, embed_dim -> d_model)
is real.

Audio (musicgen): the EnCodec codec is a stub; tokens arrive as
(B, n_codebooks, S) code indices.  The per-codebook embeddings (summed at
the input) and the per-codebook LM heads are real.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


# ------------------------------------------------------------------ VLM
def init_projector(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32):
    f = cfg.frontend
    return {
        "proj_in": dense_init(generator, f.embed_dim, cfg.d_model,
                              dtype=dtype),
        "proj_out": dense_init(generator, cfg.d_model, cfg.d_model,
                               scale=cfg.d_model ** -0.5, dtype=dtype),
    }


def project_media(params, media, dtype):
    """media: (B, n_media, embed_dim) -> (B, n_media, d_model)."""
    h = torch.matmul(media.to(dtype), params["proj_in"].to(dtype))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, params["proj_out"].to(dtype))


# ------------------------------------------------------------------ audio
def init_codebook_embeddings(generator: torch.Generator, cfg: ModelConfig,
                             dtype=torch.float32):
    f = cfg.frontend
    emb = (torch.randn((f.n_codebooks, cfg.vocab_size, cfg.d_model),
                       generator=generator, dtype=torch.float32,
                       device=generator.device) * 0.02).to(dtype)
    heads = dense_init(generator, cfg.d_model,
                       f.n_codebooks * cfg.vocab_size, dtype=dtype)
    return {"cb_embed": emb,
            "cb_heads": heads.reshape(cfg.d_model, f.n_codebooks,
                                      cfg.vocab_size)}


def embed_codes(params, codes, dtype):
    """codes: (B, K, S) -> the K codebooks' embeddings summed (B, S, d)."""
    out = F.embedding(codes[:, 0], params["cb_embed"][0].to(dtype))
    for k in range(1, codes.shape[1]):
        out = out + F.embedding(codes[:, k], params["cb_embed"][k].to(dtype))
    return out


def codebook_logits(params, h):
    """h: (B, S, d) -> (B, K, S, V)."""
    return torch.einsum("bsd,dkv->bksv", h, params["cb_heads"].to(h.dtype))
