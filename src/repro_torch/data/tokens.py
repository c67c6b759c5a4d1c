"""LM token pipeline for the assigned architectures: a bit-exact numpy copy
of ``src/repro/data/tokens.py``, so that both packages train on the same
batches.

Offline container ⇒ synthetic-but-structured token streams (a Zipf-mixture
"language" with local n-gram structure, so losses decrease meaningfully in
smoke training), plus the modality-specific batch layouts:

  * dense/moe/ssm/hybrid: {"tokens", "labels"} (B, S)
  * vlm (llava anyres):   tokens (B, S − n_media) + media patch embeddings
  * audio (musicgen):     (B, K, S) EnCodec-style codes with the DELAY
                          pattern — codebook k is shifted k steps so step t
                          decodes code k of frame t−k (arXiv:2306.05284)
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                alpha: float = 1.2) -> np.ndarray:
    """Zipf-distributed ids with first-order Markov structure."""
    n = int(np.prod(shape))
    ranks = rng.zipf(alpha, size=n).astype(np.int64)
    base = (ranks - 1) % vocab
    # bigram structure: with p=0.3, next token = prev + 1 (mod vocab)
    flat = base.copy()
    follow = rng.random(n) < 0.3
    flat[1:][follow[1:]] = (flat[:-1][follow[1:]] + 1) % vocab
    return flat.reshape(shape).astype(np.int32)


def apply_delay_pattern(codes: np.ndarray, pad_id: int = 0) -> np.ndarray:
    """MusicGen delay interleave: codes (B, K, S) -> delayed (B, K, S)."""
    B, K, S = codes.shape
    out = np.full_like(codes, pad_id)
    for k in range(K):
        out[:, k, k:] = codes[:, k, :S - k]
    return out


def undelay_pattern(delayed: np.ndarray) -> np.ndarray:
    B, K, S = delayed.shape
    out = np.zeros_like(delayed)
    for k in range(K):
        out[:, k, :S - k] = delayed[:, k, k:]
    return out


def make_lm_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """A training batch matching the arch's input layout (numpy)."""
    rng = np.random.default_rng(seed)
    if cfg.arch_type == "audio":
        K = cfg.frontend.n_codebooks
        raw = zipf_tokens(rng, (batch, K, seq), cfg.vocab_size)
        toks = apply_delay_pattern(raw)
        return {"tokens": toks, "labels": toks}
    if cfg.arch_type == "vlm":
        nm = cfg.frontend.n_media_tokens
        toks = zipf_tokens(rng, (batch, seq - nm), cfg.vocab_size)
        media = rng.normal(size=(batch, nm, cfg.frontend.embed_dim)) \
            .astype(np.float32)
        labels = zipf_tokens(rng, (batch, seq), cfg.vocab_size)
        labels[:, nm:] = np.roll(toks, -1, axis=1)
        return {"tokens": toks, "labels": labels, "media": media}
    toks = zipf_tokens(rng, (batch, seq), cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    return {"tokens": toks, "labels": labels}
