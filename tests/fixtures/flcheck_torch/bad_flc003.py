"""Fixture: arithmetic seed derivation — triggers FLC003 and nothing else."""
import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.layers import seeded_generator


def per_client_key(seed, cid):
    return prng.PRNGKey(seed + cid)        # FLC003: (s, 1) == (s+1, 0)


def per_client_init(seed, cid):
    return seeded_generator(seed + cid)    # FLC003


def per_rank_generator(seed, rank):
    return torch.Generator().manual_seed(seed * 100 + rank)   # FLC003


def per_init_rng(seed, init):
    return np.random.default_rng(seed * 100 + init)   # FLC003
