"""Fixture: raw literal PRNG keys and seeds — triggers FLC001 and nothing
else."""
import torch

from repro_torch.core import prng


def init_model():
    key = prng.PRNGKey(0)                  # FLC001
    return prng.normal(key, (4,))


def other_stream():
    g = torch.Generator().manual_seed(42)  # FLC001
    return torch.randn((2,), generator=g)


def global_seed():
    torch.manual_seed(7)                   # FLC001
