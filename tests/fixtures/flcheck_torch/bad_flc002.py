"""Fixture: key reuse — triggers FLC002 and nothing else."""
from repro_torch.core import prng


def double_draw(key):
    a = prng.normal(key, (4,))
    b = prng.uniform(key, (4,))            # FLC002: key already consumed
    return a + b


def loop_draw(key, n):
    out = []
    for _ in range(n):
        out.append(prng.normal(key, (2,)))     # FLC002: same bits/iter
    return out
