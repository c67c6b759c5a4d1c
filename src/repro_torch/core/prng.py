"""Counter-based PRNG that replays ``jax.random``'s default threefry2x32
stream bit for bit: the counterpart of the ``jax.random`` calls the JAX
package makes (``PRNGKey``, ``fold_in``, ``split``, ``bits``, ``uniform``,
``normal``, ``randint``).

It follows ``jax/_src/prng.py`` (``threefry_2x32``, the partitionable
``_threefry_split_foldlike`` / ``_threefry_random_bits_partitionable``,
``_threefry_fold_in``, ``threefry_seed``) and ``jax/_src/random.py``
(``_uniform``, ``_normal_real``, ``_randint``) under the configuration the
JAX package runs with: ``jax_threefry_partitionable = True`` and 32-bit
default types.

* A **key** is a pair of uint32 words, held either as a tuple of two Python
  ints (derived on the host, never copied to the device) or as an
  ``int64`` tensor of shape ``(..., 2)`` (a batch of keys on a device).
  Every function takes either; a batch of keys gives a batch of results,
  with the key's batch axes leading.
* Words are ``int64`` tensors (or Python ints) masked to 32 bits after
  every add and rotation, so the arithmetic is exact on every device.
* ``bits``, ``uniform`` and ``randint`` are bit-equal to ``jax.random``.
  ``normal`` is ``sqrt(2) * erfinv(u)`` on a bit-equal ``u``; torch's
  ``erfinv`` is not XLA's polynomial, so it agrees within a few ulp
  (``tests/test_torch_prng.py`` states the bound it measures).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Key = Union[Tuple[int, int], torch.Tensor]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal draws u in (nextafter(-1, 0), 1): erfinv stays finite
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under the key words ``(k0, k1)``.  Each argument is a Python int or an
    ``int64`` tensor of values in ``[0, 2^32)``; tensors broadcast.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: Key):
    """The key's two words: Python ints, or tensors of the batch shape."""
    if isinstance(key, torch.Tensor):
        return key[..., 0], key[..., 1]
    return int(key[0]) & MASK, int(key[1]) & MASK


def _pair(y0, y1) -> Key:
    if isinstance(y0, torch.Tensor) or isinstance(y1, torch.Tensor):
        y0, y1 = torch.broadcast_tensors(torch.as_tensor(y0),
                                         torch.as_tensor(y1))
        return torch.stack([y0, y1], -1)
    return (y0, y1)


def as_tensor(key: Key, device=None) -> torch.Tensor:
    """A key (or a batch of keys) as an ``int64`` tensor ``(..., 2)``."""
    if isinstance(key, torch.Tensor):
        return key.to(device) if device is not None else key
    return torch.tensor([int(key[0]) & MASK, int(key[1]) & MASK],
                        dtype=torch.int64, device=device)


def PRNGKey(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds: ``(0, seed mod
    2^32)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return (0, seed & MASK)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: ``threefry2x32(key, (0, data))``.  ``data``
    is an int or an integer tensor; a tensor (or a batch of keys) gives a
    batch of keys over the broadcast of the key's batch shape and
    ``data``'s shape."""
    k0, k1 = _words(key)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
        if isinstance(k0, torch.Tensor):
            data = data.to(k0.device)
    else:
        data = int(data) & MASK
    return _pair(*threefry2x32(k0, k1, 0, data))


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)``: key ``i`` is ``threefry2x32(key,
    (0, i))``.  A Python key gives a list of ``num`` Python keys; a tensor
    key ``(..., 2)`` gives a tensor ``(..., num, 2)``."""
    k0, k1 = _words(key)
    if isinstance(k0, torch.Tensor):
        i = torch.arange(num, dtype=torch.int64, device=k0.device)
        return _pair(*threefry2x32(k0[..., None], k1[..., None], 0, i))
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as ``int64`` values in
    ``[0, 2^32)``: ``x0 ^ x1`` of ``threefry2x32(key, (0, flat index))``.
    A batch of keys ``(..., 2)`` gives ``(..., *shape)``.  A Python key
    draws on ``device``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws exceed the 32-bit counter")
    k0, k1 = _words(key)
    if isinstance(k0, torch.Tensor):
        batch, device = k0.shape, k0.device
        k0, k1 = k0[..., None], k1[..., None]
    else:
        batch = ()
    counts = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, 0, counts)
    return (y0 ^ y1).reshape(batch + shape)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1 (``jax.random._uniform``)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: Sequence[int] = (), device=None,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA
    fuses ``f * (maxval - minval) + minval`` into one FMA; the product of
    two float32 is exact in float64, so the shift is done there and rounded
    once to float32."""
    f = _unit_floats(bits(key, shape, device))
    if (minval, maxval) == (0.0, 1.0):
        return f
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    g = (f.double() * span + float(lo)).float()
    return torch.clamp_min(g, float(lo))


def normal(key: Key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform in ``(nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, device, minval=_NORMAL_LO, maxval=1.0)
    return _SQRT2 * torch.erfinv(u)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a * m mod 2^32`` for ``a`` in ``[0, 2^32)`` without leaving
    ``int64``: the multiplier goes in 16-bit halves."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as
    ``int64`` values: two draws from ``split(key)`` combined as
    ``(hi mod span) * mult + lo mod span`` with ``mult = (2^16 mod span)^2
    mod span``, every product and sum wrapping mod 2^32 as uint32 does,
    then mod span."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= min(minval, maxval) <= max(minval, maxval) < 2 ** 31:
        raise OverflowError(f"randint bounds {minval}, {maxval} exceed int32")
    span = maxval - minval if maxval > minval else 1
    k_hi, k_lo = _split2(key)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span     # uint32 product: wraps
    off = bits(k_lo, shape, device) % span
    if mult:                       # 0 whenever span divides 2^16
        hi = bits(k_hi, shape, device) % span
        off = (_mul32(hi, mult) + off) & MASK
    off = off % span
    return ((minval + off + 2 ** 31) & MASK) - 2 ** 31   # int32 wrap


def _split2(key: Key):
    ks = split(key, 2)
    if isinstance(ks, torch.Tensor):
        return ks[..., 0, :], ks[..., 1, :]
    return ks[0], ks[1]
