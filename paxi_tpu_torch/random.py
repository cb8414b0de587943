"""Counter-based PRNG, bit-exact with ``jax.random``'s threefry2x32.

The sim draws its fault schedule and election jitter from one explicit key
that the runner splits every step, so a run is a pure function of its seed.
Parity with the JAX package needs the very same bits, so this module
re-implements the ``jax.random`` calls the sim path makes, in jax's
*partitionable* layout (``jax_threefry_partitionable=True``, the default
from jax 0.5 on):

- ``threefry2x32(k1, k2, x1, x2)``: the 20-round Threefry-2x32 hash
  (jax ``_threefry2x32_lowering``);
- ``split(key, n)``: hash the 64-bit counters ``0..n-1`` (hi word, lo
  word) and keep both output words as the new keys;
- ``fold_in(key, d)``: hash the counter pair ``(0, d)``;
- ``random_bits(key, shape)``: hash the counters ``0..size-1`` and XOR
  the two output words;
- ``randint``: two bit draws from ``split(key)`` combined with jax's
  ``multiplier`` trick; ``bernoulli``: ``uniform(key) < p`` in float32,
  ``uniform`` = ``(bits >> 9 | 0x3F800000)`` viewed as float32, minus 1.

A key is an int64 tensor of shape ``(2,)`` holding the two uint32 words.
Every call also takes a batch of keys ``(..., 2)`` (the per-group
runner's one key a group) and then equals ``jax.vmap`` of the call over
the batch: the hash is elementwise, so the two key words broadcast over
the counters and the outputs gain the batch's leading axes.  uint32
arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` because torch has
no uint32 shifts, adds or compares on every device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range: the key
    words are ``(0, seed mod 2**32)``."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _hash_iota(key, n: int):
    """Both output words of the hash of the 64-bit counters 0..n-1, each
    ``(..., n)`` for keys ``(..., 2)``."""
    if n >= 2 ** 32:
        raise ValueError("counter range beyond 2**32 is not supported")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(lo), lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)`` keys."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a Python int ``data``."""
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (as int64 in ``[0, 2**32)``),
    ``(..., *shape)`` for keys ``(..., 2)``."""
    b1, b2 = _hash_iota(key, math.prod(shape))
    return (b1 ^ b2).reshape(tuple(key.shape[:-1]) + tuple(shape))


def randint(key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32)."""
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


def uniform(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 over ``[0, 1)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key, p: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: float32 ``uniform < p``."""
    p32 = torch.tensor(p, dtype=torch.float32, device=key.device)
    return uniform(key, shape) < p32
