"""Threefry-2x32 draws for a sample of a batch's groups.

The simulator draws every round's randomness from one key for the whole
batch: a draw of shape ``(..., G)`` hashes the counters ``0 .. size-1``
in row-major order, so group ``g`` of row ``i`` takes counter
``i * G + g`` (jax's partitionable threefry layout: each element's bits
are the XOR of the hash's two output words).  A ``LaneKey`` is such a key
together with the sampled groups and the batch's size; its draws are
shaped ``(..., len(lanes))`` and hold exactly the bits the whole batch's
draw holds at those groups.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


class LaneKey(NamedTuple):
    """A key (two uint32 words as Python ints) of a batch of ``groups``
    groups, drawing for the groups ``lanes`` only."""

    k1: int
    k2: int
    lanes: torch.Tensor     # (L,) int64, on the device the draws land on
    groups: int


def key_words(seed: int) -> tuple:
    """The two key words of a whole-number seed: its low 64 bits."""
    s = seed % (1 << 64)
    return (s >> 32) & _M32, s & _M32


def _scalar_hash(k1: int, k2: int, x1: int, x2: int) -> tuple:
    t = [torch.tensor(v, dtype=torch.int64) for v in (k1, k2, x1, x2)]
    a, b = threefry2x32(*t)
    return int(a), int(b)


def fold_words(k1: int, k2: int, data: int) -> tuple:
    """``fold_in`` on bare key words."""
    return _scalar_hash(k1, k2, 0, int(data) & _M32)


def split_words(k1: int, k2: int, num: int) -> List[tuple]:
    """``split`` on bare key words: ``num`` keys."""
    return [_scalar_hash(k1, k2, 0, i) for i in range(num)]


def split(key: LaneKey, num: int = 2) -> List[LaneKey]:
    return [LaneKey(a, b, key.lanes, key.groups)
            for a, b in split_words(key.k1, key.k2, num)]


def fold_in(key: LaneKey, data: int) -> LaneKey:
    a, b = fold_words(key.k1, key.k2, data)
    return LaneKey(a, b, key.lanes, key.groups)


def random_bits(key: LaneKey, shape: Sequence[int]) -> torch.Tensor:
    """32 bits per element (int64 in ``[0, 2**32)``) of the batch's draw
    of shape ``shape[:-1] + (groups,)``, at the sampled groups:
    ``shape[-1]`` is the sample's size."""
    shape = tuple(shape)
    lanes = key.lanes
    if shape[-1] != lanes.numel():
        raise ValueError(f"draw shape {shape} does not end in the sample's "
                         f"{lanes.numel()} groups")
    outer = math.prod(shape[:-1])
    if outer * key.groups >= 2 ** 32:
        raise ValueError("counter range beyond 2**32 is not supported")
    rows = torch.arange(outer, dtype=torch.int64, device=lanes.device)
    ctr = rows[:, None] * key.groups + lanes[None, :]
    b1, b2 = threefry2x32(torch.full_like(ctr, key.k1),
                          torch.full_like(ctr, key.k2),
                          torch.zeros_like(ctr), ctr)
    return (b1 ^ b2).reshape(shape)


def randint(key: LaneKey, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``randint`` (int32): two bit draws from ``split(key)`` combined by
    jax's multiplier rule."""
    k = split(key)
    hi = random_bits(k[0], shape)
    lo = random_bits(k[1], shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


def uniform(key: LaneKey, shape: Sequence[int]) -> torch.Tensor:
    """float32 over ``[0, 1)`` from the top 23 bits."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: LaneKey, p: float, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``uniform < p``."""
    p32 = torch.tensor(p, dtype=torch.float32, device=key.lanes.device)
    return uniform(key, shape) < p32
