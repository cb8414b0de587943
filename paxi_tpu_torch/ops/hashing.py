"""Shared in-kernel integer hashing ops (torch twin of the JAX package's
``ops/hashing.py``).

Command ids hash onto the KV key space with a Fibonacci (golden-ratio)
multiply in int32 wrap-around arithmetic; ``abs(INT32_MIN)`` stays
``INT32_MIN`` and the modulus floors, exactly as in ``jnp``.  The product
is formed in int64 and wrapped by hand so no signed overflow is relied on.
"""

from __future__ import annotations

import torch

GOLDEN = -1640531527  # 2654435769 as int32 (2^32 / phi)
_INT32_MIN = -2 ** 31


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    x = x & 0xFFFFFFFF
    return x - ((x >> 31) << 32)


def fib_key(x: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Hash int32 ``x`` onto ``[0, n_keys)``."""
    h = wrap_int32(x.to(torch.int64) * GOLDEN)
    h = torch.where(h == _INT32_MIN, h, h.abs())
    return torch.remainder(h, n_keys).to(torch.int32)
