"""Layout-free selection helpers for lane-major sim kernels (torch twin
of the part of the JAX package's ``sim/ring.py`` the fixed-cell core
uses).  Planes carry the group axis LAST."""

from __future__ import annotations

import torch


def require_packable(n_replicas: int) -> None:
    """Guard for kernels that bit-pack per-replica acks into int32
    masks: bit 31 is the sign bit, so replica 32 would alias replica 0."""
    if n_replicas > 31:
        raise ValueError(f"n_replicas={n_replicas} > 31: packed int32 "
                         "ack masks support at most 31 replicas per group")


def pick_src(field: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """out[d, g] = field[src_idx[d, g], d, g] — each destination's chosen
    sender's message from a (src, dst, G) mailbox plane."""
    return torch.gather(field, 0, src_idx.to(torch.int64)[None])[0]


def take_replica(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, ..., g] = x[idx[r, g], ..., g] — adopt another replica's row
    of a (R, ..., G) state plane."""
    mid = x.ndim - 2
    index = idx.to(torch.int64).reshape(
        (idx.shape[0],) + (1,) * mid + (idx.shape[-1],))
    return torch.gather(x, 0, index.expand((idx.shape[0],) + x.shape[1:]))
