"""Ring and selection helpers for lane-major sim kernels (a frozen copy
of the port's ``sim/ring.py``).  Planes carry the group axis LAST.

Two halves:

- **Layout-free selections** (``pick_src``, ``take_replica``,
  ``dst_major``, ``diag2``): serve both ring contracts — the fixed-cell
  core (``sim/cell_ring.py``, paxos) and the sliding-window kernels.
- **Sliding-window** (``shift_window``, ``shift_row``, ``shift_deps``):
  ring position ``i`` holds absolute instance ``base + i``, and the
  window slides forward by a per-lane advance as the execute frontier
  moves (epaxos, switchpaxos).
"""

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


def dst_major(x: torch.Tensor) -> torch.Tensor:
    """Mailbox plane (src, dst, G) -> (me=dst, src, G), a view: the
    receiver-major order every lane-major handler consumes."""
    return x.transpose(0, 1)


def diag2(x: torch.Tensor) -> torch.Tensor:
    """State plane (R, R, ...) -> (R, ...) at second index == replica: a
    replica's own row (its own instance column), as a fresh tensor."""
    return torch.stack([x[p, p] for p in range(x.shape[0])], dim=0)


def shift_window(arr: torch.Tensor, adv: torch.Tensor, fill) -> torch.Tensor:
    """Slide ``arr (..., S, G)`` forward along the slot axis by ``adv
    (..., G)``: out[..., i, g] = arr[..., i + adv[..., g], g], ``fill``
    where that position falls outside the window.  ``adv`` broadcasts
    against the lead axes of ``arr``."""
    S = arr.shape[-2]
    sidx = torch.arange(S, dtype=torch.int32, device=arr.device)
    idx = sidx[:, None] + adv[..., None, :]
    valid = (idx >= 0) & (idx < S)
    idxc = torch.clamp(idx, 0, S - 1).to(torch.int64)
    got = torch.gather(arr, -2, idxc.expand(arr.shape))
    return torch.where(valid, got, fill)


def shift_row(row: torch.Tensor, adv: torch.Tensor, fill) -> torch.Tensor:
    """``shift_window`` of one source plane viewed by R readers at
    per-``(r, g)`` offsets: ``row (S, G)``, ``adv (R, G)`` ->
    out[r, i, g] = row[i + adv[r, g], g], ``fill`` outside the window."""
    R = adv.shape[0]
    return shift_window(row.expand((R,) + tuple(row.shape)), adv, fill)


def shift_deps(pl: torch.Tensor, adv: torch.Tensor, fill=-1) -> torch.Tensor:
    """``shift_window`` for a deps-style plane ``(..., S, R, G)`` whose
    slot axis sits third from last: the (S, R) pair is transposed around
    the shift and back."""
    return shift_window(pl.transpose(-3, -2), adv[..., None, :],
                        fill).transpose(-3, -2)
