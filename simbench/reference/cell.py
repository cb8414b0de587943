"""Fixed-cell ring primitives (a frozen copy of the port's
``sim/cell.py``).

Absolute slot ``a`` lives at ring cell ``a % S`` forever: advancing the
window is a masked clear of the recycled cells, and any two replicas'
cells line up without realignment.  Ring planes are ``(..., S, G)`` with
the slot axis second-to-last; ``base`` is ``(..., G)`` absolute.
"""

from __future__ import annotations

import torch


def _sidx(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)


def cell_abs(base: torch.Tensor, S: int) -> torch.Tensor:
    """The absolute slot cell ``c`` currently holds: the element of
    ``[base, base + S)`` congruent to ``c`` (mod S).  Returns
    ``(..., S, G)``."""
    b = base.unsqueeze(-2)
    return b + torch.remainder(_sidx(S, base.device)[:, None] - b, S)


def cell_onehot(slot: torch.Tensor, S: int) -> torch.Tensor:
    """One-hot ``(..., S, G)`` of the cell holding absolute ``slot``; no
    in-window validity (callers mask with ``in_window``)."""
    return (_sidx(S, slot.device)[:, None]
            == torch.remainder(slot, S).unsqueeze(-2))


def in_window(slot, base, S: int):
    """``base <= slot < base + S``."""
    return (slot >= base) & (slot < base + S)


def advance_clear(plane, old_base, new_base, fill):
    """Reset to ``fill`` the cells whose absolute slot (under
    ``old_base``) fell below ``new_base`` — the window advance."""
    S = plane.shape[-2]
    drop = cell_abs(old_base, S) < new_base.unsqueeze(-2)
    return torch.where(drop, fill, plane)

