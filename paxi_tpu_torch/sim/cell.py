"""Fixed-cell ring primitives (torch twin of the JAX package's
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


# ring-shaped state planes of each fixed-cell kernel (slot axis LAST in
# the runner's group-major final state): the one registry behind the
# equivalence canonicalizer
RING_PLANES = {
    "paxos": ("log_bal", "log_cmd", "log_commit", "log_acks",
              "proposed"),
    "sdpaxos": ("log_bal", "log_cmd", "log_commit", "log_acks",
                "proposed"),
    "wankeeper": ("log_bal", "log_cmd", "log_commit", "log_acks",
                  "proposed"),
    "wpaxos": ("log_bal", "log_cmd", "log_commit", "log_acks",
               "proposed"),
    "bpaxos": ("abal", "vbal", "vcmd", "vbsz", "committed", "proposed",
               "p2_acks"),
}


def canonical_state_np(name, state):
    """A fixed-cell kernel's group-major final state -> the window-ordered
    view the sliding-window layout (``protocols/*/sim_sw.py``) stores
    directly (numpy; ``m_`` planes dropped: they are compared through the
    metrics).  Tests and tooling only."""
    import numpy as np
    base = np.asarray(_np(state["base"]))
    ring = RING_PLANES[name]
    return {k: (window_view_np(v, base) if k in ring
                else np.asarray(_np(v)))
            for k, v in state.items() if not k.startswith("m_")}


def window_view_np(plane, base):
    """Roll a fixed-cell ring plane to window order (numpy; a gather, so
    it never runs inside a step).  Takes the runner's group-major final
    state: slot axis LAST (``(G, R, S)`` / ``(G, R, O, S)``), ``base``
    matching the leading dims.  ``out[..., i] = plane[..., (base + i) %
    S]`` holds absolute slot ``base + i``, what ring position ``i`` holds
    in the sliding-window layout."""
    import numpy as np
    plane = np.asarray(_np(plane))
    base = np.asarray(_np(base))
    S = plane.shape[-1]
    idx = (base[..., None] + np.arange(S)) % S
    return np.take_along_axis(plane, idx, axis=-1)


def _np(x):
    """A tensor as numpy (host copy); anything else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
