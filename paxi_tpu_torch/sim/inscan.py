"""In-scan linearizability spot-checker (torch twin of the JAX package's
``sim/inscan.py``, lane-major form).

Four elementwise checks per step, accumulated per group: the commit
frontier never regresses; a committed cell whose absolute slot is
unchanged keeps its commit bit and value; committed cells holding the same
absolute slot at different replicas agree; two replicas with the same
execute frontier hold bitwise-equal registers.
"""

from __future__ import annotations

from typing import Optional

import torch

_I32 = torch.iinfo(torch.int32)


def _red(x: torch.Tensor) -> torch.Tensor:
    """Sum every axis but the trailing group axis, in int32."""
    return torch.sum(x, dim=tuple(range(x.ndim - 1)), dtype=torch.int32)


def spot_check(old_exec, new_exec, old_base, new_base,
               old_abs, new_abs, old_cmd, new_cmd,
               old_commit, new_commit,
               kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step's violation count per group, ``(G,)`` int32.

    Lane axis 0 is the replica and the group axis is last; every check
    reduces over all the axes between.  ``*_exec``/``*_base`` are lane
    planes ``(R, ..., G)`` (paxos ``(R, G)``; epaxos the per-key counts
    ``(R, K, G)`` and the bases ``(R, R, G)``); ``*_abs``/``*_cmd``/
    ``*_commit`` add the slot axis before ``G`` (``(R, S, G)``, epaxos
    ``(R, R, I, G)``).  ``kv`` is shaped like ``*_exec`` or has one more
    axis at position 1 (``(R, K, G)`` beside ``(R, G)``)."""
    # 1. monotone commit frontier
    v = _red(new_exec < old_exec) + _red(new_base < old_base)

    # 2. same-cell committed-value stability
    v = v + _red(old_commit & (old_abs == new_abs)
                 & (~new_commit | (new_cmd != old_cmd)))

    # 3. per-slot agreement on the most-advanced replica's frame, with the
    # full int32 extremes as sentinels
    vis = new_commit & (new_abs == torch.amax(new_abs, dim=0,
                                              keepdim=True))
    mx = torch.amax(torch.where(vis, new_cmd, _I32.min), dim=0)
    mn = torch.amin(torch.where(vis, new_cmd, _I32.max), dim=0)
    v = v + _red(torch.any(vis, dim=0) & (mx != mn))

    # 4. register condition: equal frontier => equal registers
    if kv is not None:
        R = new_exec.shape[0]
        eq = new_exec[:, None] == new_exec[None, :]       # (R, R, G)
        if kv.ndim == new_exec.ndim + 1:
            diff = torch.any(kv[:, None] != kv[None, :], dim=2)
        else:
            diff = kv[:, None] != kv[None, :]
        r = torch.arange(R, device=new_exec.device)
        pair = (r[:, None] < r[None, :]).reshape(
            (R, R) + (1,) * (eq.ndim - 2))
        v = v + _red(eq & diff & pair)
    return v
