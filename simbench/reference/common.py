"""Shared plain pieces of the reference: the group geometry, the step
context, the command hash, the commit-latency histogram's kernel half and
the in-round linearizability spot-check.

Frozen copies of the port's ``sim/types.py`` (every field of its
``SimConfig``, with the same defaults), ``ops/hashing.py``,
``metrics/lathist.py`` and ``sim/inscan.py``.  The group axis is last on
every plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

I32 = torch.int32


@dataclass(frozen=True)
class Geometry:
    """Per-group geometry: every field of the port's simulation config,
    with the same defaults, so that a configuration file's ``sim`` object
    means the same run on both sides; each reference protocol reads the
    fields it needs."""

    n_replicas: int = 3
    n_slots: int = 64
    n_keys: int = 16
    n_zones: int = 1
    exec_window: int = 4
    ballot_stride: int = 64
    election_timeout: int = 8
    backoff: int = 8
    retry_timeout: int = 6
    # protocol-specific extras (ignored by protocols that don't use them)
    n_objects: int = 8
    steal_threshold: int = 3
    grid_q2: int = 1
    locality: float = 0.8
    fast_quorum: bool = True
    n_proxies: int = 2
    grid_rows: int = 2
    grid_cols: int = 2
    batch_max: int = 4
    sw_window: int = 16
    sw_down_start: int = -1
    sw_down_period: int = 0
    sw_down_for: int = 0
    # a configuration's ``workload`` object as the plain dict of its file
    # (the port receives it as its ``Workload``), or None
    workload: Any = None

    @property
    def majority(self) -> int:
        return self.n_replicas // 2 + 1

    @property
    def fast_size(self) -> int:
        return -(-3 * self.n_replicas // 4)  # ceil(3N/4)


@dataclass(frozen=True)
class Faults:
    """The fault schedule of a traffic mix: messages arrive after
    ``1..max_delay`` rounds and drop with ``p_drop``; ``p_crash`` and
    ``p_partition`` resample every ``window`` rounds."""

    max_delay: int = 1
    p_drop: float = 0.0
    p_dup: float = 0.0
    p_crash: float = 0.0
    p_partition: float = 0.0
    window: int = 16

    @property
    def wheel(self) -> int:
        return max(self.max_delay, 1)


class StepCtx(NamedTuple):
    rng: Any          # this round's key (``prng.LaneKey``)
    t: int            # round index
    cfg: Geometry


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over every axis but the trailing group axis: ``(G,)``."""
    if x.ndim == 1:
        return x.to(I32)
    return torch.sum(x, dim=tuple(range(x.ndim - 1)), dtype=I32)


# ---- command hash ---------------------------------------------------------

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
    return torch.remainder(h, n_keys).to(I32)


# ---- commit-latency histogram (kernel half) -------------------------------

N_BUCKETS = 12
BOUNDS_STEPS = tuple(2 ** i for i in range(N_BUCKETS - 1))  # 1..1024


def empty_hist(n_groups: int, device=None) -> torch.Tensor:
    return torch.zeros((N_BUCKETS, n_groups), dtype=I32, device=device)


def hist_update(hist, dt, mask):
    """Accumulate masked round deltas: one masked count per bucket bound,
    then adjacent differences."""
    axes = tuple(range(dt.ndim - (hist.ndim - 1)))

    def tot(x):
        return torch.sum(x, dim=axes, dtype=I32)

    above = [tot(mask & (dt > b)) for b in BOUNDS_STEPS]
    rows = [tot(mask) - above[0]]
    rows += [above[i] - above[i + 1] for i in range(len(above) - 1)]
    rows.append(above[-1])
    return hist + torch.stack(rows)


def flush_every(n_slots: int) -> int:
    """Deferred-binning period (at most half the window)."""
    return max(1, min(16, n_slots // 2))


def flush_pending(state):
    """Bin the pending ``m_commit_dt`` plane into ``m_lat_hist``."""
    pend = state["m_commit_dt"]
    hist = hist_update(state["m_lat_hist"], pend, pend > 0)
    return dict(state, m_lat_hist=hist, m_commit_dt=torch.zeros_like(pend))


# ---- in-round linearizability spot-check ----------------------------------

_I32 = torch.iinfo(I32)


def _red(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(x.ndim - 1)), dtype=I32)


def spot_check(old_exec, new_exec, old_base, new_base,
               old_abs, new_abs, old_cmd, new_cmd,
               old_commit, new_commit,
               kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round's violation count per group, ``(G,)`` int32: the commit
    frontier never regresses; a committed cell keeps its value; committed
    cells of one absolute slot agree; equal frontiers hold equal
    registers."""
    v = _red(new_exec < old_exec) + _red(new_base < old_base)
    v = v + _red(old_commit & (old_abs == new_abs)
                 & (~new_commit | (new_cmd != old_cmd)))
    vis = new_commit & (new_abs == torch.amax(new_abs, dim=0,
                                              keepdim=True))
    mx = torch.amax(torch.where(vis, new_cmd, _I32.min), dim=0)
    mn = torch.amin(torch.where(vis, new_cmd, _I32.max), dim=0)
    v = v + _red(torch.any(vis, dim=0) & (mx != mn))
    if kv is not None:
        R = new_exec.shape[0]
        eq = new_exec[:, None] == new_exec[None, :]
        if kv.ndim == new_exec.ndim + 1:
            diff = torch.any(kv[:, None] != kv[None, :], dim=2)
        else:
            diff = kv[:, None] != kv[None, :]
        r = torch.arange(R, device=new_exec.device)
        pair = (r[:, None] < r[None, :]).reshape(
            (R, R) + (1,) * (eq.ndim - 2))
        v = v + _red(eq & diff & pair)
    return v
