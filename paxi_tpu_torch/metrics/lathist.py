"""Sim-side commit-latency histograms (torch twin of the JAX package's
``metrics/lathist.py``: the kernel half on tensors, the host half on
numpy).

Layout: ``N_BUCKETS`` buckets over propose->commit step deltas; bucket 0
holds ``dt <= 1``, bucket ``i`` (1..N_BUCKETS-2) holds ``dt`` in
``(2**(i-1), 2**i]``, the last bucket is overflow.  The layout is fixed,
so histogram planes merge by bucket-count addition.
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from paxi_tpu_torch.sim.types import resolve_device

N_BUCKETS = 12
BOUNDS_STEPS = tuple(2 ** i for i in range(N_BUCKETS - 1))  # 1..1024


def empty_hist(n_groups: int, device=None) -> torch.Tensor:
    """Zeroed lane-major ``m_lat_hist`` plane, (N_BUCKETS, G) int32, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    return torch.zeros((N_BUCKETS, n_groups), dtype=torch.int32,
                       device=resolve_device(device))


def hist_update(hist, dt, mask):
    """Accumulate masked step deltas into a histogram plane: one masked
    count per bucket bound, then adjacent differences.  ``dt``/``mask``
    trailing dims match ``hist[1:]``."""
    axes = tuple(range(dt.ndim - (hist.ndim - 1)))

    def tot(x):
        return torch.sum(x, dim=axes, dtype=torch.int32)

    above = [tot(mask & (dt > b)) for b in BOUNDS_STEPS]
    rows = [tot(mask) - above[0]]
    rows += [above[i] - above[i + 1] for i in range(len(above) - 1)]
    rows.append(above[-1])
    return hist + torch.stack(rows)


def flush_every(n_slots: int) -> int:
    """Deferred-binning period: any period <= n_slots/2 bins a pending
    delta before its cell can be recycled into a new commit."""
    return max(1, min(16, n_slots // 2))


def flush_pending(state):
    """Bin the pending ``m_commit_dt`` plane into ``m_lat_hist`` and
    clear it."""
    pend = state["m_commit_dt"]
    hist = hist_update(state["m_lat_hist"], pend, pend > 0)
    return dict(state, m_lat_hist=hist, m_commit_dt=torch.zeros_like(pend))


# ---- host-side reductions (numpy; run after the step loop) ---------------

def to_sparse(counts) -> Dict[str, int]:
    """Sparse ``{bucket_index: count}`` form of a bucket vector."""
    return {str(i): int(c)
            for i, c in enumerate(np.asarray(counts).reshape(-1)) if c}


def bin_steps(dts) -> np.ndarray:
    """Histogram a flat array of positive step deltas (numpy twin of
    ``hist_update``; folds an end-of-run pending plane)."""
    out = np.zeros(N_BUCKETS, np.int32)
    dts = np.asarray(dts).reshape(-1)
    dts = dts[dts > 0]
    if dts.size:
        idx = np.sum(dts[:, None] > np.asarray(BOUNDS_STEPS)[None, :],
                     axis=1)
        np.add.at(out, idx, 1)
    return out


def plane_total(plane) -> np.ndarray:
    """Sum a group-major histogram plane (bucket axis LAST) down to one
    bucket vector."""
    h = np.asarray(plane).astype(np.int64)
    return h.reshape(-1, N_BUCKETS).sum(axis=0).astype(np.int32)


def total_hist(state) -> Optional[np.ndarray]:
    """Whole-state bucket vector of a group-major numpy state: the
    accumulated ``m_lat_hist`` plus samples still pending in
    ``m_commit_dt``; None when uninstrumented."""
    if not (isinstance(state, dict) and "m_lat_hist" in state):
        return None
    h = plane_total(state["m_lat_hist"])
    if "m_commit_dt" in state:
        h = h + bin_steps(state["m_commit_dt"])
    return h


def _midpoint_steps(i: int) -> float:
    """Geometric midpoint of bucket ``i`` in steps."""
    if i == 0:
        return 1.0
    if i >= N_BUCKETS - 1:                      # overflow
        return 2.0 * BOUNDS_STEPS[-1]
    return math.sqrt(BOUNDS_STEPS[i - 1] * BOUNDS_STEPS[i])


def percentile_steps(counts, p: float) -> float:
    """Nearest-rank percentile of a bucket vector, in steps."""
    counts = np.asarray(counts).reshape(-1)
    total = int(counts.sum())
    if not total:
        return 0.0
    rank = max(math.ceil(p / 100.0 * total), 1)
    acc = 0
    for i, c in enumerate(counts):
        acc += int(c)
        if acc >= rank:
            return _midpoint_steps(i)
    return _midpoint_steps(N_BUCKETS - 1)


def to_host_snapshot(counts, sum_steps: int,
                     step_seconds: float = 1.0) -> Dict[str, Any]:
    """A sim bucket vector in the host registry's histogram snapshot
    schema (``registry.HIST_SCHEME``), at ``step_seconds`` simulated
    seconds a lock-step round.  Each sim bucket's count lands in the host
    bucket holding its geometric midpoint; min/max are bucket-bound
    envelopes (the kernel keeps no exact extrema)."""
    from paxi_tpu_torch.metrics.registry import HIST_BOUNDS, HIST_SCHEME

    counts = np.asarray(counts).reshape(-1)
    if counts.shape != (N_BUCKETS,):
        raise ValueError(f"expected {N_BUCKETS} buckets, got "
                         f"{counts.shape}")
    n = len(HIST_BOUNDS)
    host = [0] * (n + 1)
    for i, c in enumerate(counts):
        if not c:
            continue
        v = _midpoint_steps(i) * step_seconds
        host[min(bisect.bisect_left(HIST_BOUNDS, v), n)] += int(c)
    total = int(counts.sum())
    nz = np.nonzero(counts)[0]
    vmin = vmax = 0.0
    if nz.size:
        lo = 0.0 if nz[0] == 0 else float(BOUNDS_STEPS[nz[0] - 1])
        hi = (float(BOUNDS_STEPS[nz[-1]]) if nz[-1] < N_BUCKETS - 1
              else 2.0 * BOUNDS_STEPS[-1])
        vmin, vmax = lo * step_seconds, hi * step_seconds
    return {
        "scheme": HIST_SCHEME,
        "count": total,
        "sum": float(sum_steps) * step_seconds,
        "min": vmin,
        "max": vmax,
        "buckets": {str(i): c for i, c in enumerate(host) if c},
    }


def summarize(counts, sum_steps: int) -> Dict[str, Any]:
    """The bench-row form: p50/p99/p999 in lock-step rounds plus the
    sample count, mean and sparse buckets."""
    counts = np.asarray(counts).reshape(-1)
    total = int(counts.sum())
    return {
        "n": total,
        "mean_rounds": round(float(sum_steps) / total, 3) if total else 0.0,
        "p50_rounds": round(percentile_steps(counts, 50), 3),
        "p99_rounds": round(percentile_steps(counts, 99), 3),
        "p999_rounds": round(percentile_steps(counts, 99.9), 3),
        "buckets": to_sparse(counts),
    }
