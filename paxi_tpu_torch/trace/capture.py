"""Capture: materialize the fault schedule behind a violation (the port's
copy of the JAX package's ``trace/capture.py``).

``capture`` reruns a (protocol, cfg, fuzz, seed, groups, steps)
combination in the runner's record mode, which emits every group's
schedule and the ``(T, G)`` violation matrix, and slices the chosen
group's schedule out into a single-group Trace.  Replaying it through the
pinned path reproduces the run bit for bit.  No violation -> None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.metrics.simcount import counters_of
from paxi_tpu_torch.sim.runner import make_recorded_run
from paxi_tpu_torch.sim.types import FuzzConfig, SimConfig, SimProtocol
from paxi_tpu_torch.trace import replay as _replay
from paxi_tpu_torch.trace.format import Trace, make_meta, schedule_hash


def _slice_group(sched, g: int):
    """Group ``g``'s schedule (numpy) out of the lane-major record."""
    if isinstance(sched, dict):
        return {k: _slice_group(v, g) for k, v in sched.items()}
    return sched[..., g].cpu().numpy()


def choose_group(viols: np.ndarray) -> int:
    """The group whose first violation comes earliest, ties broken by the
    larger violation count, then the lower index; ``viols`` is ``(T,
    G)``."""
    n_steps = viols.shape[0]
    per_group = viols.sum(axis=0)
    first_step = np.where(viols > 0, np.arange(n_steps)[:, None],
                          n_steps).min(axis=0)
    cands = np.nonzero(per_group > 0)[0]
    return int(cands[np.lexsort((-per_group[cands],
                                 first_step[cands]))][0])


def capture(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
            seed: int, n_groups: int, n_steps: int,
            group: Optional[int] = None, proto_name: Optional[str] = None,
            device=None) -> Optional[Trace]:
    """Record-mode run on ``device`` (the card unless ``"cpu"`` is asked
    for); returns the chosen group's Trace or None.  ``group`` forces a
    group (a non-violating one too); by default the group with the
    earliest violation wins."""
    run = make_recorded_run(proto, cfg, fuzz, device=device)
    state, metrics, total, viols, sched = run(tr.PRNGKey(seed), n_groups,
                                              n_steps)
    viols = viols.cpu().numpy()                        # (T, G)
    if group is None:
        if int(total) == 0:
            return None
        group = choose_group(viols)
    g = int(group)
    gsched = _slice_group(sched, g)
    del sched
    gstate = _replay.group_state(state, g)
    gviols = viols[:, g]
    nz = np.nonzero(gviols)[0]
    extra = {}
    ghist = lathist.total_hist(gstate)
    if ghist is not None:
        extra["capture_lat_hist"] = lathist.to_sparse(ghist)
    meta = make_meta(
        proto_name or proto.name, cfg, fuzz, seed, n_groups, g,
        group_violations=int(gviols.sum()),
        first_violation_step=int(nz[0]) if nz.size else -1,
        capture_state_hash=_replay.state_hash(gstate),
        capture_counters={k: int(v)
                          for k, v in counters_of(metrics).items()},
        shrunk=False, **extra)
    t = Trace(meta=meta, sched=gsched)
    meta["schedule_hash"] = schedule_hash(t)
    return t
