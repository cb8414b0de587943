"""Pinned-schedule replay: run a trace, get the violation back (the port's
copy of the JAX package's ``trace/replay.py``).

The replay (``sim/runner.make_pinned_run``) reruns the captured run with
the same seed and geometry: the traced group consumes the trace's planes
in place of its draws while the other groups keep theirs; they are the
scaffolding that pins the traced group's workload, so the whole batch is
rerun.  Replaying an unedited capture is the original run bit for bit;
an edited (shrunk) schedule replays just as deterministically, which is
what makes the shrinker's oracle sound.

``state_hash`` fingerprints the traced group's final state the way the
reference does, byte for byte, so a trace captured by either package
replays in the other to the hash stamped at capture.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.sim.checkpoint import key_paths, path_repr
from paxi_tpu_torch.sim.runner import make_pinned_run
from paxi_tpu_torch.sim.types import SimProtocol
from paxi_tpu_torch.trace.format import Trace


@dataclass
class ReplayResult:
    violations: int           # traced group's total invariant violations
    viol_steps: np.ndarray    # per-step violation counts, shape (T,)
    state_hash: str           # fingerprint of the group's final state
    metrics: Dict[str, int]   # whole-batch metrics (context, not oracle)
    # the traced group's commit-latency histogram (sparse {bucket: count}),
    # None for kernels without the ``m_lat_hist`` plane; an unedited
    # capture's replay reproduces the trace's ``capture_lat_hist``
    lat_hist: Optional[Dict[str, int]] = None

    @property
    def violated(self) -> bool:
        return self.violations > 0

    @property
    def counters(self) -> Dict[str, int]:
        """Whole-batch message/fault counters (``net_*`` metrics, prefix
        stripped); an unedited capture's replay reproduces the trace's
        ``capture_counters``."""
        from paxi_tpu_torch.metrics.simcount import counters_of
        return counters_of(self.metrics)

    def first_violation_step(self) -> Optional[int]:
        nz = np.nonzero(self.viol_steps)[0]
        return int(nz[0]) if nz.size else None


def state_hash(state) -> str:
    """Order-, dtype- and shape-sensitive fingerprint of a state tree
    (numpy arrays or tensors), the reference's digest.  Top-level keys
    prefixed ``m_`` (measurement planes that never feed a transition) are
    left out."""
    if isinstance(state, dict):
        state = {k: v for k, v in state.items() if not k.startswith("m_")}
    h = hashlib.sha256()
    for path, leaf in key_paths(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.asarray(leaf)
        h.update(path_repr(path).encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def resolve_protocol(name: str) -> SimProtocol:
    from paxi_tpu_torch.protocols import sim_protocol
    return sim_protocol(name)


def group_state(state, g: int) -> Dict[str, np.ndarray]:
    """Group ``g``'s planes of a group-leading state, as numpy."""
    return {k: v[g].detach().cpu().numpy() for k, v in state.items()}


def replay(trace: Trace, proto: Optional[SimProtocol] = None, sched=None,
           mesh=None, device=None) -> ReplayResult:
    """Replay ``trace`` (or an edited ``sched`` against the trace's
    provenance) on ``device`` (the card unless ``"cpu"`` is asked for) and
    report the traced group's violations.

    ``mesh`` (a ``parallel.Mesh``; every rank calls) shards the replay
    batch over its ranks (``parallel.make_sharded_pinned_run``, per-group
    kernels only): it reproduces the single-device replay's state hash and
    counters, and each rank returns the whole result."""
    from paxi_tpu_torch.metrics import lathist
    proto = proto or resolve_protocol(trace.protocol)
    sched = trace.sched if sched is None else sched
    if mesh is not None:
        from paxi_tpu_torch.parallel.mesh import (gather_state,
                                                  make_sharded_pinned_run)
        run = make_sharded_pinned_run(proto, trace.sim_config(),
                                      trace.fuzz_config(), trace.group,
                                      mesh=mesh)
        state, metrics, total, viols = run(tr.PRNGKey(trace.seed),
                                           trace.n_groups, sched)
        state = gather_state(state, mesh, trace.n_groups)
    else:
        run = make_pinned_run(proto, trace.sim_config(),
                              trace.fuzz_config(), trace.group,
                              device=device)
        state, metrics, total, viols = run(tr.PRNGKey(trace.seed),
                                           trace.n_groups, sched)
    gstate = group_state(state, trace.group)
    ghist = lathist.total_hist(gstate)
    return ReplayResult(
        violations=int(total),
        viol_steps=viols.cpu().numpy().reshape(-1),
        state_hash=state_hash(gstate),
        metrics={k: int(v) for k, v in metrics.items()},
        lat_hist=None if ghist is None else lathist.to_sparse(ghist))


def check_determinism(trace: Trace, proto: Optional[SimProtocol] = None,
                      device=None) -> ReplayResult:
    """Replay twice and assert identical outcomes; returns the result."""
    a = replay(trace, proto, device=device)
    b = replay(trace, proto, device=device)
    if a.state_hash != b.state_hash or a.violations != b.violations:
        raise AssertionError(
            f"non-deterministic replay: {a.violations}@{a.state_hash[:12]}"
            f" vs {b.violations}@{b.state_hash[:12]}")
    if a.counters != b.counters:
        raise AssertionError(
            f"non-deterministic replay counters: {a.counters} "
            f"vs {b.counters}")
    return a
