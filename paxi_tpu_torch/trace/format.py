"""The trace file format: a violation's fault schedule as an artifact (the
port's copy of the JAX package's ``trace/format.py``; a trace saved by
either package loads in the other, and ``schedule_hash`` gives the same
hex digest in both).

A trace records the fault schedule one simulated group experienced, per
step: the connectivity plane, the crash vector, and per message type the
effective drop/delay/dup planes (only events that met an actual send;
see ``sim/runner._group_step``'s record path).  With (protocol, geometry,
fuzz config, seed, group) it pins a run: the pinned replay consumes the
planes in place of the group's draws.

Container: one ``.npz`` of path-flattened arrays plus a JSON meta blob,
the envelope of ``sim/checkpoint.py``.

Schedule tree (one group, time-major)::

    {"conn":    (T, R, R) bool,
     "crashed": (T, R)    bool,
     "faults":  {msg_type: {"drop":  (T, R, R) bool,
                            "delay": (T, R, R) int32,
                            "dup":   (T, R, R) bool}}}
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from paxi_tpu_torch.sim.checkpoint import flatten
from paxi_tpu_torch.sim.types import FuzzConfig, SimConfig

_META_KEY = "__paxi_tpu_trace_meta__"
_SEP = "|"
# bump on incompatible schedule-layout changes; load() refuses a mismatch
TRACE_VERSION = 1


@dataclass
class Trace:
    """A captured (or shrunk) single-group fault schedule + provenance."""

    meta: Dict[str, Any]
    sched: Dict[str, Any]     # tree of numpy arrays, time-major

    @property
    def protocol(self) -> str:
        return self.meta["protocol"]

    @property
    def group(self) -> int:
        return int(self.meta["group"])

    @property
    def n_groups(self) -> int:
        return int(self.meta["n_groups"])

    @property
    def seed(self) -> int:
        return int(self.meta["seed"])

    @property
    def n_steps(self) -> int:
        return int(np.asarray(self.sched["crashed"]).shape[0])

    def sim_config(self) -> SimConfig:
        return SimConfig(**self.meta["sim_cfg"])

    def fuzz_config(self) -> FuzzConfig:
        return fuzz_from_meta(self.meta["fuzz"])

    def n_events(self) -> int:
        """Total fault events in the schedule (what the shrinker
        minimizes): drops + dups + delayed sends + crashed replica-steps
        + severed edge-steps."""
        s = self.sched
        n = int(np.sum(~np.asarray(s["conn"])))
        n += int(np.sum(np.asarray(s["crashed"])))
        for f in s["faults"].values():
            n += int(np.sum(np.asarray(f["drop"])))
            n += int(np.sum(np.asarray(f["dup"])))
            n += int(np.sum(np.asarray(f["delay"]) > 1))
        return n

    def with_sched(self, sched, **meta_updates) -> "Trace":
        meta = dict(self.meta, **meta_updates)
        t = Trace(meta=meta, sched=sched)
        if "schedule_hash" in meta and "schedule_hash" not in meta_updates:
            # an inherited stamp describes the old schedule: refresh it
            meta["schedule_hash"] = schedule_hash(t)
        return t


def fuzz_from_meta(d: Dict[str, Any]) -> FuzzConfig:
    """Rebuild a FuzzConfig from trace meta (``dataclasses.asdict`` after
    a JSON round-trip); a trace without ``scenario`` rebuilds with
    ``scenario=None``, a newer one rebuilds the nested Scenario."""
    d = dict(d)
    scn = d.pop("scenario", None)
    fz = FuzzConfig(**d)
    if scn is not None:
        from paxi_tpu_torch.scenarios.spec import Scenario
        fz = dataclasses.replace(fz, scenario=Scenario.from_dict(scn))
    return fz


def schedule_hash(trace: "Trace") -> str:
    """Content hash of (protocol, schedule planes), independent of
    provenance: the corpus dedup key."""
    h = hashlib.sha256()
    h.update(trace.protocol.encode())
    for name, arr in sorted(flatten(trace.sched).items()):
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def make_meta(proto_name: str, cfg: SimConfig, fuzz: FuzzConfig,
              seed: int, n_groups: int, group: int,
              **extra) -> Dict[str, Any]:
    meta = {
        "trace_version": TRACE_VERSION,
        "protocol": proto_name,
        "sim_cfg": dataclasses.asdict(cfg),
        "fuzz": dataclasses.asdict(fuzz),
        "seed": int(seed),
        "n_groups": int(n_groups),
        "group": int(group),
    }
    meta.update(extra)
    return meta


def _norm(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, trace: Trace) -> str:
    """Write a trace; returns the (normalized) path written."""
    flat = flatten(trace.sched)
    meta = dict(trace.meta)
    meta.setdefault("trace_version", TRACE_VERSION)
    meta.setdefault("schedule_hash", schedule_hash(trace))
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                    dtype=np.uint8)
    path = _norm(path)
    np.savez_compressed(path, **flat)
    return path


def load(path: str) -> Trace:
    with np.load(_norm(path)) as z:
        if _META_KEY not in z:
            raise ValueError(f"{path!r} is not a paxi_tpu trace file")
        meta = json.loads(bytes(z[_META_KEY]).decode())
        flat = {k: z[k] for k in z.files if k != _META_KEY}
    v = int(meta.get("trace_version", 0))
    if v != TRACE_VERSION:
        raise ValueError(
            f"trace version v{v} is incompatible with this build "
            f"(v{TRACE_VERSION}); re-capture the trace")
    sched: Dict[str, Any] = {"faults": {}}
    for key, arr in flat.items():
        parts = [p.strip("[']") for p in key.split(_SEP)]
        node = sched
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    for req in ("conn", "crashed"):
        if req not in sched:
            raise ValueError(f"trace {path!r} missing {req!r} plane")
    return Trace(meta=meta, sched=sched)
