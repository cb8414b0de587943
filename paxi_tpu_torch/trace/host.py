"""Project a sim trace onto the host runtime's fault surface (the port's
copy of the JAX package's ``trace/host.py``).

The sim's drop/dup/delay/partition/crash schedule generalizes the host
sockets' faults, so a captured schedule projects back:

- ``seq_schedule``: the exact-order projection the virtual-clock fabric
  (``host/fabric.py``) replays.  Per-message-type drops and delays
  become occurrence-indexed ``SeqFault``s on the host message classes
  the protocol's ``TRACE_MSG_MAP`` names, crashes and partition cuts
  per-logical-step sets, and dups (TCP never duplicates) are counted
  and left out.  The hunt's classifier replays it
  (``hunt/classify.replay_witness``) and reads its coverage.
- ``host_directives``: the windowed projection onto the sockets'
  wall-clock surface (``DropMsg`` first-N drops, ``SlowWin``/``CrashWin``/
  ``DropWin`` windows scaled by ``step_s``), which ``trace host`` prints
  and ``apply_immediate`` installs.

Each protocol's map (sim mailbox name -> host message class) is its host
twin's own ``TRACE_MSG_MAP`` (``protocols._HOST_MODULES``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paxi_tpu_torch.core.config import local_config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.trace.format import Trace


# ---- directive vocabulary ----------------------------------------------
@dataclass
class DropMsg:
    """Drop ``count`` messages of class ``msg_type`` on src->dst (after
    ``skip`` matching ones pass); ``key`` narrows to one object.

    ``steps`` is provenance only: the sim step indices of the recorded
    drops.  The projection applies a first-N approximation (skip=0) —
    the host runtime has no lock-step rounds, so "which occurrence"
    cannot be recovered from step indices alone; when a witness hinges
    on dropping a LATER occurrence, set ``skip`` by hand (the recorded
    steps say where to look)."""

    src: str
    dst: str
    msg_type: str
    count: int = 1
    skip: int = 0
    key: Optional[int] = None
    steps: Optional[List[int]] = None


@dataclass
class DelayMsg:
    """Hold matching messages for ``delay_s`` — the reordering fault."""

    src: str
    dst: str
    msg_type: str
    delay_s: float
    count: int = 1
    skip: int = 0
    key: Optional[int] = None


@dataclass
class CrashWin:
    id: str
    t0: float
    t1: float


@dataclass
class DropWin:
    src: str
    dst: str
    t0: float
    t1: float


@dataclass
class SlowWin:
    src: str
    dst: str
    delay_s: float
    t0: float
    t1: float


@dataclass
class FlakyWin:
    src: str
    dst: str
    p: float
    t0: float
    t1: float


Directive = Any


def directives_json(dirs: Sequence[Directive]) -> List[dict]:
    return [dict(kind=type(d).__name__, **dataclasses.asdict(d))
            for d in dirs]


# ---- sequenced (virtual-clock) vocabulary -------------------------------
@dataclass
class SeqFault:
    """One occurrence-indexed fault for the virtual-clock fabric
    (host/fabric.py): act on the ``occurrence``-th (0-based) host send
    of class ``msg_type`` on src->dst.  Unlike ``DelayMsg``'s wall-clock
    window, ``delay_steps`` is an exact number of LOGICAL steps, so a
    recorded reorder replays as the same delivery order, not a time
    smear.  ``step`` is provenance (the recorded sim step)."""

    src: str
    dst: str
    msg_type: str
    occurrence: int
    action: str                # "drop" | "delay"
    delay_steps: int = 0       # extra logical steps beyond the normal 1
    step: int = 0


@dataclass
class SeqSchedule:
    """A trace projected onto the virtual-clock fabric's fault surface:
    occurrence-indexed per-message faults plus per-logical-step crash
    and partition-cut sets — the exact-order alternative to the
    windowed ``host_directives`` projection.

    ``edge_delay`` is the scenario engine's WAN plane
    (``scenarios/``): EXTRA logical steps added to every send on
    an (src, dst) edge — a standing per-edge latency rather than an
    occurrence-indexed event.  Trace projections leave it empty (a
    recorded schedule already carries its latency inside the per-event
    ``delay_steps``); ``scenarios.compile.seq_schedule_of`` fills it
    when a Scenario drives the fabric directly."""

    n_steps: int
    faults: List[SeqFault] = dataclasses.field(default_factory=list)
    crashed: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    cut: Dict[Tuple[str, str], List[int]] = dataclasses.field(
        default_factory=dict)
    edge_delay: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)
    # fault events the fabric cannot replay exactly: planes with no
    # TRACE_MSG_MAP entry (mailbox -> event count) and duplications
    # (neither TCP nor the chan fabric ever duplicate)
    unmapped: Dict[str, int] = dataclasses.field(default_factory=dict)
    dups_skipped: int = 0

    def __post_init__(self):
        self._idx: Dict[Tuple[str, str, str], Dict[int, SeqFault]] = {}
        for f in self.faults:
            self._idx.setdefault(
                (f.src, f.dst, f.msg_type), {})[f.occurrence] = f
        self._crashed = {i: frozenset(ts) for i, ts in self.crashed.items()}
        self._cut = {e: frozenset(ts) for e, ts in self.cut.items()}

    # fabric-facing lookups (hot path: one dict probe per send)
    def fault_for(self, src: str, dst: str, msg_type: str,
                  occurrence: int) -> Optional[SeqFault]:
        m = self._idx.get((src, dst, msg_type))
        return m.get(occurrence) if m else None

    def is_crashed(self, id: str, step: int) -> bool:
        return step in self._crashed.get(id, ())

    def is_cut(self, src: str, dst: str, step: int) -> bool:
        return step in self._cut.get((src, dst), ())

    def edge_extra(self, src: str, dst: str) -> int:
        """Standing per-edge latency (extra logical steps per send)."""
        return self.edge_delay.get((src, dst), 0)

    @property
    def exact(self) -> bool:
        """True when every recorded fault event replays exactly."""
        return not self.unmapped and self.dups_skipped == 0

    def to_json(self) -> dict:
        return {
            "n_steps": self.n_steps,
            "faults": [dataclasses.asdict(f) for f in self.faults],
            "crashed": {i: list(ts) for i, ts in self.crashed.items()},
            "cut": {f"{s}->{d}": list(ts)
                    for (s, d), ts in self.cut.items()},
            "edge_delay": {f"{s}->{d}": x
                           for (s, d), x in self.edge_delay.items()},
            "unmapped": dict(self.unmapped),
            "dups_skipped": self.dups_skipped,
        }


def id_order(i) -> Tuple[int, int]:
    """A ``"zone.node"`` replica id's numeric (zone, node) sort key (a
    bare node number is zone 1): ``core.ident.ID``'s order, under which
    lexical order would put ``"1.10"`` before ``"1.2"``."""
    i = ID(str(i))
    return i.zone, i.node


def local_ids(n_replicas: int, n_zones: int = 1) -> List[str]:
    """The replica ids of the host runtime's n-replica local config
    (``core.config.local_config``: ``n_zones`` zones of ``n_replicas //
    n_zones`` nodes, ``"z.n"``, both 1-based), in (zone, node) order."""
    return [str(i) for i in local_config(n_replicas, zones=n_zones).ids]


def host_algorithm(protocol: str) -> Optional[str]:
    """The host-registry name a sim protocol replays against, or None for
    sim-only protocols.  A variant registered on its base protocol's sim
    module (``wankeeper_nofloor``, ``paxos_pg``) maps to that base."""
    from paxi_tpu_torch.protocols import _HOST_MODULES, _SIM_MODULES
    base = protocol
    if base not in _HOST_MODULES:
        sim_mod = _SIM_MODULES.get(protocol, "").partition(":")[0]
        parts = sim_mod.rsplit(".", 2)
        base = parts[-2] if len(parts) >= 2 else protocol
    return base if base in _HOST_MODULES else None


def trace_msg_map(protocol: str) -> Dict[str, str]:
    """The protocol's sim-mailbox-name -> host-message-class map (its host
    twin's ``TRACE_MSG_MAP``; {} for a sim-only protocol)."""
    from paxi_tpu_torch.protocols import _HOST_MODULES
    base = host_algorithm(protocol)
    if base is None:
        return {}
    return dict(getattr(importlib.import_module(_HOST_MODULES[base]),
                        "TRACE_MSG_MAP", {}))


def _runs(ts: Sequence[int]) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi] runs of a sorted step list."""
    out: List[Tuple[int, int]] = []
    for t in ts:
        if out and t == out[-1][1] + 1:
            out[-1] = (out[-1][0], t)
        else:
            out.append((t, t))
    return out


def host_directives(trace: Trace, ids: Sequence, step_s: float = 0.05,
                    msg_map: Optional[Dict[str, str]] = None
                    ) -> Tuple[List[Directive], Dict[str, int]]:
    """Project ``trace`` onto host directives.  ``ids`` is the host
    config's replica-ID list in SIM ORDER (numerically sorted — sim
    replica r is sorted(cfg.ids)[r] under ID's (zone, node) order,
    matching the zone-block layout both runtimes derive from the id
    list; lexical order would misplace node/zone numbers >= 10).
    Returns (directives, stats)."""
    ids = [str(i) for i in sorted(ids, key=id_order)]
    if msg_map is None:
        msg_map = trace_msg_map(trace.protocol)
    sched = trace.sched
    dirs: List[Directive] = []
    stats = {"drops": 0, "drops_unmapped": 0, "dups_skipped": 0,
             "delays": 0, "crashes": 0, "cuts": 0}

    # message drops -> occurrence-indexed DropMsg (mapped types) or
    # coarse DropWin windows (unmapped types)
    per_edge: Dict[Tuple[str, int, int], List[int]] = {}
    win_edge: Dict[Tuple[int, int], List[int]] = {}
    for name in sorted(sched["faults"]):
        drop = np.asarray(sched["faults"][name]["drop"])
        for t, i, j in np.argwhere(drop):
            if name in msg_map:
                per_edge.setdefault((msg_map[name], int(i), int(j)),
                                    []).append(int(t))
                stats["drops"] += 1
            else:
                win_edge.setdefault((int(i), int(j)), []).append(int(t))
                stats["drops_unmapped"] += 1
        stats["dups_skipped"] += int(
            np.sum(np.asarray(sched["faults"][name]["dup"])))
    for (mt, i, j), ts in sorted(per_edge.items()):
        dirs.append(DropMsg(ids[i], ids[j], mt, count=len(ts),
                            steps=sorted(ts)))
    for (i, j), ts in sorted(win_edge.items()):
        for lo, hi in _runs(sorted(set(ts))):
            dirs.append(DropWin(ids[i], ids[j], lo * step_s,
                                (hi + 1) * step_s))

    # delays -> SlowWin per contiguous run; the per-event magnitude is
    # the schedule's wheel depth (max_delay steps, or the scenario
    # latency matrix's deepest entry — FuzzConfig.wheel covers both)
    lag = max(trace.fuzz_config().wheel - 1, 1) * step_s
    slow_edge: Dict[Tuple[int, int], set] = {}
    for name in sorted(sched["faults"]):
        delay = np.asarray(sched["faults"][name]["delay"])
        for t, i, j in np.argwhere(delay > 1):
            slow_edge.setdefault((int(i), int(j)), set()).add(int(t))
            stats["delays"] += 1
    for (i, j), ts in sorted(slow_edge.items()):
        for lo, hi in _runs(sorted(ts)):
            dirs.append(SlowWin(ids[i], ids[j], lag, lo * step_s,
                                (hi + 1) * step_s))

    # crashes / partition cuts -> wall-clock windows
    crashed = np.asarray(sched["crashed"])
    for i in range(crashed.shape[1]):
        ts = np.nonzero(crashed[:, i])[0].tolist()
        stats["crashes"] += len(ts)
        for lo, hi in _runs(ts):
            dirs.append(CrashWin(ids[i], lo * step_s, (hi + 1) * step_s))
    conn = np.asarray(sched["conn"])
    for i in range(conn.shape[1]):
        for j in range(conn.shape[2]):
            if i == j:
                continue
            ts = np.nonzero(~conn[:, i, j])[0].tolist()
            stats["cuts"] += len(ts)
            for lo, hi in _runs(ts):
                dirs.append(DropWin(ids[i], ids[j], lo * step_s,
                                    (hi + 1) * step_s))
    return dirs, stats


def seq_schedule(trace: Trace, ids: Sequence,
                 msg_map: Optional[Dict[str, str]] = None
                 ) -> Tuple[SeqSchedule, Dict[str, int]]:
    """Project ``trace`` onto the sequenced fault surface.  ``ids`` are
    the host replica ids; sim replica r is the r-th in (zone, node)
    order.  The i-th recorded fault event on an (edge, class) aims at
    the i-th matching host send; delays keep their exact logical
    magnitude.  Returns (schedule, stats)."""
    ids = [str(i) for i in sorted(ids, key=id_order)]
    if msg_map is None:
        msg_map = trace_msg_map(trace.protocol)
    sched = trace.sched
    stats = {"drops": 0, "delays": 0, "unmapped": 0, "dups_skipped": 0,
             "crashes": 0, "cuts": 0}
    unmapped: Dict[str, int] = {}

    # per (edge, class): fault events ordered by recorded step share one
    # occurrence counter
    per_edge: Dict[Tuple[str, int, int], List[Tuple[int, str, int]]] = {}
    for name in sorted(sched["faults"]):
        f = sched["faults"][name]
        drop = np.asarray(f["drop"])
        delay = np.asarray(f["delay"])
        stats["dups_skipped"] += int(np.sum(np.asarray(f["dup"])))
        if name not in msg_map:
            n_ev = int(np.sum(drop)) + int(np.sum(delay > 1))
            if n_ev:
                unmapped[name] = unmapped.get(name, 0) + n_ev
                stats["unmapped"] += n_ev
            continue
        for t, i, j in np.argwhere(drop):
            per_edge.setdefault((msg_map[name], int(i), int(j)),
                                []).append((int(t), "drop", 0))
            stats["drops"] += 1
        for t, i, j in np.argwhere(delay > 1):
            per_edge.setdefault((msg_map[name], int(i), int(j)),
                                []).append(
                                    (int(t), "delay",
                                     int(delay[t, i, j]) - 1))
            stats["delays"] += 1
    faults: List[SeqFault] = []
    for (mt, i, j), evs in sorted(per_edge.items()):
        for occ, (t, action, extra) in enumerate(sorted(evs)):
            faults.append(SeqFault(ids[i], ids[j], mt, occurrence=occ,
                                   action=action, delay_steps=extra,
                                   step=t))

    crash_map: Dict[str, List[int]] = {}
    for t, i in np.argwhere(np.asarray(sched["crashed"])):
        crash_map.setdefault(ids[int(i)], []).append(int(t))
        stats["crashes"] += 1
    cut_map: Dict[Tuple[str, str], List[int]] = {}
    for t, i, j in np.argwhere(~np.asarray(sched["conn"])):
        if i == j:
            continue
        cut_map.setdefault((ids[int(i)], ids[int(j)]), []).append(int(t))
        stats["cuts"] += 1
    out = SeqSchedule(n_steps=trace.n_steps, faults=faults,
                      crashed={k: sorted(v) for k, v in crash_map.items()},
                      cut={k: sorted(v) for k, v in cut_map.items()},
                      unmapped=unmapped,
                      dups_skipped=stats["dups_skipped"])
    return out, stats


# ---- application --------------------------------------------------------
def _socket_of(cluster, id_str: str):
    return cluster[id_str].socket


def apply_immediate(cluster, dirs: Sequence[Directive]) -> None:
    """Install the occurrence-indexed (timeless) directives now."""
    for d in dirs:
        if isinstance(d, DropMsg):
            _socket_of(cluster, d.src).drop_next(
                d.dst, d.msg_type, count=d.count, skip=d.skip, key=d.key)
        elif isinstance(d, DelayMsg):
            _socket_of(cluster, d.src).delay_next(
                d.dst, d.msg_type, d.delay_s, count=d.count,
                skip=d.skip, key=d.key)


async def _drive_windows(dirs: Sequence[Directive], apply) -> None:
    """Open each windowed directive at its ``t0`` (relative to now) by
    awaiting ``apply(directive, duration)``.  Returns once every window
    has been opened (not when it expires)."""
    timed = sorted((d for d in dirs
                    if not isinstance(d, (DropMsg, DelayMsg))),
                   key=lambda d: d.t0)
    t_start = asyncio.get_running_loop().time()
    for d in timed:
        lag = d.t0 - (asyncio.get_running_loop().time() - t_start)
        if lag > 0:
            await asyncio.sleep(lag)
        await apply(d, max(d.t1 - d.t0, 0.0))


async def drive_admin(admin, dirs: Sequence[Directive]) -> None:
    """Run the windowed directives of a schedule through a live
    cluster's ``AdminClient`` HTTP surface (the soak harness path)."""
    async def apply(d, dur):
        if isinstance(d, CrashWin):
            await admin.crash(d.id, dur)
        elif isinstance(d, DropWin):
            await admin.drop(d.src, d.dst, dur)
        elif isinstance(d, SlowWin):
            await admin.slow(d.src, d.dst, d.delay_s * 1000.0, dur)
        elif isinstance(d, FlakyWin):
            await admin.flaky(d.src, d.dst, d.p, dur)

    await _drive_windows(dirs, apply)
