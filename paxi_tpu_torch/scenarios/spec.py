"""The declarative scenario vocabulary: WAN topology, churn and
reconfiguration as data (the port's own copy of the JAX package's
``scenarios/spec.py``: the same fields, defaults, ``validate`` errors and
``from_dict``, so ``dataclasses.asdict`` of a scenario, which trace meta
stores, reads the same in both packages).

- **zones**: a per-(src_zone, dst_zone) latency matrix in lock-step
  rounds (1 = the fault-free next-step minimum); ``jitter`` adds a
  uniform 0..jitter random extra per message.
- **churn**: a timed kill/revive schedule rotating over the leader
  succession order (``(first + k*stride) % R`` for the k-th kill).
- **reconfig**: membership epochs; nodes outside an epoch's live set are
  comms-dead.
- **outages**: whole-zone blackout windows.
- **switch**: sequencer churn for the in-fabric consensus tier (only its
  schedule arithmetic is carried here).

Everything is a frozen dataclass of ints/tuples: hashable (a scenario
rides inside ``FuzzConfig``) and serializable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ZoneLatency:
    """Per-(src_zone, dst_zone) delivery latency in lock-step rounds."""

    matrix: Tuple[Tuple[int, ...], ...]
    jitter: int = 0      # uniform extra 0..jitter rounds per message


@dataclass(frozen=True)
class LeaderChurn:
    """Timed kills/revivals rotating over the leader succession order:
    kill k targets replica ``(first + k*stride) % R`` during steps
    ``[start + k*period, start + k*period + kill_for)``."""

    start: int = 10
    period: int = 40     # steps between consecutive kills
    kill_for: int = 20   # steps each victim stays comms-dead
    first: int = 0       # initial victim (the initial leader)
    stride: int = 1      # succession stride


@dataclass(frozen=True)
class ZoneOutage:
    """Zone ``zone`` is comms-dead during steps [t0, t1)."""

    zone: int
    t0: int
    t1: int


@dataclass(frozen=True)
class SwitchChurn:
    """Sequencer churn / switch failover for the in-fabric consensus
    tier (paxi_tpu/switchnet): the switch's sequencer is down during
    steps ``[start + k*period, start + k*period + down_for)`` and each
    window END bumps the ordered-multicast session epoch (the failover
    completing on the standby).  ``period=0`` is a single mid-epoch
    failover window.  Acceptor register state PERSISTS across failovers
    (the controller migrates the bounded register file); only voting
    and sequence stamping pause, so the protocol rides its replica
    fall-back path through the window."""

    start: int = 10
    period: int = 0      # steps between window starts (0: one window)
    down_for: int = 8    # steps each window lasts


@dataclass(frozen=True)
class Reconfig:
    """Membership epochs: ``epochs[k] = (step, live_replica_ids)`` —
    from ``step`` until the next epoch's step, replicas outside the
    live set are comms-dead.  Steps must be strictly increasing."""

    epochs: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()


@dataclass(frozen=True)
class Scenario:
    """A WAN topology / churn / reconfiguration scenario (module
    docstring).  ``n_zones`` is the zone-grid width used by ``zones``
    and ``outages`` (replica r lives in zone ``r // (R // n_zones)``
    when R divides evenly, ``r * n_zones // R`` otherwise)."""

    name: str = "scenario"
    n_zones: int = 1
    zones: Optional[ZoneLatency] = None
    churn: Optional[LeaderChurn] = None
    reconfig: Optional[Reconfig] = None
    outages: Tuple[ZoneOutage, ...] = field(default_factory=tuple)
    # in-fabric consensus tier events (only meaningful for protocols
    # speaking through paxi_tpu/switchnet; others ignore it)
    switch: Optional[SwitchChurn] = None

    # ---- static shape the sim needs ------------------------------------
    def max_latency(self) -> int:
        """Deepest delivery latency the delay wheel must hold."""
        if self.zones is None:
            return 1
        return max(max(row) for row in self.zones.matrix) \
            + max(self.zones.jitter, 0)

    def kills_nodes(self) -> bool:
        """Does this scenario ever force a comms-dead node?"""
        return (self.churn is not None or len(self.outages) > 0
                or (self.reconfig is not None
                    and len(self.reconfig.epochs) > 0))

    # ---- validation -----------------------------------------------------
    def validate(self, n_replicas: int) -> "Scenario":
        """Raise ValueError on an inconsistent spec; returns self so
        call sites can chain."""
        Z = self.n_zones
        if Z < 1:
            raise ValueError(f"scenario {self.name!r}: n_zones must be "
                             f">= 1, got {Z}")
        if Z > n_replicas:
            raise ValueError(f"scenario {self.name!r}: n_zones={Z} > "
                             f"n_replicas={n_replicas}")
        if self.zones is not None:
            m = self.zones.matrix
            if len(m) != Z or any(len(row) != Z for row in m):
                raise ValueError(
                    f"scenario {self.name!r}: latency matrix must be "
                    f"{Z}x{Z}, got {[len(r) for r in m]}")
            if any(e < 1 for row in m for e in row):
                raise ValueError(f"scenario {self.name!r}: latency "
                                 "entries are rounds >= 1")
            if self.zones.jitter < 0:
                raise ValueError(f"scenario {self.name!r}: jitter < 0")
        if self.churn is not None:
            c = self.churn
            if c.period < 1 or c.kill_for < 1 or c.start < 0:
                raise ValueError(f"scenario {self.name!r}: churn needs "
                                 "period/kill_for >= 1 and start >= 0")
            if c.kill_for > c.period:
                # the overlay holds ONE victim at a time (phase-within-
                # period arithmetic): a kill window longer than the
                # period would silently truncate, not overlap
                raise ValueError(f"scenario {self.name!r}: churn "
                                 f"kill_for={c.kill_for} must be <= "
                                 f"period={c.period}")
        if self.reconfig is not None and self.reconfig.epochs:
            steps = [t for t, _ in self.reconfig.epochs]
            if steps != sorted(set(steps)):
                raise ValueError(f"scenario {self.name!r}: reconfig "
                                 "epoch steps must be strictly increasing")
            for t, live in self.reconfig.epochs:
                if any(r < 0 or r >= n_replicas for r in live):
                    raise ValueError(
                        f"scenario {self.name!r}: epoch @{t} names a "
                        f"replica outside 0..{n_replicas - 1}")
        if self.switch is not None:
            sw = self.switch
            if sw.start < 0 or sw.down_for < 1 or sw.period < 0:
                raise ValueError(f"scenario {self.name!r}: switch churn "
                                 "needs start >= 0, down_for >= 1 and "
                                 "period >= 0")
            if sw.period and sw.down_for > sw.period:
                raise ValueError(f"scenario {self.name!r}: switch "
                                 f"down_for={sw.down_for} must be <= "
                                 f"period={sw.period}")
        for o in self.outages:
            if o.zone < 0 or o.zone >= Z:
                raise ValueError(f"scenario {self.name!r}: outage zone "
                                 f"{o.zone} outside 0..{Z - 1}")
            if o.t1 < o.t0:
                raise ValueError(f"scenario {self.name!r}: outage window "
                                 f"[{o.t0}, {o.t1}) is empty-backwards")
        return self

    # ---- (de)serialization ----------------------------------------------
    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Scenario":
        """Rebuild from ``dataclasses.asdict`` output after a JSON
        round-trip (lists back to tuples) — the trace-meta path."""
        z = d.get("zones")
        zones = (ZoneLatency(
            matrix=tuple(tuple(int(e) for e in row)
                         for row in z["matrix"]),
            jitter=int(z.get("jitter", 0))) if z else None)
        c = d.get("churn")
        churn = LeaderChurn(**{k: int(v) for k, v in c.items()}) \
            if c else None
        rc = d.get("reconfig")
        reconfig = (Reconfig(epochs=tuple(
            (int(t), tuple(int(r) for r in live))
            for t, live in rc["epochs"])) if rc else None)
        outages = tuple(ZoneOutage(**{k: int(v) for k, v in o.items()})
                        for o in d.get("outages", ()))
        sw = d.get("switch")
        switch = SwitchChurn(**{k: int(v) for k, v in sw.items()}) \
            if sw else None
        return Scenario(name=str(d.get("name", "scenario")),
                        n_zones=int(d.get("n_zones", 1)),
                        zones=zones, churn=churn, reconfig=reconfig,
                        outages=outages, switch=switch)


def zone_of(n_replicas: int, n_zones: int):
    """Replica -> zone mapping (python list, static).  Zone-block
    layout matching the kernels' ``r // (R/Z)`` when R divides evenly;
    balanced blocks (``r * Z // R``) otherwise — uneven splits only
    arise for scenarios on zone-free kernels (e.g. a WAN matrix over
    bpaxos roles), where no quorum geometry depends on the mapping."""
    if n_zones <= 1:
        return [0] * n_replicas
    if n_replicas % n_zones == 0:
        per = n_replicas // n_zones
        return [r // per for r in range(n_replicas)]
    return [(r * n_zones) // n_replicas for r in range(n_replicas)]
