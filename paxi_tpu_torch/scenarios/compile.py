"""Scenarios onto the sim's fuzz surface and the host fabric's, and the
named-scenario catalog (the port's copy of the JAX package's
``scenarios/compile.py``).

A scenario rides INSIDE the FuzzConfig (``with_scenario``): the exchange
layer folds its zone-latency plane into the delay draw and its kill
overlay into the crash plane (``scenarios/schedule.py``), so every
scenario run goes through the runner's record/replay path: recordable,
replayable bit for bit, shrinkable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from paxi_tpu_torch.scenarios import schedule as _sched
from paxi_tpu_torch.scenarios.spec import (LeaderChurn, Reconfig, Scenario,
                                           SwitchChurn, ZoneLatency,
                                           ZoneOutage)
from paxi_tpu_torch.sim.types import FuzzConfig


def with_scenario(fuzz: FuzzConfig, scn: Scenario) -> FuzzConfig:
    """The FuzzConfig that runs ``fuzz``'s randomized faults inside
    ``scn``'s environment."""
    return dataclasses.replace(fuzz, scenario=scn)


def apply_switch(cfg, scn: Scenario):
    """Fold a scenario's SwitchChurn into a SimConfig's static
    ``sw_down_*`` knobs (the sim half of the switchnet event
    compilation: the kernel evaluates the churn schedule from its
    static config on the traced step index, so a trace's ``sim_cfg``
    meta pins the churn schedule exactly like the geometry).  No-op
    for scenarios without switch events."""
    if scn.switch is None:
        return cfg
    sw = scn.switch
    return cfg.with_(sw_down_start=sw.start, sw_down_period=sw.period,
                     sw_down_for=sw.down_for)


def seq_schedule_of(scn: Scenario, ids: Sequence, n_steps: int):
    """Compile ``scn`` into the virtual-clock fabric's fault surface.
    ``ids`` is the host config's replica-ID list; sim replica r maps to
    ``sorted(ids)`` position r (the zone-block layout both runtimes
    derive from the id list, same as trace/host.py projections)."""
    from paxi_tpu_torch.trace.host import SeqSchedule, id_order

    ids = [str(i) for i in sorted(ids, key=id_order)]
    n = len(ids)
    scn.validate(n)
    edge_delay: Dict = {}
    if scn.zones is not None:
        base = _sched.delay_base(scn, n)
        for i in range(n):
            for j in range(n):
                if i != j and int(base[i, j]) > 1:
                    edge_delay[(ids[i], ids[j])] = int(base[i, j]) - 1
    crashed: Dict[str, list] = {}
    if scn.kills_nodes():
        plane = _sched.crashed_plane(scn, n, n_steps)
        for r in range(n):
            ts = [t for t in range(n_steps) if plane[t, r]]
            if ts:
                crashed[ids[r]] = ts
    return SeqSchedule(n_steps=n_steps, crashed=crashed,
                       edge_delay=edge_delay)


# ---- named scenarios -----------------------------------------------------
# The built-in catalog (CLI `scenario list|run -scenario NAME`, hunt
# case rows, bench_all's scenario axis).  Latencies are lock-step
# rounds; the matrices model the Cloud paper's WAN shape: cheap
# intra-zone, expensive asymmetric cross-zone.
WAN3Z = Scenario(
    name="wan3z", n_zones=3,
    zones=ZoneLatency(matrix=((1, 3, 5),
                              (3, 1, 3),
                              (5, 3, 1)), jitter=1))

WAN2Z = Scenario(
    name="wan2z", n_zones=2,
    zones=ZoneLatency(matrix=((1, 4),
                              (4, 1)), jitter=1))

CHURN = Scenario(
    name="churn",
    churn=LeaderChurn(start=6, period=30, kill_for=16))

WAN3Z_CHURN = Scenario(
    name="wan3z_churn", n_zones=3,
    zones=ZoneLatency(matrix=((1, 3, 5),
                              (3, 1, 3),
                              (5, 3, 1)), jitter=1),
    churn=LeaderChurn(start=20, period=50, kill_for=24))

ZONE_FLAP = Scenario(
    name="zoneflap", n_zones=3,
    zones=ZoneLatency(matrix=((1, 2, 3),
                              (2, 1, 2),
                              (3, 2, 1))),
    outages=(ZoneOutage(zone=1, t0=30, t1=60),
             ZoneOutage(zone=2, t0=80, t1=110)))

# membership shrink/grow for a 5-replica group: 5 -> 3 -> 5 (epoch
# bumps mid-run expressed at the transport level)
SHRINK_GROW5 = Scenario(
    name="shrink_grow5",
    reconfig=Reconfig(epochs=((0, (0, 1, 2, 3, 4)),
                              (40, (0, 1, 2)),
                              (90, (0, 1, 2, 3, 4)))))

# switchnet sequencer churn: periodic failover windows (stamping and
# in-network votes pause, session bumps at each window end) — the
# in-fabric tier's ordered-multicast stress axis; and a single
# switch failover mid-epoch under the wan3z matrix (the combined
# "does the fall-back path carry across the handover" case)
SEQ_CHURN = Scenario(
    name="seqchurn",
    switch=SwitchChurn(start=20, period=40, down_for=12))

WAN3Z_SWITCH = Scenario(
    name="wan3z_switch", n_zones=3,
    zones=ZoneLatency(matrix=((1, 3, 5),
                              (3, 1, 3),
                              (5, 3, 1)), jitter=1),
    switch=SwitchChurn(start=40, period=0, down_for=20))

NAMED: Dict[str, Scenario] = {s.name: s for s in (
    WAN3Z, WAN2Z, CHURN, WAN3Z_CHURN, ZONE_FLAP, SHRINK_GROW5,
    SEQ_CHURN, WAN3Z_SWITCH)}


def named_scenario(name: str) -> Scenario:
    if name not in NAMED:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(NAMED)}")
    return NAMED[name]


def latency_split(metrics) -> Dict:
    """Fold the zone-aware kernels' ``commit_lat_{local,cross}_{sum,n}``
    accounting counters into mean lock-step rounds — the Cloud paper's
    zone-local vs cross-zone commit-latency split, shared by the
    ``scenario run`` CLI and bench_all's scenario rows (one definition
    of the metric key names)."""
    out: Dict = {}
    for side in ("local", "cross"):
        n = int(metrics.get(f"commit_lat_{side}_n", 0))
        if n:
            out[f"commit_lat_{side}_rounds"] = round(
                int(metrics[f"commit_lat_{side}_sum"]) / n, 2)
            out[f"commit_lat_{side}_n"] = n
    return out


def describe(scn: Scenario) -> Dict:
    """One-line-able summary for `scenario list`."""
    out: Dict = {"name": scn.name, "n_zones": scn.n_zones,
                 "max_latency": scn.max_latency()}
    if scn.zones is not None:
        out["zones"] = {"matrix": [list(r) for r in scn.zones.matrix],
                        "jitter": scn.zones.jitter}
    if scn.churn is not None:
        out["churn"] = dataclasses.asdict(scn.churn)
    if scn.reconfig is not None:
        out["reconfig"] = {"epochs": [[t, list(l)] for t, l
                                      in scn.reconfig.epochs]}
    if scn.outages:
        out["outages"] = [dataclasses.asdict(o) for o in scn.outages]
    if scn.switch is not None:
        out["switch"] = dataclasses.asdict(scn.switch)
    return out
