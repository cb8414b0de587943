"""The adversarial case matrix (the port's copy of the JAX package's
``hunt/cases.py``, built on the port's configs and scenario catalog).

The fuzz soak (``paxi_tpu_torch.fuzz_soak``) and the divergence-hunt
campaign engine (``hunt/engine.py``) fuzz the same (protocol, geometry,
schedule) space, and the JAX package's tables hold the same rows, so a
witness either runtime trips over is a case the other reproduces.

Schedules: sustained loss with delay/reorder; duplication with deeper
delay; flapping partitions with crash windows; a permanent leader-kill
for the protocols with in-kernel recovery; plus the scenario engine's WAN
geo-latency schedules for the zone-aware protocols.  The host-only shard
fault grids of the reference stay there: the shard tier is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from paxi_tpu_torch.scenarios import compile as scn
from paxi_tpu_torch.sim.types import FuzzConfig, SimConfig

DROP = FuzzConfig(p_drop=0.25, max_delay=2)
DUP = FuzzConfig(p_dup=0.25, max_delay=3)
PART = FuzzConfig(p_partition=0.3, p_crash=0.15, max_delay=2, window=8)
KILL = FuzzConfig(p_drop=0.1, max_delay=2, perm_crash=0, perm_crash_at=25)
# WAN geo-replication schedules: asymmetric zone-latency matrices with
# light loss, and a churn rotation for the takeover paths
GEO3Z = FuzzConfig(p_drop=0.05, scenario=scn.WAN3Z)
GEO2Z = FuzzConfig(p_drop=0.05, scenario=scn.WAN2Z)
GEO_CHURN = FuzzConfig(scenario=scn.WAN3Z_CHURN)

SEEDS = (0, 1, 2, 3, 4)

# (protocol, cfg, schedules, groups, steps, progress metric)
Case = Tuple[str, SimConfig, list, int, int, str]

CASES: List[Case] = [
    ("paxos", SimConfig(n_replicas=5, n_slots=32),
     [DROP, DUP, PART, KILL], 64, 150, "committed_slots"),
    ("paxos_pg", SimConfig(n_replicas=5, n_slots=32),
     [DROP, PART], 64, 150, "committed_slots"),
    ("epaxos", SimConfig(n_replicas=5, n_slots=16, n_keys=4),
     [DROP, DUP, PART, KILL], 16, 120, "executed"),
    ("wpaxos", SimConfig(n_replicas=6, n_zones=2, n_objects=4,
                         n_slots=16, steal_threshold=3, locality=0.8),
     [DROP, PART, KILL], 32, 140, "committed_slots"),
    ("abd", SimConfig(n_replicas=5, n_keys=16),
     [DROP, DUP, PART], 64, 150, "ops_done"),
    ("chain", SimConfig(n_replicas=3, n_slots=32),
     [DROP, DUP, PART], 64, 150, "committed_slots"),
    ("kpaxos", SimConfig(n_replicas=3, n_slots=32),
     [DROP, DUP, PART], 64, 150, "committed_slots"),
    ("dynamo", SimConfig(n_replicas=5, n_keys=8, n_slots=40),
     [DROP, DUP, PART], 64, 120, "writes"),
    ("sdpaxos", SimConfig(n_replicas=5, n_slots=16, n_keys=8),
     [DROP, DUP, PART, KILL], 32, 140, "committed_slots"),
    ("wankeeper", SimConfig(n_replicas=6, n_zones=2, n_objects=4,
                            n_slots=16, locality=0.8),
     [DROP, PART, KILL], 32, 140, "committed_slots"),
    # 3x3 zone grids under partitions: the single-quorum geometry and
    # the reshaped q2=2 grid must both stay violation-free
    ("wpaxos", SimConfig(n_replicas=9, n_zones=3, n_objects=6,
                         n_slots=16, steal_threshold=3, locality=0.8),
     [PART], 16, 140, "committed_slots"),
    ("wpaxos", SimConfig(n_replicas=9, n_zones=3, n_objects=6,
                         n_slots=16, steal_threshold=3, locality=0.8,
                         grid_q2=2),
     [PART], 16, 140, "committed_slots"),
    ("wankeeper", SimConfig(n_replicas=9, n_zones=3, n_objects=6,
                            n_slots=16, locality=0.8),
     [PART], 16, 140, "committed_slots"),
    # WAN geo-replication scenarios over the zone-aware protocols, a
    # latency + churn combination for the takeover paths, and bpaxos on
    # the uneven 2-zone split
    ("wpaxos", SimConfig(n_replicas=9, n_zones=3, n_objects=6,
                         n_slots=16, steal_threshold=3, locality=0.8),
     [GEO3Z, GEO_CHURN], 16, 140, "committed_slots"),
    ("wankeeper", SimConfig(n_replicas=9, n_zones=3, n_objects=6,
                            n_slots=16, locality=0.8),
     [GEO3Z, GEO_CHURN], 16, 140, "committed_slots"),
    ("bpaxos", SimConfig(n_replicas=7, n_slots=16),
     [GEO2Z], 16, 140, "committed_slots"),
    ("blockchain", SimConfig(n_replicas=5, n_slots=32,
                             steal_threshold=4),
     [DROP, DUP, PART], 64, 200, "committed_slots"),
    # compartmentalized tier: KILL (node 0 = proxy 0) forces takeover
    # recovery through the grid's column read
    ("bpaxos", SimConfig(n_replicas=7, n_slots=16),
     [DROP, DUP, PART, KILL], 32, 140, "committed_slots"),
    # the in-fabric consensus tier: drops force the gap-agreement slow
    # path, KILL the register-read recovery; the seqchurn schedule rides
    # inside the SimConfig (apply_switch)
    ("switchpaxos", SimConfig(n_replicas=5, n_slots=32),
     [DROP, PART, KILL], 32, 140, "committed_slots"),
    ("switchpaxos",
     scn.apply_switch(SimConfig(n_replicas=5, n_slots=32),
                      scn.SEQ_CHURN),
     [DROP], 32, 140, "committed_slots"),
]

# the seeded-bug demo case (fuzz_soak --seed-bug): expected to violate;
# it exercises the capture -> dump pipeline, never the oracle
BUG_DEMO: Case = ("wankeeper_nofloor",
                  SimConfig(n_replicas=6, n_zones=2, n_objects=2,
                            n_slots=16, locality=0.1),
                  [DROP], 16, 80, "committed_slots")

# hunt-only cases for the seeded-bug twins and demo kernels: their
# witnesses are the pipeline's positive controls, never correctness cases
DEMO_CASES: List[Case] = [
    ("fragile_counter", SimConfig(n_replicas=3), [DROP], 8, 30,
     "delivered"),
    BUG_DEMO,
    ("bpaxos_noread", SimConfig(n_replicas=7, n_slots=16),
     [DROP], 16, 80, "committed_slots"),
    ("relay_churn", SimConfig(n_replicas=3),
     [FuzzConfig(scenario=scn.CHURN),
      FuzzConfig(scenario=scn.WAN3Z_CHURN)], 8, 60, "delivered"),
    ("wpaxos_thinq1", SimConfig(n_replicas=9, n_zones=3, n_objects=4,
                                n_slots=16, steal_threshold=2,
                                locality=0.3),
     [GEO3Z], 16, 100, "committed_slots"),
    ("switchpaxos_nogap", SimConfig(n_replicas=5, n_slots=32),
     [DROP], 16, 80, "committed_slots"),
]


def sched_name(fuzz: FuzzConfig) -> str:
    """The schedule's structural name, a pure function of the config's
    contents: the dominant fault class names it and a scenario's name
    prefixes it (``drop``, ``dup``, ``partition``, ``perm_kill``,
    ``wan3z+drop``, ...)."""
    parts = []
    if fuzz.scenario is not None:
        parts.append(fuzz.scenario.name)
    if fuzz.perm_crash >= 0:
        parts.append("perm_kill")
    elif fuzz.p_partition > 0 or fuzz.p_crash > 0:
        parts.append("partition")
    elif fuzz.p_dup > 0:
        parts.append("dup")
    elif fuzz.p_drop > 0:
        parts.append("drop")
    return "+".join(parts) or ("delay" if fuzz.max_delay > 1 else "sched")


def hunt_cases(protocols=None, quick: bool = False
               ) -> Dict[str, List[Case]]:
    """The campaign's per-protocol case lists.  ``quick`` caps groups and
    steps for smoke budgets (the capture reruns the same (groups, steps),
    so a scaled case is still exactly reproducible)."""
    out: Dict[str, List[Case]] = {}
    for case in CASES + DEMO_CASES:
        name, cfg, scheds, groups, steps, pkey = case
        if protocols is not None and name not in protocols:
            continue
        if name in (c[0] for c in DEMO_CASES) and protocols is None:
            continue   # demo kernels only hunt when asked for by name
        if quick:
            groups, steps = min(groups, 16), min(steps, 80)
        out.setdefault(name, []).append(
            (name, cfg, scheds, groups, steps, pkey))
    return out
