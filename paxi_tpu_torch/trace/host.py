"""Project a sim trace onto the host runtime's sequenced fault surface
(the port's copy of the projection half of the JAX package's
``trace/host.py``).

The sim's drop/dup/delay/partition/crash schedule generalizes the host
sockets' faults, so a captured schedule projects back: per-message-type
drops and delays become occurrence-indexed ``SeqFault``s on the host
message classes the protocol's ``TRACE_MSG_MAP`` names, crashes and
partition cuts per-logical-step sets, and dups (TCP never duplicates)
are counted and left out.  The hunt's classifier reads the projection's
coverage (``hunt/classify.coverage_of``).  The host runtime that replays
the schedule, and the windowed directive projection, stay in the JAX
package: the port keeps only the data the projection needs, the
host-twin registry, every host module's ``TRACE_MSG_MAP`` and the local
config's replica ids.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paxi_tpu_torch.trace.format import Trace

# the host runtime's protocol registry (its keys) and each host module's
# TRACE_MSG_MAP: sim mailbox name -> host message class
TRACE_MSG_MAPS: Dict[str, Dict[str, str]] = {
    "fragile_counter": {"seq": "Seq"},
    "paxos": {"p1a": "P1a", "p1b": "P1b", "p2a": "P2a", "p2b": "P2b",
              "p3": "P3"},
    "abd": {"query": "Query", "query_r": "QueryReply", "store": "Store",
            "store_r": "StoreReply"},
    "chain": {"ack": "Ack", "prop": "Propagate", "rep": "Propagate"},
    "wpaxos": {"p1a": "WP1a", "p1b": "WP1b", "p2a": "WP2a", "p2b": "WP2b",
               "p3": "WP3"},
    "epaxos": {"acc": "Accept", "accr": "AcceptReply", "cmt": "Commit",
               "pa": "PreAccept", "par": "PreAcceptReply",
               "prep": "Prepare", "prepr": "PrepareReply",
               "racc": "Accept", "raccr": "AcceptReply",
               "rcmt": "Commit"},
    "kpaxos": {"p2a": "KP2a", "p2b": "KP2b", "p3": "KP3"},
    "dynamo": {"gossip": "RWrite"},
    "sdpaxos": {"ca": "CAccept", "cack": "CAck", "cneed": "CFetch",
                "cr": "CAccept", "oreq": "OReq", "p1a": "Seq1a",
                "p1b": "Seq1b", "p2a": "OAccept", "p2b": "OAck",
                "p3": "OCommit"},
    "wankeeper": {"p1a": "Root1a", "p1b": "Root1b", "p2a": "Grant",
                  "p3": "Grant", "rel": "Rel", "treq": "TReq",
                  "zack": "ZAck", "zrep": "ZWrite"},
    "blockchain": {"head": "BlockMsg"},
    "bpaxos": {"p1a": "BP1a", "p1b": "BP1b", "p2a": "BP2a", "p2b": "BP2b",
               "p3": "BP3"},
    "bpaxos_noread": {"p1a": "BP1a", "p1b": "BP1b", "p2a": "BP2a",
                      "p2b": "BP2b", "p3": "BP3"},
    "switchpaxos": {"gapreq": "GapReq", "p1a": "SwP1a", "p1b": "SwP1b",
                    "p2a": "OmP2a", "p2b": "SwP2b", "p3": "OmP3"},
    "switchpaxos_nogap": {"gapreq": "GapReq", "p1a": "SwP1a",
                          "p1b": "SwP1b", "p2a": "OmP2a", "p2b": "SwP2b",
                          "p3": "OmP3"},
    "relay_churn": {"seq": "Seq"},
}


@dataclass
class SeqFault:
    """One occurrence-indexed fault: act on the ``occurrence``-th
    (0-based) host send of class ``msg_type`` on src->dst.
    ``delay_steps`` is an exact number of extra logical steps; ``step``
    is provenance (the recorded sim step)."""

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
    occurrence-indexed per-message faults plus per-logical-step crash and
    partition-cut sets.  ``edge_delay`` is a standing per-edge latency
    (extra logical steps a send), which trace projections leave empty.
    ``unmapped`` counts fault events on mailboxes without a
    ``TRACE_MSG_MAP`` entry, ``dups_skipped`` the duplications; neither
    replays exactly."""

    n_steps: int
    faults: List[SeqFault] = dataclasses.field(default_factory=list)
    crashed: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    cut: Dict[Tuple[str, str], List[int]] = dataclasses.field(
        default_factory=dict)
    edge_delay: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)
    unmapped: Dict[str, int] = dataclasses.field(default_factory=dict)
    dups_skipped: int = 0

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
    bare node number is zone 1): lexical order would put ``"1.10"``
    before ``"1.2"``."""
    s = str(i)
    zone, node = s.split(".", 1) if "." in s else ("1", s)
    return int(zone), int(node)


def local_ids(n_replicas: int, n_zones: int = 1) -> List[str]:
    """The replica ids of the host runtime's n-replica local config
    (``n_zones`` zones of ``n_replicas // n_zones`` nodes, ``"z.n"``,
    both 1-based), in (zone, node) order."""
    per_zone = n_replicas // n_zones
    return [f"{z}.{n}" for z in range(1, n_zones + 1)
            for n in range(1, per_zone + 1)]


def host_algorithm(protocol: str) -> Optional[str]:
    """The host-registry name a sim protocol replays against, or None for
    sim-only protocols.  A variant registered on its base protocol's sim
    module (``wankeeper_nofloor``, ``paxos_pg``) maps to that base."""
    from paxi_tpu_torch.protocols import _SIM_MODULES
    base = protocol
    if base not in TRACE_MSG_MAPS:
        sim_mod = _SIM_MODULES.get(protocol, "").partition(":")[0]
        parts = sim_mod.rsplit(".", 2)
        base = parts[-2] if len(parts) >= 2 else protocol
    return base if base in TRACE_MSG_MAPS else None


def trace_msg_map(protocol: str) -> Dict[str, str]:
    """The protocol's sim-mailbox-name -> host-message-class map ({} for
    a sim-only protocol)."""
    base = host_algorithm(protocol)
    return {} if base is None else dict(TRACE_MSG_MAPS[base])


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
