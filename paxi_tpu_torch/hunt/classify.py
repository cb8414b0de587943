"""Witness classification, the pure half (the port's copy of the JAX
package's ``hunt/classify.py`` without the host replay).

The verdict taxonomy (every witness lands in exactly one):

- ``reproduced``: the virtual-clock host replay of the witness violated
  safety too (a host bug candidate);
- ``diverged``: the host replay stayed safe (a sim modeling gap or an
  occurrence-projection miss);
- ``unmappable``: the witness hinges on events the host surface cannot
  express exactly: faults on mailboxes outside the protocol's
  ``TRACE_MSG_MAP``, duplications, or a lone-delay schedule riding the
  one-slot wheel's collision-as-loss.

``coverage_of`` and ``classify`` are pure functions of the trace and a
host outcome.  The host outcome comes from the asyncio host runtime on
the virtual-clock fabric, which lives in the JAX package only: the port
classifies with host replay off (``--no-host``), which reports a
mappable witness honestly as a coverage gap, and refuses to be asked for
a replay.  The JAX package classifies the port's corpus with
``python -m paxi_tpu hunt run --traces-dir <the corpus directory>``
(its ``Corpus.seed_from`` reads any ``*.npz`` trace).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from paxi_tpu_torch.trace.format import Trace
from paxi_tpu_torch.trace.host import local_ids, seq_schedule

OUTCOMES = ("reproduced", "diverged", "unmappable")

HOST_REPLAY_REFUSED = (
    "host replay needs the asyncio host runtime, which paxi_tpu_torch does "
    "not port: classify with host replay off (--no-host), or classify this "
    "corpus in the JAX package with `python -m paxi_tpu hunt run "
    "--traces-dir <corpus dir>`")


@dataclass
class HostOutcome:
    """What the host runtime did under the replayed schedule."""

    anomalies: int = 0          # linearizability anomalies
    oracle_violations: int = 0  # the protocol's HUNT_ORACLE counter
    ops_ok: int = 0
    ops_failed: int = 0
    steps: int = 0
    fabric_stats: Dict[str, int] = field(default_factory=dict)
    spans: list = field(default_factory=list)

    @property
    def violated(self) -> bool:
        return self.anomalies > 0 or self.oracle_violations > 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("spans")
        d["span_count"] = len(self.spans)
        return d


@dataclass
class Classification:
    outcome: str                # one of OUTCOMES
    reason: str
    sim: Dict[str, int]
    coverage: Dict[str, object]
    host: Optional[dict] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def coverage_of(trace: Trace, ids=None,
                msg_map: Optional[Dict[str, str]] = None) -> dict:
    """Projection-coverage summary for ``trace`` under ``msg_map`` (by
    default the trace's own protocol map): the mappability half of the
    classifier.  ``delay_collisions`` is the whole-batch count of the
    run that stamped the trace (shrink's replay, else the capture): zero
    proves the traced group collision-free; None means unrecorded."""
    cfg = trace.sim_config()
    if ids is None:
        ids = local_ids(cfg.n_replicas, cfg.n_zones)
    sched, stats = seq_schedule(trace, ids, msg_map=msg_map)
    counters = trace.meta.get("replay_counters"
                              if trace.meta.get("shrunk")
                              else "capture_counters") or {}
    return {
        "mapped_events": stats["drops"] + stats["delays"],
        "unmapped_events": stats["unmapped"],
        "unmapped_mailboxes": sorted(sched.unmapped),
        "dups": sched.dups_skipped,
        "drops": stats["drops"],
        "delays": stats["delays"],
        "crashes": stats["crashes"],
        "cuts": stats["cuts"],
        "delay_collisions": counters.get("delay_collisions"),
        "exact": sched.exact,
    }


def classify(sim_violations: int, coverage: dict,
             host: Optional[HostOutcome]) -> Classification:
    """The pure verdict (the module docstring's taxonomy)."""
    sim = {"violations": int(sim_violations)}
    if coverage.get("unmapped_mailboxes"):
        return Classification(
            outcome="unmappable",
            reason="fault events on mailboxes outside TRACE_MSG_MAP: "
                   + ", ".join(coverage["unmapped_mailboxes"]),
            sim=sim, coverage=coverage)
    if coverage.get("dups", 0) > 0:
        return Classification(
            outcome="unmappable",
            reason=f"{coverage['dups']} duplication event(s) — "
                   "TCP/chan transports never duplicate",
            sim=sim, coverage=coverage)
    if host is None:
        raise ValueError("mappable witness classified without a host "
                         "outcome — run the virtual-clock replay first")
    if host.violated:
        return Classification(
            outcome="reproduced",
            reason=f"host violated under the replayed schedule "
                   f"(anomalies={host.anomalies}, "
                   f"oracle={host.oracle_violations}) — host bug "
                   "candidate",
            sim=sim, coverage=coverage, host=host.to_json())
    # a clean host replay of a delays-only schedule is
    # diverged-by-construction unless the counter proves no collision
    lone_delay = (coverage.get("delays", 0) > 0
                  and not (coverage.get("drops", 0)
                           or coverage.get("dups", 0)
                           or coverage.get("crashes", 0)
                           or coverage.get("cuts", 0)))
    if lone_delay and coverage.get("delay_collisions") != 0:
        known = coverage.get("delay_collisions")
        detail = (f"{known} collision(s) counted in the replay batch"
                  if known is not None
                  else "collision count unrecorded (pre-counter trace)")
        return Classification(
            outcome="unmappable",
            reason="lone-delay witness: the one-slot delay wheel "
                   f"models colliding delayed messages as losses "
                   f"({detail}) — a loss the host fabric cannot "
                   "express, so a clean host replay is "
                   "diverged-by-construction",
            sim=sim, coverage=coverage, host=host.to_json())
    return Classification(
        outcome="diverged",
        reason="host replay stayed safe "
               f"(ops ok={host.ops_ok}, failed={host.ops_failed}) — "
               "sim modeling gap or occurrence-projection miss",
        sim=sim, coverage=coverage, host=host.to_json())


def classify_witness(trace: Trace, *,
                     host_replay: bool = False) -> Classification:
    """Coverage, then the verdict.  A witness the host surface cannot
    express classifies ``unmappable`` as in the reference; a mappable one
    reports the disabled replay as a coverage gap.  ``host_replay=True``
    on a mappable witness raises ValueError: the host runtime is not
    ported, and no verdict is made up in its place."""
    cov = coverage_of(trace)
    if cov["unmapped_mailboxes"] or cov["dups"] > 0:
        return classify(trace.meta.get("group_violations", -1), cov, None)
    if host_replay:
        raise ValueError(HOST_REPLAY_REFUSED)
    return Classification(
        outcome="unmappable",
        reason="host replay disabled (--no-host)",
        sim={"violations": int(trace.meta.get("group_violations", -1))},
        coverage=cov)
