"""Witness classification (the port's copy of the JAX package's
``hunt/classify.py``).

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
host outcome.  The host outcome comes from ``replay_witness``: the
witness's schedule projected onto the virtual-clock fabric
(``trace/host.seq_schedule``) and replayed against the protocol's asyncio
host twin (``protocols._HOST_MODULES``) on the CPU, as in the JAX
package, so two replays of one file give the same outcome and the same
span timeline.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from paxi_tpu_torch.trace.format import Trace
from paxi_tpu_torch.trace.host import (host_algorithm, local_ids,
                                       seq_schedule, trace_msg_map)

OUTCOMES = ("reproduced", "diverged", "unmappable")


@dataclass
class HostOutcome:
    """What the host runtime did under the replayed schedule."""

    anomalies: int = 0          # linearizability anomalies (history.py)
    oracle_violations: int = 0  # the protocol's HUNT_ORACLE counter
    ops_ok: int = 0
    ops_failed: int = 0
    steps: int = 0
    fabric_stats: Dict[str, int] = field(default_factory=dict)
    # merged span timeline of the replay (obs/): fabric-clock timestamps
    # and deterministic trace/span ids, so two replays of one witness
    # produce byte-identical timelines
    spans: list = field(default_factory=list)

    @property
    def violated(self) -> bool:
        return self.anomalies > 0 or self.oracle_violations > 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        # the timeline is an artifact, not a verdict: the JSON carries
        # its count
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


# ---- the impure half: virtual-clock host replay -------------------------
# tail_steps: the fault-free logical tail after the replayed schedule.
# 10 steps let in-flight request/reply rounds settle, which is all most
# protocols need; a protocol whose *evidence-driven* repair path must
# converge post-schedule (bpaxos's gap-strike takeover needs several
# commits to strike, recover the hole, and surface the divergence the
# schedule set up) declares a longer tail via ``HUNT_TAIL_STEPS`` so
# every other protocol's replay doesn't pay for it.
async def replay_witness(trace: Trace, *, tail_steps: Optional[int] = None,
                         op_every: int = 2, op_timeout: float = 5.0
                         ) -> HostOutcome:
    """Replay ``trace``'s schedule against the host runtime on the
    virtual-clock fabric and report what the host did.

    Protocol hooks (host module attributes):
    - ``HUNT_DRIVER(cluster, fabric)``: install a protocol-specific
      per-step driver instead of the default KV workload;
    - ``HUNT_ORACLE(cluster) -> int``: a safety-violation counter read
      after the replay (in addition to the history checker);
    - ``HUNT_TAIL_STEPS``: fault-free tail length after the schedule
      (default 10; see the note above).
    """
    algorithm = host_algorithm(trace.protocol)
    if algorithm is None:
        raise ValueError(f"{trace.protocol!r} has no host runtime")
    scfg = trace.sim_config()
    from paxi_tpu_torch.host.simulation import chan_config
    cfg = chan_config(scfg.n_replicas, zones=scfg.n_zones, tag="hunt")
    sched, _ = seq_schedule(trace, cfg.ids,
                            msg_map=trace_msg_map(trace.protocol))
    return await replay_schedule(
        algorithm, scfg, sched, cfg=cfg, seed=trace.seed,
        tail_steps=tail_steps, op_every=op_every, op_timeout=op_timeout)


async def replay_schedule(algorithm: str, scfg, sched, *, cfg=None,
                          seed: int = 0,
                          tail_steps: Optional[int] = None,
                          op_every: int = 2, op_timeout: float = 5.0
                          ) -> HostOutcome:
    """Drive the host runtime under an arbitrary ``SeqSchedule`` on the
    virtual-clock fabric — the schedule-level core of
    ``replay_witness``, also the scenario engine's host runner (CLI
    ``scenario run --host`` compiles a Scenario into a SeqSchedule via
    ``scenarios.compile.seq_schedule_of`` and lands here).  ``cfg`` is
    the cluster config whose ids the schedule was keyed with (built
    from ``scfg``'s geometry when omitted — pass the one you projected
    the schedule with so the two cannot drift)."""
    from paxi_tpu_torch.host.fabric import VirtualClockFabric
    from paxi_tpu_torch.host.history import History
    from paxi_tpu_torch.host.simulation import Cluster, chan_config
    from paxi_tpu_torch.core.command import Command, Request
    from paxi_tpu_torch.obs import TRACE_PROP, SpanCollector, TraceCtx, merge
    from paxi_tpu_torch.protocols import _HOST_MODULES

    if cfg is None:
        cfg = chan_config(scfg.n_replicas, zones=scfg.n_zones,
                          tag="hunt")
    fabric = VirtualClockFabric(sched)
    host_mod = importlib.import_module(_HOST_MODULES[algorithm])
    # fabric-tier hook (the switchnet protocols): interpose whatever
    # in-network tier the protocol speaks through BEFORE the replicas
    # attach, so their constructors see it on the wire
    fab_setup = getattr(host_mod, "HUNT_FABRIC_SETUP", None)
    if fab_setup is not None:
        fab_setup(fabric, scfg)
    cluster = Cluster(algorithm, cfg=cfg, http=False, fabric=fabric)
    await cluster.start()
    if tail_steps is None:
        tail_steps = getattr(host_mod, "HUNT_TAIL_STEPS", 10)
    out = HostOutcome(steps=sched.n_steps)
    history = None
    ops: list = []
    col = None
    try:
        driver = getattr(host_mod, "HUNT_DRIVER", None)
        if driver is not None:
            driver(cluster, fabric)
        else:
            # default closed-ish-loop KV workload: deterministic op
            # stream (trace-seeded), round-robin over replicas, writes
            # of unique values so the history checker's read-from
            # edges are unambiguous
            history = History()
            rng = random.Random(seed)
            ids = sorted(cluster.ids)
            n_keys = max(1, min(scfg.n_keys, 4))
            # harness-side collector: every injected op opens a root
            # span with a DETERMINISTIC trace id (h<op#>) on the
            # fabric clock — no sampler, no pid — so the stitched
            # timeline of a witness replay is itself replayable
            col = SpanCollector(node="client", fabric=fabric)

            async def one_op(replica, key: int, value: bytes, sp):
                fut = asyncio.get_running_loop().create_future()
                start = time.monotonic()
                props = ({TRACE_PROP: sp.child().encode()}
                         if sp is not None else {})
                cluster[replica].handle_client_request(Request(
                    command=Command(key, value, "hunt",
                                    len(ops)), properties=props,
                    reply_to=fut))
                try:
                    rep = await asyncio.wait_for(fut, op_timeout)
                except asyncio.TimeoutError:
                    out.ops_failed += 1
                    return
                finally:
                    col.finish(sp)
                end = time.monotonic()
                if rep.err is not None:
                    out.ops_failed += 1
                    return
                out.ops_ok += 1
                if value:
                    history.add(key, value, None, start, end)
                else:
                    history.add(key, None, rep.value, start, end)

            def issue(t: int) -> None:
                if t % op_every:
                    return
                replica = ids[(t // op_every) % len(ids)]
                key = rng.randrange(n_keys)
                write = rng.random() < 0.6
                value = f"w{t}".encode() if write else b""
                sp = col.start("request", TraceCtx(f"h{len(ops)}"),
                               key=str(key),
                               op="w" if write else "r")
                ops.append(asyncio.ensure_future(
                    one_op(replica, key, value, sp)))

            fabric.on_step(issue)

        await fabric.run(sched.n_steps, drain=True)
        # a fault-free logical tail so in-flight request/reply rounds
        # can finish before the oracle reads the cluster
        fabric.sched = None
        await fabric.run(tail_steps, drain=True)
        if ops:
            await asyncio.wait(ops, timeout=op_timeout)
        for f in ops:
            if not f.done():
                f.cancel()
                out.ops_failed += 1
        if history is not None:
            out.anomalies = history.linearizable()
        oracle = getattr(host_mod, "HUNT_ORACLE", None)
        if oracle is not None:
            out.oracle_violations = int(oracle(cluster))
        out.fabric_stats = dict(fabric.stats)
        span_lists = [r.spans.export()
                      for r in cluster.replicas.values()]
        if col is not None:
            span_lists.append(col.export())
        out.spans = merge(span_lists)
    finally:
        await cluster.stop()
    return out


def classify_witness(trace: Trace, *, host_replay: bool = True,
                     **replay_kw) -> Classification:
    """The engine's one-stop path: coverage -> (maybe) replay ->
    verdict.  Synchronous wrapper (each replay gets a fresh loop)."""
    cov = coverage_of(trace)
    if cov["unmapped_mailboxes"] or cov["dups"] > 0 or not host_replay:
        host = None
        if not (cov["unmapped_mailboxes"] or cov["dups"] > 0):
            # replay disabled by caller: report honestly as a coverage
            # gap rather than guessing a verdict
            return Classification(
                outcome="unmappable",
                reason="host replay disabled (--no-host)",
                sim={"violations":
                     int(trace.meta.get("group_violations", -1))},
                coverage=cov)
    else:
        host = asyncio.run(replay_witness(trace, **replay_kw))
    return classify(trace.meta.get("group_violations", -1), cov, host)
