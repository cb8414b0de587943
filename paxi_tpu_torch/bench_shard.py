"""The shard-count curve: one fixed fleet, G in {1, 2, 4} groups
behind the router, same-day same-box — aggregate cmds/s vs shards
(shard/bench.py has the methodology).  G=1 is the control: the
identical fleet, surface, workers and offered ramp, serving as ONE
consensus group.  The port's twin of the JAX package's root
``bench_shard.py``: the same ``GS``, ``BLIP_GATE``, ``BENCH_SHARD_*``
variables, document and exit code.

    python -m paxi_tpu_torch.bench_shard [--base-port 18300] \\
        [--out build/bench_shard/BENCH_SHARD.json]

Every G >= 2 run also performs a live mid-ramp ``move_range`` of a
non-empty hot range (migrate=True): the migrated-keys readback oracle
must be clean and the in-window completion p99 ("migration blip") must
stay within 3x the steady-state p99.

Writes ``--out`` (never the root ``BENCH_SHARD.json``); exits nonzero if
any run reports linearizability anomalies, a 2PC atomicity violation, a
migration oracle failure, a blip beyond the 3x gate, or the G=4
aggregate fails to clear the same-day G=1 control.  Run G's groups take
the HTTP ports ``base + 40 G_index ..`` and its router ``base + 40
G_index + 98``.  Serving is asyncio Python on the CPU: no figure here is
a device figure.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import platform
import time
from pathlib import Path

from paxi_tpu_torch.shard.bench import shard_ramp

OUT = Path(__file__).resolve().parents[1] / "build" / "bench_shard" \
    / "BENCH_SHARD.json"

GS = (1, 2, 4)
BLIP_GATE = 3.0  # migration blip p99 must stay within 3x steady p99


def _migration_gate(r: dict) -> tuple[dict | None, bool]:
    """(migration block, gate ok) for one shard_ramp result."""
    mig = next((p for p in r["phases"] if p["phase"] == "migrate"),
               None)
    if mig is None:
        return None, True
    m = mig["migration"]
    ok = (m["epoch"] == "complete"
          and (m["installed"] or 0) > 0
          and m["oracle"]["clean"]
          and (mig["anomalies"] or 0) == 0)
    if m["steady_p99_ms"] and m["blip_ratio"] is not None:
        ok = ok and m["blip_ratio"] <= BLIP_GATE
    return m, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paxi_tpu_torch.bench_shard",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--base-port", type=int, default=18300,
                   help="first group HTTP port of the G=1 run; run i "
                        "starts 40 i above, its router 98 above that")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    fleet = int(os.environ.get("BENCH_SHARD_FLEET", "12"))
    workers = int(os.environ.get("BENCH_SHARD_WORKERS", "4"))
    step_s = float(os.environ.get("BENCH_SHARD_STEP_S", "3.0"))
    rates = [float(r) for r in os.environ.get(
        "BENCH_SHARD_RATES", "6000,12000,20000,30000").split(",")]
    curve = []
    worst = 0
    for gi, g in enumerate(GS):
        r = asyncio.run(shard_ramp(
            shards=g, fleet=fleet, workers=workers, rates=rates,
            step_s=step_s, base_port=args.base_port + 40 * gi,
            migrate=g >= 2))
        print(json.dumps({k: v for k, v in r.items()
                          if k != "phases"}), flush=True)
        curve.append(r)
        if (r["anomalies"] or 0) > 0 or (
                r["txn"] and r["txn"]["atomicity_violations"] > 0):
            worst = 1
        m, ok = _migration_gate(r)
        if m is not None:
            print(json.dumps({"shards": g, "migration": {
                "installed": m["installed"],
                "migration_blip_p99_ms": m["migration_blip_p99_ms"],
                "steady_p99_ms": m["steady_p99_ms"],
                "blip_ratio": m["blip_ratio"],
                "oracle_clean": m["oracle"]["clean"],
                "gate_ok": ok}}), flush=True)
        if not ok:
            worst = 1
    control = next(r for r in curve if r["shards"] == 1)
    top = next(r for r in curve if r["shards"] == GS[-1])
    scaled = top["aggregate_peak_ops_s"] > control["aggregate_peak_ops_s"]
    if not scaled:
        worst = 1
    doc = {
        "description":
            "Aggregate cmds/s vs shard count over a FIXED fleet of "
            f"{fleet} replicas partitioned into G consensus groups "
            "behind one shard-router endpoint (python -m "
            "paxi_tpu_torch.bench_shard; paxi_tpu_torch/shard/). Same "
            "day, same box, same workers/ramp for every G; G=1 is the "
            "control. Each run: disjoint-then-crossing worker key "
            "ranges, per-worker linearizability verdicts (anomalies "
            "sum), and a cross-shard 2PC burst with a linearizable-"
            "readback atomicity oracle; G >= 2 runs add a live mid-ramp "
            "move_range of a non-empty hot range gated on a clean "
            "migrated-keys readback oracle and a blip p99 within "
            f"{BLIP_GATE}x steady p99. The leader's O(n-1) replication "
            "fan shrinks with G — the compartmentalization papers' "
            "bottleneck-role scaling, observable end-to-end; every "
            "group and the router share one asyncio interpreter, so "
            "the win is per-command replication work, not parallelism.",
        "date": time.strftime("%Y-%m-%d"),
        "box": {"platform": platform.platform(),
                "cpus": os.cpu_count()},
        "fleet": fleet,
        "workers": workers,
        "offered_rates_ops_s": rates,
        "curve": curve,
        "g4_above_g1_control": scaled,
        "migration_blip_gate_x": BLIP_GATE,
        "migration_gates_ok": all(
            _migration_gate(r)[1] for r in curve),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({
        "aggregate_peak_ops_s":
            {str(r["shards"]): r["aggregate_peak_ops_s"]
             for r in curve},
        "g4_above_g1_control": scaled,
        "anomalies": sum(r["anomalies"] or 0 for r in curve),
        "atomicity_violations": sum(
            (r["txn"] or {}).get("atomicity_violations", 0)
            for r in curve),
        "migration_blip_p99_ms": {
            str(r["shards"]): _migration_gate(r)[0]
            ["migration_blip_p99_ms"]
            for r in curve if _migration_gate(r)[0] is not None},
        "migration_gates_ok": doc["migration_gates_ok"],
    }))
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
