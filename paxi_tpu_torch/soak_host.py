"""Host-runtime fault soak: AdminClient-driven crash/drop injection
during a linearizability-checked benchmark, automated as one artifact.
The port's twin of the JAX package's root ``soak_host.py``: the same
``CASES``, ``fault_schedule`` and ``SOAK_HOST_T``.

    python -m paxi_tpu_torch.soak_host [--protocols paxos] \\
        [--base-port 1735] [--out build/soak_host/SOAK_HOST.json]

For every linearizable protocol: start an in-process cluster, run the
closed-loop HTTP benchmark, and concurrently inject faults through the
real AdminClient surface (/admin/crash, /admin/drop, /admin/flaky): a
follower crash, a dropped link, a flaky link, and (for the protocols
with leader/sequencer/root recovery) a likely-leader crash.  Asserts
zero linearizability anomalies and forward progress; op errors are
recorded, not asserted (a crashed node's in-flight ops time out and the
client retries elsewhere, socket.go semantics).

Writes ``--out`` (never the root ``SOAK_HOST.json``); exits nonzero on
any anomaly or stalled run.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
from pathlib import Path

from paxi_tpu_torch.core.config import Bconfig, local_config
from paxi_tpu_torch.host.benchmark import Benchmark
from paxi_tpu_torch.host.client import AdminClient
from paxi_tpu_torch.host.simulation import Cluster
from paxi_tpu_torch.metrics import merge_snapshots
from paxi_tpu_torch.trace.host import (CrashWin, DropWin, FlakyWin,
                                       directives_json, drive_admin)

OUT = Path(__file__).resolve().parents[1] / "build" / "soak_host" \
    / "SOAK_HOST.json"

# (protocol, n, zones, crash-likely-leader-too)
CASES = [
    ("paxos", 3, 1, True),
    ("epaxos", 5, 1, True),       # leaderless: any crash is "a leader"
    ("wpaxos", 6, 2, True),
    ("kpaxos", 3, 1, False),      # static partition leaders by design
    ("abd", 5, 1, True),          # crash-only register: any crash fine
    ("chain", 3, 1, False),       # static chain by design
    ("sdpaxos", 3, 1, True),
    ("wankeeper", 6, 2, True),
]


def fault_schedule(ids, leader_too: bool):
    """The fault schedule as trace-adapter directives, the declarative
    vocabulary sim traces project into (trace/host.py), so a failing
    soak's schedule is a reproducible artifact in the output."""
    followers = [str(i) for i in ids[1:]]
    leader = str(ids[0])
    dirs = [
        CrashWin(followers[0], 1.5, 2.5),
        DropWin(followers[-1], leader, 2.5, 3.3),
        FlakyWin(leader, followers[0], 0.5, 3.5, 4.5),
    ]
    if leader_too:
        dirs.append(CrashWin(leader, 4.5, 5.7))
    return dirs


async def soak_one(name: str, n: int, zones: int, leader_too: bool,
                   base_port: int = 1735) -> dict:
    cfg = local_config(n, zones=zones, base_port=base_port)
    secs = int(os.environ.get("SOAK_HOST_T", "8"))
    cfg.benchmark = Bconfig(T=secs, K=8, W=0.5, concurrency=4,
                            linearizability_check=True)
    c = Cluster(name, cfg=cfg, http=True)
    await c.start()
    admin = AdminClient(cfg)
    dirs = fault_schedule(cfg.ids, leader_too)
    try:
        b = Benchmark(cfg, cfg.benchmark, seed=2)
        bench = asyncio.create_task(b.run())
        injector = asyncio.create_task(drive_admin(admin, dirs))
        stats = await bench
        await injector
        return {
            "protocol": name, "replicas": n, "zones": zones,
            "leader_crash": leader_too, "ops": stats.ops,
            "errors": stats.errors, "anomalies": stats.anomalies,
            "duration_s": round(stats.duration, 2),
            "latency": {k: v for k, v in stats.summary().items()
                        if k.startswith("latency_")},
            "fault_schedule": directives_json(dirs),
            # under-fault evidence (metrics/): per-stream op latency +
            # client retries, and the cluster's per-node message/drop/
            # fault counters merged into one snapshot
            "metrics": {
                "bench": b.metrics.snapshot(),
                "cluster": merge_snapshots(
                    r.metrics.snapshot() for r in c.replicas.values()),
            },
        }
    finally:
        admin.close()
        await c.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paxi_tpu_torch.soak_host",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--protocols", default="",
                   help="comma-separated subset of CASES (default all)")
    p.add_argument("--base-port", type=int, default=1735,
                   help="first peer port; HTTP ports sit 1000 above")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    only = [x for x in args.protocols.split(",") if x]
    results = []
    bad = 0
    for name, n, zones, leader_too in CASES:
        if only and name not in only:
            continue
        try:
            r = asyncio.run(soak_one(name, n, zones, leader_too,
                                     args.base_port))
        except Exception as e:                      # noqa: BLE001
            r = {"protocol": name,
                 "error": f"{type(e).__name__}: {e}"}
        if r.get("anomalies", 1) != 0 or r.get("ops", 0) <= 0:
            bad = 1
        print(json.dumps(r), flush=True)
        results.append(r)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
