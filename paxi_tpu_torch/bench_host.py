"""Host-runtime benchmark sweep: every protocol through the real
deployment stack (in-process cluster + HTTP client + closed-loop
benchmark + linearizability check), the reference's primary user
surface (bin/client against a -simulation cluster).  The port's twin of
the JAX package's root ``bench_host.py``: the same ``CONFIGS``, the same
``BENCH_HOST_T``/``BENCH_HOST_WARMUP``/``BENCH_HOST_WORKLOAD`` variables,
the same lines.

    python -m paxi_tpu_torch.bench_host [--protocols paxos,dynamo] \\
        [--base-port 1735] [--out build/bench_host/BENCH_HOST.json]

Prints one JSON line per protocol and writes the collected list to
``--out`` (never the root ``BENCH_HOST.json``).  ``anomalies`` is the
linearizability checker's count: 0 expected for every protocol except
the eventually-consistent ones (dynamo, blockchain), whose lines are
labelled ``consistency: eventual`` and run without the check.  Serving
is asyncio Python on the CPU: no line here is a device figure.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from pathlib import Path

from paxi_tpu_torch.core.config import Bconfig, local_config
from paxi_tpu_torch.host.benchmark import Benchmark
from paxi_tpu_torch.host.simulation import Cluster
from paxi_tpu_torch.metrics import merge_snapshots

OUT = Path(__file__).resolve().parents[1] / "build" / "bench_host" \
    / "BENCH_HOST.json"

CONFIGS = [
    # (protocol, n, zones, linearizable?)
    ("paxos", 3, 1, True),
    ("epaxos", 5, 1, True),
    ("wpaxos", 6, 2, True),
    ("abd", 5, 1, True),
    ("chain", 3, 1, True),
    ("kpaxos", 3, 1, True),
    ("sdpaxos", 3, 1, True),
    ("wankeeper", 6, 2, True),
    ("dynamo", 3, 1, False),
    ("blockchain", 3, 1, False),
    # the in-fabric consensus tier's host replica: with no switch on the
    # wire it serves as classic paxos over the same frames
    ("switchpaxos", 3, 1, True),
]


async def bench_one(name: str, n: int, zones: int, lin: bool,
                    base_port: int = 1735) -> dict:
    cfg = local_config(n, zones=zones, base_port=base_port)
    secs = int(os.environ.get("BENCH_HOST_T", "4"))
    # warmup window excluded from the reported ops/s: dial-up and leader
    # election don't dilute steady state
    warm = float(os.environ.get("BENCH_HOST_WARMUP", "1.0"))
    cfg.benchmark = Bconfig(T=secs, K=8, W=0.5, concurrency=4,
                            warmup=min(warm, secs / 2),
                            linearizability_check=lin)
    # BENCH_HOST_WORKLOAD=<named spec>: drive every protocol with a
    # workload spec instead of the uniform KeyGen/W draws (the spec
    # family the sim kernels compile, workload/compile.py)
    wl_name = os.environ.get("BENCH_HOST_WORKLOAD", "")
    wl = None
    if wl_name:
        from paxi_tpu_torch.workload import named_workload
        wl = named_workload(wl_name)
    c = Cluster(name, cfg=cfg, http=True)
    await c.start()
    try:
        t0 = time.perf_counter()
        bench = Benchmark(cfg, cfg.benchmark, seed=1, workload=wl)
        stats = await bench.run()
        dt = time.perf_counter() - t0
        return {
            "metric": f"{name}_host_ops_per_sec",
            # steady-state: completions inside the warmup window are
            # excluded from numerator and denominator
            "value": round(stats.ops / max(stats.duration - stats.warmup_s,
                                           1e-9), 1),
            "unit": "ops/s",
            "protocol": name,
            "replicas": n,
            "zones": zones,
            "ops": stats.ops,
            "warmup_s": stats.warmup_s,
            "warmup_ops": stats.warmup_ops,
            "errors": stats.errors,
            "anomalies": (stats.anomalies if lin else None),
            "consistency": ("linearizable" if lin else "eventual"),
            **({"workload": wl.name} if wl is not None else {}),
            "wall_s": round(dt, 2),
            "latency": {k: v for k, v in stats.summary().items()
                        if k.startswith("latency_")},
            # the per-message-class evidence (metrics/): the bench
            # registry (per-stream op latency histograms + client
            # retries) and the node registries merged cluster-wide
            "metrics": {
                "bench": bench.metrics.snapshot(),
                "cluster": merge_snapshots(
                    r.metrics.snapshot() for r in c.replicas.values()),
            },
        }
    finally:
        await c.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paxi_tpu_torch.bench_host",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--protocols", default="",
                   help="comma-separated subset of CONFIGS (default all)")
    p.add_argument("--base-port", type=int, default=1735,
                   help="first peer port; HTTP ports sit 1000 above")
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    only = [x for x in args.protocols.split(",") if x]
    results = []
    worst = 0
    for name, n, zones, lin in CONFIGS:
        if only and name not in only:
            continue
        try:
            r = asyncio.run(bench_one(name, n, zones, lin, args.base_port))
        except Exception as e:                      # noqa: BLE001
            r = {"metric": f"{name}_host_ops_per_sec", "value": 0,
                 "protocol": name, "error": f"{type(e).__name__}: {e}"}
            worst = 1
        if r.get("errors") or (r.get("anomalies") or 0) > 0:
            worst = 1
        print(json.dumps(r), flush=True)
        results.append(r)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
