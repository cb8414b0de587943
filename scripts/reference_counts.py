#!/usr/bin/env python3
"""The JAX package's count for a row of ``chip_smoke.py``'s phase 8 or 9
(``PROTO_ROWS``: bench_all.py's protocol rows; ``SWITCH_ROWS``: its
switchnet pair and the hunt's switchpaxos seqchurn case), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/reference_counts.py ROW [--groups N]

Runs ``paxi_tpu.sim.make_run`` of the row's protocol, configuration,
schedule and depth from ``PRNGKey(0)`` (chip_smoke's seed) at ``--groups``
groups (default 100,000, the row's width) and prints one JSON line with
every metric and the violations.  A row whose count depends on the
seed's draws is held on the card to this count.  Needs JAX (the card's
machine has none); at 100,000 groups a run takes minutes to half an hour
and up to ~16 GB here (wan3z).  A row's ``SimConfig`` keyword arguments
(the sequencer's ``sw_down_*`` among them) are passed as they stand.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _latency(state, metrics):
    """The run's commit-latency summary (p50/p99 in rounds), as
    bench_all.py prints it."""
    from paxi_tpu.metrics import lathist
    hist = lathist.total_hist(state)
    if hist is None:
        return None
    return lathist.summarize(hist, int(metrics.get("commit_lat_sum", 0)))


def main() -> int:
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    rows = {**chip_smoke.PROTO_ROWS, **chip_smoke.SWITCH_ROWS}
    ap.add_argument("row", choices=sorted(rows))
    ap.add_argument("--groups", type=int, default=chip_smoke.GROUPS)
    args = ap.parse_args()

    import jax.random as jr
    from paxi_tpu.protocols import sim_protocol
    from paxi_tpu.scenarios import NAMED, with_scenario
    from paxi_tpu.sim import FuzzConfig, SimConfig, make_run

    spec = rows[args.row]
    sched = spec.get("schedule", "fault_free")
    fuzz = {"fault_free": FuzzConfig(),
            "wan3z": with_scenario(FuzzConfig(), NAMED["wan3z"]),
            "bench_fuzz": FuzzConfig(**chip_smoke.BENCH_FUZZ_ARGS),
            "hunt_drop": FuzzConfig(**chip_smoke.TWIN_DROP_ARGS),
            "seqchurn_drop": FuzzConfig(**chip_smoke.TWIN_DROP_ARGS)}[sched]
    t0 = time.perf_counter()
    state, metrics, viol = make_run(sim_protocol(spec["protocol"]),
                                    SimConfig(**spec["cfg"]), fuzz)(
        jr.PRNGKey(chip_smoke.SEED), args.groups, spec["steps"])
    print(json.dumps({
        "row": args.row, "protocol": spec["protocol"], "schedule": sched,
        "groups": args.groups, "steps": spec["steps"],
        "metrics": {k: int(v) for k, v in metrics.items()},
        "violations": int(viol), "expect": spec["expect"],
        "commit_latency": _latency(state, metrics),
        "device": "cpu (the JAX package)",
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
