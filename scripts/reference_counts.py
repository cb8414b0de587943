#!/usr/bin/env python3
"""The JAX package's count for a row of ``chip_smoke.py``'s phase 8, 9 or
10 (``PROTO_ROWS``: bench_all.py's protocol rows; ``SWITCH_ROWS``: its
switchnet pair and the hunt's switchpaxos seqchurn case; ``DRIVER_ROWS``:
the bench_all twin's row at its own shape), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/reference_counts.py ROW [--groups N]
    JAX_PLATFORMS=cpu python3 scripts/reference_counts.py \
        --soak PROTOCOL SCHEDULE SEED

Runs ``paxi_tpu.sim.make_run`` of the row's protocol, configuration,
schedule and depth from ``PRNGKey(0)`` (chip_smoke's seed) at ``--groups``
groups (default: the row's width, 100,000 unless it names its own) and
prints one JSON line with
every metric and the violations.  A row whose count depends on the
seed's draws is held on the card to this count.  Needs JAX (the card's
machine has none); at 100,000 groups a run takes minutes to half an hour
and up to ~16 GB here (wan3z).  A row's ``SimConfig`` keyword arguments
(the sequencer's ``sw_down_*`` among them) are passed as they stand.
``--soak`` runs instead the JAX package's fuzz soak record of a hunt case
(the first ``paxi_tpu.hunt.cases.CASES`` row of PROTOCOL with a schedule
named SCHEDULE, at the case's own groups and steps, from ``PRNGKey(SEED)``)
and, when it violates, the capture's group and schedule hash.
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


def soak(protocol: str, schedule: str, seed: int) -> int:
    import jax.random as jr
    from paxi_tpu import trace as T
    from paxi_tpu.hunt.cases import CASES, sched_name
    from paxi_tpu.metrics.simcount import counters_of
    from paxi_tpu.protocols import sim_protocol
    from paxi_tpu.sim import make_run

    name, cfg, fz, groups, steps, pkey = next(
        (c[0], c[1], f, c[3], c[4], c[5]) for c in CASES
        for f in c[2] if c[0] == protocol and sched_name(f) == schedule)
    t0 = time.perf_counter()
    _, metrics, viol = make_run(sim_protocol(name), cfg, fz)(
        jr.PRNGKey(seed), groups, steps)
    out = {"protocol": name, "schedule": schedule, "seed": seed,
           "groups": groups, "steps": steps, "violations": int(viol),
           "inscan_violations": int(metrics.get("inscan_violations", 0)),
           "progress": int(metrics[pkey]),
           "counters": {k: int(v) for k, v in counters_of(metrics).items()}}
    if int(viol):
        t = T.capture(sim_protocol(name), cfg, fz, seed, groups, steps,
                      proto_name=name)
        out.update(group=t.meta["group"],
                   group_violations=t.meta["group_violations"],
                   first_violation_step=t.meta["first_violation_step"],
                   schedule_hash=t.meta["schedule_hash"])
    out.update(device="cpu (the JAX package)",
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


def main() -> int:
    if "--soak" in sys.argv:
        i = sys.argv.index("--soak")
        return soak(sys.argv[i + 1], sys.argv[i + 2], int(sys.argv[i + 3]))
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    rows = {**chip_smoke.PROTO_ROWS, **chip_smoke.SWITCH_ROWS,
            **chip_smoke.DRIVER_ROWS}
    ap.add_argument("row", choices=sorted(rows))
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args()
    args.groups = args.groups or rows[args.row].get("groups",
                                                    chip_smoke.GROUPS)

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
