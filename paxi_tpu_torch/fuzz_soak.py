"""Fuzz soak on the torch sim runtime: every case of the adversarial
matrix (``hunt/cases.py``) under each of its schedules and every seed,
holding the in-kernel safety oracles silent (the port's twin of the JAX
package's ``fuzz_soak.py``; 0 violations expected on correct protocols).

    python -m paxi_tpu_torch.fuzz_soak [--out build/FUZZ_SOAK.json]
        [--cases START:STOP] [--seed-bug] [--no-capture]
        [--traces-dir build/traces] [--device cpu]

Prints one JSON record a (case, schedule, seed) run, with the reference's
fields, writes ``{"total_runs", "total_violations", "runs"}`` to
``--out`` (never the JAX package's root ``FUZZ_SOAK.json``), and exits 1
if any run violated.  A violating run is captured (record mode) and its
trace saved under ``--traces-dir``, the hunt corpus's seed; ``--seed-bug``
appends the deliberately broken ``wankeeper_nofloor`` case to exercise
that pipeline (excluded from the totals and the exit code).
``--cases START:STOP`` runs a slice of the case list, so a sweep can be
split over several processes or calls; ``--merge PART.json ...`` joins
their outputs into ``--out`` (totals summed, runs in order) and exits as
the whole sweep would.  Runs go on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.hunt.cases import BUG_DEMO, CASES, SEEDS, sched_name
from paxi_tpu_torch.metrics.simcount import counters_of
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import make_run

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def dump_trace(traces_dir, name, cfg, fz, seed, groups, steps,
               device=None):
    """Record-mode rerun of a violating case -> the saved trace's path
    (None if the violation did not recapture)."""
    from paxi_tpu_torch import trace as T
    t = T.capture(sim_protocol(name), cfg, fz, seed, groups, steps,
                  proto_name=name, device=device)
    if t is None:
        return None
    os.makedirs(traces_dir, exist_ok=True)
    # geometry in the name: several cases share (protocol, schedule,
    # seed) and must not overwrite each other's files
    geo = f"n{cfg.n_replicas}z{cfg.n_zones}q{cfg.grid_q2}"
    return T.save(os.path.join(
        traces_dir, f"{name}_{geo}_{sched_name(fz)}_s{seed}"), t)


def soak_record(name, cfg, fz, seed, groups, steps, pkey, run=None,
                device=None, traces_dir=None) -> dict:
    """One soak run's record (the reference's fields).  ``run`` is the
    case's ``make_run`` (built here when None); with ``traces_dir`` a
    violating run is captured there and its path recorded."""
    if run is None:
        run = make_run(sim_protocol(name), cfg, fz, device=device)
    t0 = time.perf_counter()
    _, metrics, viols = run(tr.PRNGKey(seed), groups, steps)
    v = int(viols)
    rec = {
        "protocol": name,
        "schedule": sched_name(fz),
        "seed": seed,
        "replicas": cfg.n_replicas,
        "zones": cfg.n_zones,
        "grid_q2": cfg.grid_q2,
        "groups": groups,
        "steps": steps,
        "violations": v,
        "progress": int(metrics[pkey]),
        # the on-device message/fault counters: what the schedule did
        "counters": {k: int(x) for k, x in counters_of(metrics).items()},
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    if v and traces_dir is not None:
        rec["trace"] = dump_trace(traces_dir, name, cfg, fz, seed, groups,
                                  steps, device=device)
    return rec


def write(out: str, runs) -> int:
    """Write the soak's output to ``out``; returns the total
    violations."""
    bad = sum(r["violations"] for r in runs)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"total_runs": len(runs), "total_violations": bad,
                   "runs": runs}, f, indent=1)
    print(f"fuzz-soak: {len(runs)} runs, {bad} violations")
    return bad


def merge(parts, out: str) -> int:
    """Join soak outputs into one; returns the total violations."""
    runs = []
    for p in parts:
        with open(p) as f:
            runs += json.load(f)["runs"]
    return write(out, runs)


def _slice(spec: str) -> slice:
    lo, _, hi = spec.partition(":")
    return slice(int(lo) if lo else None, int(hi) if hi else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-capture", action="store_true",
                    help="violations stay counters (no trace dumps)")
    ap.add_argument("--traces-dir", default=str(BUILD_DIR / "traces"))
    ap.add_argument("--seed-bug", action="store_true",
                    help="append the wankeeper_nofloor demo case")
    ap.add_argument("--out", default=str(BUILD_DIR / "FUZZ_SOAK.json"))
    ap.add_argument("--cases", default=":", metavar="START:STOP",
                    help="a slice of the case list (default: all)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--merge", nargs="+", default=None, metavar="PART",
                    help="join these outputs into --out instead of running")
    args = ap.parse_args(argv)
    if args.merge:
        return 1 if merge(args.merge, args.out) else 0

    cases = list(CASES)[_slice(args.cases)] \
        + ([BUG_DEMO] if args.seed_bug else [])
    traces_dir = None if args.no_capture else args.traces_dir
    results = []
    for name, cfg, scheds, groups, steps, pkey in cases:
        proto = sim_protocol(name)
        demo = name == BUG_DEMO[0]
        for fz in scheds:
            run = make_run(proto, cfg, fz, device=args.device)
            for seed in SEEDS:
                rec = soak_record(name, cfg, fz, seed, groups, steps, pkey,
                                  run=run, device=args.device,
                                  traces_dir=traces_dir)
                if not demo:
                    results.append(rec)
                print(json.dumps(rec), flush=True)
    return 1 if write(args.out, results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
