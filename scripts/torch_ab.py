#!/usr/bin/env python3
"""Time one main path of two checkouts of the port on one card, in turns.

    python3 scripts/torch_ab.py A_DIR B_DIR [--protocol paxos|epaxos]
        [--repeats 3]

Runs a fresh process in each checkout in the order A, B, B, A.  Each
warms up once, then times ``--repeats`` fault-free and fuzzed
(``p_drop=0.1, max_delay=3``) runs of the protocol's main path through
``simulate`` at 100,000 groups, and prints one JSON line with the wall
seconds of every run.  Each checkout builds its own kernels.  The first
line is the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# each protocol's main path: configuration and depth (as chip_smoke.py)
PATHS = {"paxos": (dict(n_replicas=5, n_slots=64), 104, "committed_slots"),
         "epaxos": (dict(n_replicas=5, n_slots=16, n_keys=4), 60,
                    "executed")}
CHILD = r"""
import json, sys, time
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig, simulate
name, cfg, steps, count, repeats = json.loads(sys.argv[1])
proto, cfg = sim_protocol(name), SimConfig(**cfg)
out = {}
for label, fz in (("fault_free", FAULT_FREE),
                  ("fuzz", FuzzConfig(p_drop=0.1, max_delay=3))):
    simulate(proto, cfg, 100_000, steps, fz, seed=1, device="cuda")
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = simulate(proto, cfg, 100_000, steps, fz, seed=0, device="cuda")
        walls.append(time.perf_counter() - t0)
    out[label] = {"wall_s": walls, count: int(res.metrics[count])}
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--protocol", choices=sorted(PATHS), default="paxos")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cfg, steps, count = PATHS[args.protocol]
    spec = json.dumps([args.protocol, cfg, steps, count, args.repeats])
    for turn, side in enumerate("ABBA"):
        tree = (args.a if side == "A" else args.b).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree))
        r = subprocess.run([sys.executable, "-c", CHILD, spec], cwd=tree,
                           env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": turn, "side": side, "tree": str(tree),
                          "protocol": args.protocol,
                          **json.loads(r.stdout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
