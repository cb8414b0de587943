#!/usr/bin/env python3
"""Time two checkouts of the port on one card, in turns.

    python3 scripts/torch_ab.py A_DIR B_DIR [--protocol paxos|epaxos]
        [--repeats 3]
    python3 scripts/torch_ab.py A_DIR B_DIR --kernels

Runs a fresh process in each checkout in the order A, B, B, A.  Each
builds its own kernels (under its own ``build/``) and prints one JSON
line.  The first line is the card's name and power limit.  Needs a CUDA
card.

By default each process warms up once, then times ``--repeats``
fault-free and fuzzed (``p_drop=0.1, max_delay=3``) runs of the
protocol's main path through ``simulate`` at 100,000 groups: the wall
seconds of every run.

With ``--kernels`` each process times, through its own wrappers, the
exchange pair (``ops.exchange.wheel_deliver`` and ``wheel_insert``: the
whole wrapper call over every message type of a step with every torch
pass it makes, one call an event pair and four back to back, median of
30) at every shape of ``chip_smoke.py``'s phase 2 (``EXCHANGE_SHAPES``:
seeded random wheels, outboxes with every other plane a ``dst_major``
view, fault planes; the launches a step and a sum of the outputs, so
that the turns can be checked to agree), the closure kernel on 500,000
graphs of 80 nodes (seeded random graphs at
p = 0.02 and 0.1, and the graphs the EPaxos path hands the closure at
step 30 of its fault-free and fuzzed runs at 100,000 groups, captured
once by this process with B's code and handed over bit-packed under
``B_DIR/build/ab/``) and the ring shift at world 1 over the 47 planes of
an epaxos state of 100,000 groups (``shift.many`` where the checkout has
it, else one call a plane; four calls an event pair, and one): median
CUDA-event milliseconds, and a sum of
each output so that the turns can be checked to agree.  Where a
checkout's closure wrapper passes a squaring count (``_n_iter``), the
closure is also timed with one squaring on two of the inputs: the
difference is what the squarings cost.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# the exchange shapes of chip_smoke.py's phase 2: label, protocol,
# configuration, wheel depth (100,000 groups)
WPAXOS_WAN = dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                  steal_threshold=3, locality=0.8)
WPAXOS_GRID = dict(n_replicas=9, n_zones=3, n_slots=16, n_keys=32,
                   n_objects=16, steal_threshold=4, locality=0.8)
EXCHANGE_SHAPES = [
    ("paxos_d1", "paxos", dict(n_replicas=5, n_slots=64), 1),
    ("paxos_d3", "paxos", dict(n_replicas=5, n_slots=64), 3),
    ("epaxos_d1", "epaxos", dict(n_replicas=5, n_slots=16, n_keys=4), 1),
    ("epaxos_d3", "epaxos", dict(n_replicas=5, n_slots=16, n_keys=4), 3),
    ("wpaxos_wan3z_d6", "wpaxos", WPAXOS_WAN, 6),
    ("paxos_r3_d1", "paxos", dict(n_replicas=3, n_slots=16, n_keys=64), 1),
    ("wpaxos_grid_d1", "wpaxos", WPAXOS_GRID, 1)]
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
KERNELS_CHILD = r"""
import json, statistics, sys
import numpy as np
import torch
from paxi_tpu_torch.ops import closure as C
from paxi_tpu_torch.ops import exchange as X
from paxi_tpu_torch.parallel import make_mesh
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import SimConfig
from paxi_tpu_torch.sim import mailbox as MB
path_files, plane_specs, exchange_shapes = json.loads(sys.argv[1])


def median_ms(fn, reps=10, inner=1):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def unpack(path):
    packed = torch.from_numpy(np.load(path)).cuda()
    bits = (packed[:, None] >> torch.arange(8, device="cuda",
                                            dtype=torch.uint8)) & 1
    return bits.reshape(-1).bool()


# one step's exchange inputs, seeded: wheel, outbox (every other plane a
# dst_major view), fault state, fault planes
def step_inputs(spec, r, d, g=100_000):
    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def lay(x, i):
        return x.transpose(0, 1).contiguous().transpose(0, 1) if i % 2 \
            else x

    wheel, outbox, faults = {}, {}, {}
    for j, (name, fields) in enumerate(spec.items()):
        w = ints((d, 1 + len(fields), r, r, g), 1000)
        w[:, 0] = ints((d, r, r, g), 2)
        wheel[name] = MB.WheelBox(tuple(fields), w)
        outbox[name] = {"valid": lay(ints((r, r, g), 2).bool(), j)}
        for i, f in enumerate(fields):
            outbox[name][f] = lay(ints((r, r, g), 1000), i)
        faults[name] = {"drop": ints((r, r, g), 5) == 0,
                        "delay": ints((r, r, g), d) + 1,
                        "dup": ints((r, r, g), 3) == 0}
    fs = {"conn": ints((r, r, g), 6) != 0, "crashed": ints((r, g), 6) == 0}
    return wheel, outbox, fs, faults


out = {"exchange": {}, "closure": {}, "shift": {}}
gen = torch.Generator(device="cuda")
gen.manual_seed(7)
for label, proto, cfg, d in exchange_shapes:
    cfg = SimConfig(**cfg)
    wheel, outbox, fs, faults = step_inputs(
        sim_protocol(proto).mailbox_spec(cfg), cfg.n_replicas, d)
    before = (X.wheel_deliver.launches, X.wheel_insert.launches)
    inbox, rolled = X.wheel_deliver(wheel)
    new = X.wheel_insert(wheel, outbox, fs, faults)
    out["exchange"][label] = {
        "launches_a_step": [X.wheel_deliver.launches - before[0],
                            X.wheel_insert.launches - before[1]],
        "out_sum": int(sum(int(b.planes.sum(dtype=torch.int64))
                           for b in list(rolled.values())
                           + list(new.values()))
                       + sum(int(v.sum(dtype=torch.int64))
                             for box in inbox.values()
                             for v in box.values())),
        "deliver_ms": median_ms(lambda: X.wheel_deliver(wheel), reps=30),
        "insert_ms": median_ms(lambda: X.wheel_insert(wheel, outbox, fs,
                                                      faults), reps=30),
        "deliver_ms_four_calls": median_ms(lambda: X.wheel_deliver(wheel),
                                           reps=30, inner=4),
        "insert_ms_four_calls": median_ms(
            lambda: X.wheel_insert(wheel, outbox, fs, faults), reps=30,
            inner=4)}
    del wheel, outbox, fs, faults, inbox, rolled, new
    torch.cuda.empty_cache()
graphs = {f"random_p{p}": lambda p=p: torch.rand(
    (500_000, 80, 80), generator=gen, device="cuda") < p
    for p in (0.02, 0.1)}
for label, path in path_files.items():
    graphs[label] = lambda path=path: unpack(path).reshape(-1, 80, 80)
for label, make in graphs.items():
    a = make()
    got = C.closure_launch(a)
    out["closure"][label] = {"ms": median_ms(lambda: C.closure_launch(a)),
                             "out_sum": int(got.sum())}
    if label in ("random_p0.02", "path_fault_free"):
        # one squaring in place of _n_iter(80) = 7, where the checkout's
        # kernel takes a squaring count (the rest is load and store); a
        # kernel that takes none times the same again
        full, C._n_iter = C._n_iter, lambda n: 1
        out["closure"][label]["ms_one_squaring"] = median_ms(
            lambda: C.closure_launch(a))
        C._n_iter = full
    del a, got
    torch.cuda.empty_cache()
mesh = make_mesh(device="cuda")
xs = []
for shape, dtype in plane_specs:
    if dtype == "bool":
        xs.append(torch.rand(shape, generator=gen, device="cuda") < 0.5)
    else:
        xs.append(torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                                device="cuda", dtype=torch.int32))
shift = X.make_remote_lane_shift(mesh)
many = getattr(shift, "many", None) or (lambda v: [shift(x) for x in v])
got = many(xs)
out["shift"] = {"api": "many" if hasattr(shift, "many") else "per_plane",
                "planes": len(xs),
                "exact": all(torch.equal(a, b) for a, b in zip(got, xs)),
                "ms": median_ms(lambda: many(xs), inner=4),
                "ms_single_call": median_ms(lambda: many(xs))}
shift.close()
print(json.dumps(out))
"""


def capture_path_graphs(b_tree: Path) -> dict:
    """The graphs the EPaxos path hands the closure at step 30 of its
    fault-free and fuzzed runs at 100,000 groups (B's code, through B's
    ``chip_smoke.capture_path_graphs``), bit-packed into
    ``b_tree/build/ab/``; returns label -> file."""
    import numpy as np
    import torch
    sys.path.insert(0, str(b_tree))
    import chip_smoke
    out_dir = b_tree / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {}
    for label, adj in chip_smoke.capture_path_graphs().items():
        weights = 1 << torch.arange(8, device=adj.device, dtype=torch.uint8)
        packed = (adj.reshape(-1, 8).to(torch.uint8) * weights).sum(
            dim=1, dtype=torch.uint8)
        files[f"path_{label}"] = str(out_dir / f"path_{label}.npy")
        np.save(files[f"path_{label}"], packed.cpu().numpy())
    torch.cuda.empty_cache()
    return files


def epaxos_plane_specs(b_tree: Path) -> list:
    """(shape, dtype) of every plane of an epaxos state of 100,000
    groups at the main path's configuration (B's code)."""
    import torch
    sys.path.insert(0, str(b_tree))
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    state = sim_protocol("epaxos").init_state(
        SimConfig(**PATHS["epaxos"][0]), None, 100_000, device="meta")
    return [(list(v.shape), "bool" if v.dtype == torch.bool else "int32")
            for v in state.values()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--protocol", choices=sorted(PATHS), default="paxos")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kernels", action="store_true",
                    help="time the exchange pair, the closure and the "
                    "shift, not a path")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if args.kernels:
        b_tree = args.b.resolve()
        child = KERNELS_CHILD
        spec = json.dumps([capture_path_graphs(b_tree),
                           epaxos_plane_specs(b_tree), EXCHANGE_SHAPES])
        label = {"mode": "kernels"}
    else:
        cfg, steps, count = PATHS[args.protocol]
        child = CHILD
        spec = json.dumps([args.protocol, cfg, steps, count, args.repeats])
        label = {"protocol": args.protocol}
    for turn, side in enumerate("ABBA"):
        tree = (args.a if side == "A" else args.b).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree))
        r = subprocess.run([sys.executable, "-c", child, spec], cwd=tree,
                           env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": turn, "side": side, "tree": str(tree),
                          **label, **json.loads(r.stdout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
