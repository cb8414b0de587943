"""The check's control: the plain reference in the program's place, with
every quorum cut to one replica (``check.QuorumOfOne``, or the reference
module's own ``control_geometry``), which breaks the guarantee each
configuration states (agreement; the conflict order).  The check has to
find it not correct.

    python3 -m simbench.control --workload <cell> --seeds 1,2,3 \\
        [--device cuda]

For each seed, the control runs the window's first episode for the groups
the check runs (the whole batch, or its sample at the cell's own batch
size: the draws are the whole batch's at those groups), and the check
judges it as it judges a run.
Prints one JSON line a seed with the numbers compared.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_numbers(cell, seed: int, device, groups=None):
    """``(numbers, info)`` of the check on the control's outputs."""
    from simbench import check
    from simbench.program import Program, sample_groups

    prog = Program(cell, device, groups)
    lanes = sample_groups(seed, prog.groups,
                          int(cell.config["check"]["groups"]))
    win = check.control_window(prog, seed, lanes)
    return check.judge(prog, win, seed, lanes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from simbench import cells
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers, info = control_numbers(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True,
                          "correct": all(n.ok for n in numbers),
                          **{n.name: n.value for n in numbers},
                          "seconds": time.perf_counter() - t0, **info}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
