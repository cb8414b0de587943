#!/usr/bin/env python3
"""Which switchpaxos safety invariant a trace breaks, step by step.

    python3 scripts/torch_invariant_terms.py TRACE.npz [--device cpu]
        [--steps 3]

Replays a ``switchpaxos``/``switchpaxos_nogap`` trace through the pinned
path (the traced group takes the recorded schedule, the other groups
their draws, as ``trace.replay`` does) and, at each step where the traced
group violates, splits its violations over the five terms of
``protocols/switchpaxos/sim.group_invariants``: ``agree`` (two replicas
committed different commands in one base-aligned slot), ``stable`` (a
committed slot changed or uncommitted, or execution fell behind the
base), ``ballot`` (a ballot went down), ``exec`` (an executed slot not
committed), ``seq`` (the sequencer's expect or session went back).  For
the first ``--steps`` such steps it also lists each disagreeing slot
with every replica's base, commit bit and command there.  Prints JSON
lines, then a total per term that must equal the trace's violations.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def terms(old, new, cfg):
    """The five terms of switchpaxos's ``group_invariants`` for a
    one-group state, and the disagreeing slots' detail."""
    from paxi_tpu_torch.protocols.switchpaxos.sim import BIG, NO_CMD, _shift
    from paxi_tpu_torch.sim.lanes import group_sum, i32sum
    S = cfg.n_slots
    sidx = torch.arange(S, dtype=torch.int32, device=new["base"].device)
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    align = torch.amax(base, dim=0)[None, :] - base
    a_c = _shift(c, align, False)
    a_cmd = _shift(cmd, align, NO_CMD)
    mx = torch.amax(torch.where(a_c, a_cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(a_c, a_cmd, BIG), dim=0)
    bad = (i32sum(a_c, 0) >= 1) & (mx != mn)
    adv = base - old["base"]
    o_c = _shift(old["log_commit"], adv, False)
    o_cmd = _shift(old["log_cmd"], adv, NO_CMD)
    abs_ = base[:, None, :] + sidx[None, :, None]
    out = {
        "agree": int(group_sum(bad)),
        "stable": int(group_sum(o_c & (~c | (cmd != o_cmd)))
                      + group_sum(new["execute"] < base)),
        "ballot": int(group_sum(new["ballot"] < old["ballot"])),
        "exec": int(group_sum((abs_ < new["execute"][:, None, :]) & ~c)),
        "seq": int(group_sum(new["expect"] < old["expect"])
                   + group_sum(new["r_sess"] < old["r_sess"])),
    }
    top = int(torch.amax(base))
    slots = [{"slot": top + int(s),
              "commit": a_c[:, s, 0].tolist(),
              "cmd": a_cmd[:, s, 0].tolist()}
             for s in torch.nonzero(bad[:, 0]).flatten().tolist()]
    return out, {"base": base[:, 0].tolist(),
                 "execute": new["execute"][:, 0].tolist(),
                 "ballots": new["ballot"][:, 0].tolist(),
                 "disagreeing_slots": slots}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=3,
                    help="violating steps to detail")
    args = ap.parse_args()

    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim.runner import (_group_step, _sched_to, _tree_at,
                                           flush_measurements, init_carry)
    from paxi_tpu_torch.sim.types import resolve_device

    t = T.load(args.trace)
    if not t.protocol.startswith("switchpaxos"):
        raise SystemExit(f"{t.protocol}: only switchpaxos traces")
    dev = resolve_device(args.device)
    proto, cfg, fuzz = (sim_protocol(t.protocol), t.sim_config(),
                        t.fuzz_config())
    g = t.group
    total = dict.fromkeys(("agree", "stable", "ballot", "exec", "seq"), 0)
    n_viol, detailed = 0, 0
    with torch.inference_mode():
        sched = _sched_to(t.sched, dev)
        carry = init_carry(proto, cfg, fuzz, t.n_groups,
                           tr.PRNGKey(t.seed), dev)
        for step in range(t.n_steps):
            old = {k: v[..., g:g + 1].clone() for k, v in carry[0].items()}
            carry, (viol, _) = _group_step(proto, cfg, fuzz, carry, step,
                                           sched_t=_tree_at(sched, step),
                                           pin_on=g)
            carry = flush_measurements(proto, cfg, carry, step)
            v = int(viol.sum())
            if not v:
                continue
            n_viol += v
            new = {k: x[..., g:g + 1] for k, x in carry[0].items()}
            split, detail = terms(old, new, cfg)
            for k in total:
                total[k] += split[k]
            line = {"step": step, "violations": v, **split}
            if detailed < args.steps:
                line.update(detail)
                detailed += 1
            print(json.dumps(line), flush=True)
    print(json.dumps({"trace": args.trace, "protocol": t.protocol,
                      "group": g, "groups": t.n_groups,
                      "violations": n_viol,
                      "recorded_violations": t.meta.get("group_violations"),
                      "terms": total, "device": str(dev)}))
    return 0 if sum(total.values()) == n_viol else 1


if __name__ == "__main__":
    sys.exit(main())
