"""Delta-debugging minimizer for traces: from a violating schedule to a
minimal witness (the port's copy of the JAX package's ``trace/shrink.py``,
on numpy schedules; the same passes, trial order and output).

Classic ddmin over the trace's fault events, with the pinned replay as
the oracle: a candidate schedule passes if the traced group still
violates.  Passes, in order:

1. **Truncate** to the first violating step + 1.
2. **Category sweeps**: delete whole event classes at once (all dups,
   all delays, all cuts, all crashes, all drops of one message type).
3. **ddmin** over the remaining individual events.
4. **Re-truncate** (removing events can move the violation earlier).

Every candidate is a full deterministic replay; the output trace carries
``shrunk: True``, before/after stats and its own replay state hash.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from paxi_tpu_torch.sim.types import SimProtocol
from paxi_tpu_torch.trace.format import Trace
from paxi_tpu_torch.trace.replay import ReplayResult, replay

# an event is ("drop"|"dup"|"delay", msg, t, i, j), ("crash", t, i) or
# ("cut", t, i, j) — everything the schedule can express, one atom each
Event = Tuple


def list_events(sched) -> List[Event]:
    ev: List[Event] = []
    for t, i, j in np.argwhere(~np.asarray(sched["conn"])):
        ev.append(("cut", int(t), int(i), int(j)))
    for t, i in np.argwhere(np.asarray(sched["crashed"])):
        ev.append(("crash", int(t), int(i)))
    for name in sorted(sched["faults"]):
        f = sched["faults"][name]
        for t, i, j in np.argwhere(np.asarray(f["drop"])):
            ev.append(("drop", name, int(t), int(i), int(j)))
        for t, i, j in np.argwhere(np.asarray(f["dup"])):
            ev.append(("dup", name, int(t), int(i), int(j)))
        for t, i, j in np.argwhere(np.asarray(f["delay"]) > 1):
            ev.append(("delay", name, int(t), int(i), int(j)))
    return ev


def neutralize(sched, events: List[Event]):
    """A copy of ``sched`` with ``events`` replaced by fault-free
    values (conn=True, crashed=False, drop/dup=False, delay=1)."""
    out = {"conn": np.array(sched["conn"]),
           "crashed": np.array(sched["crashed"]),
           "faults": {n: {k: np.array(v) for k, v in f.items()}
                      for n, f in sched["faults"].items()}}
    for e in events:
        if e[0] == "cut":
            _, t, i, j = e
            out["conn"][t, i, j] = True
        elif e[0] == "crash":
            _, t, i = e
            out["crashed"][t, i] = False
        else:
            kind, name, t, i, j = e
            if kind == "drop":
                out["faults"][name]["drop"][t, i, j] = False
            elif kind == "dup":
                out["faults"][name]["dup"][t, i, j] = False
            else:
                out["faults"][name]["delay"][t, i, j] = 1
    return out


def _truncate(sched, t_end: int):
    if isinstance(sched, dict):
        return {k: _truncate(v, t_end) for k, v in sched.items()}
    return np.asarray(sched)[:t_end]


def shrink(trace: Trace, proto: Optional[SimProtocol] = None,
           max_trials: int = 200, log=None,
           device=None) -> Tuple[Trace, Dict[str, int]]:
    """Minimize ``trace``, replaying on ``device`` (the card unless
    ``"cpu"`` is asked for); returns (minimal trace, stats).  Raises
    ValueError if the input trace does not reproduce a violation."""
    emit = log or (lambda *_: None)
    trials = 0

    def oracle(sched) -> ReplayResult:
        nonlocal trials
        trials += 1
        return replay(trace, proto, sched=sched, device=device)

    base = oracle(trace.sched)
    if not base.violated:
        raise ValueError(
            "trace does not reproduce a violation; nothing to shrink")
    steps0, events0 = trace.n_steps, trace.n_events()

    # ---- pass 1: truncate to the violating prefix ----------------------
    sched = trace.sched
    t_end = base.first_violation_step() + 1
    if t_end < trace.n_steps:
        cand = _truncate(sched, t_end)
        res = oracle(cand)
        if res.violated:          # prefix determinism should guarantee it
            sched, base = cand, res
    emit(f"truncated {steps0} -> "
         f"{int(np.asarray(sched['crashed']).shape[0])} steps")

    # ---- pass 2: whole-category sweeps ---------------------------------
    def events_of(s):
        return list_events(s)

    cats = [lambda e: e[0] == "dup", lambda e: e[0] == "delay",
            lambda e: e[0] == "cut", lambda e: e[0] == "crash"]
    cats += [(lambda e, n=name: e[0] == "drop" and e[1] == n)
             for name in sorted(sched["faults"])]
    for cat in cats:
        if trials >= max_trials:
            break
        victims = [e for e in events_of(sched) if cat(e)]
        if not victims:
            continue
        cand = neutralize(sched, victims)
        res = oracle(cand)
        if res.violated:
            sched, base = cand, res
            emit(f"dropped category ({len(victims)} events)")

    # ---- pass 3: ddmin over the remaining events -----------------------
    kept = events_of(sched)
    n = 2
    while len(kept) >= 2 and n <= len(kept) and trials < max_trials:
        chunk = max(len(kept) // n, 1)
        reduced = False
        for lo in range(0, len(kept), chunk):
            if trials >= max_trials:
                break
            victims = kept[lo:lo + chunk]
            remaining = kept[:lo] + kept[lo + chunk:]
            cand = neutralize(sched, victims)
            res = oracle(cand)
            if res.violated:
                sched, base, kept = cand, res, remaining
                n = max(n - 1, 2)
                reduced = True
                emit(f"{len(kept)} events left")
                break
        if not reduced:
            if n >= len(kept):
                break
            n = min(len(kept), n * 2)

    # ---- pass 4: re-truncate (the violation may have moved) ------------
    t_end = base.first_violation_step() + 1
    if t_end < int(np.asarray(sched["crashed"]).shape[0]):
        cand = _truncate(sched, t_end)
        res = oracle(cand)
        if res.violated:
            sched, base = cand, res

    out = trace.with_sched(
        sched, shrunk=True,
        group_violations=base.violations,
        first_violation_step=base.first_violation_step(),
        replay_state_hash=base.state_hash,
        replay_counters=dict(base.counters),
        shrink_stats={"steps_before": steps0, "events_before": events0,
                      "replays": trials})
    stats = {
        "steps_before": steps0, "steps_after": out.n_steps,
        "events_before": events0, "events_after": out.n_events(),
        "replays": trials, "violations": base.violations,
    }
    return out, stats
