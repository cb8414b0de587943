"""The plain round loop (a frozen copy of the port's lane-major
``sim/runner.py`` path with the plain exchange), run on a sample of a
batch's groups.

Each round splits the run key in four (next key, step, faults, insert),
delivers, steps, refreshes and draws the faults, counts the exchange's
messages, inserts and checks the invariants, then bins the pending commit latencies every
``flush_every`` rounds.  The draws are the whole batch's at the sampled
groups (``prng.LaneKey``), so each sampled group runs exactly as it runs
inside the batch.
"""

from __future__ import annotations

from types import ModuleType

import torch

from simbench.reference import exchange as ex
from simbench.reference import prng
from simbench.reference.common import (Faults, Geometry, StepCtx,
                                       flush_every, flush_pending)


def run_episode(proto: ModuleType, geo: Geometry, faults: Faults,
                key: tuple, lanes, groups: int, rounds: int, device):
    """``(state, violations, counts)`` after ``rounds`` rounds from the
    episode key ``key`` (two words) for the groups ``lanes`` of a batch of
    ``groups``: the final state lane-major (sample axis last), each
    sampled group's invariant violations ``(L,)`` and its exchange
    counters summed over the rounds, ``{name: (L,) int64}``."""
    lanes = torch.as_tensor(lanes, dtype=torch.int64, device=device)
    n, L = geo.n_replicas, int(lanes.numel())

    def lane_key(words):
        return prng.LaneKey(words[0], words[1], lanes, groups)

    _k_state, k_run = prng.split_words(key[0], key[1], 2)
    with torch.inference_mode():
        state = proto.init_state(geo, None, L, device=device)
        wheel = ex.empty_wheel(proto.mailbox_spec(geo), n, L, faults,
                               device)
        fs = ex.fault_state_init(n, L, device)
        viol = torch.zeros((L,), dtype=torch.int32, device=device)
        counts = {k: torch.zeros((L,), dtype=torch.int64, device=device)
                  for k in ex.COUNTER_NAMES}
        rng = k_run
        for t in range(rounds):
            rng, k_step, k_fault, k_ins = prng.split_words(*rng, 4)
            inbox, wheel = ex.wheel_deliver(wheel)
            new_state, outbox = proto.step(state, inbox,
                                           StepCtx(lane_key(k_step), t, geo))
            fs = ex.fault_state_refresh(fs, lane_key(k_fault), t, faults, n)
            drawn = ex.draw_edge_faults(lane_key(k_ins), outbox, faults)
            c = ex.step_counts(inbox, outbox, drawn, fs, n, wheel)
            counts = {k: v + c[k] for k, v in counts.items()}
            wheel = ex.wheel_insert(wheel, outbox, fs, drawn)
            viol = viol + proto.group_invariants(state, new_state, geo)
            state = new_state
            if "m_commit_dt" in state and \
                    (t + 1) % flush_every(geo.n_slots) == 0:
                state = flush_pending(state)
    return state, viol, counts
