"""The comparison that decides ``correct``.

Once the window has closed, the plain reference (``simbench/reference``)
works out again the episodes the check draws from the seed, from the same
episode keys, and every plane of the sampled groups' final state has to
equal the program's bit for bit: the protocol state, the commit-latency
histogram, the executed prefix.  Where the configuration asks for it
(``check.whole_batch``) the reference runs the episode's whole batch, and
the episode's command total and its ``net_*`` exchange counters (the fault
draws as they show in them) have to equal the reference's too.  Every
episode's command total has to equal what the reference's metric counts on
the program's own final plane, and the window's invariant and in-round
violations have to be 0, the guarantee every configuration states.  Each
is an exact comparison, so each limit is 0.

A reference module (``simbench/reference/<name>.py``, found by
``cells.reference``) exports ``init_state``, ``mailbox_spec``,
``step`` and ``group_invariants`` (the round loop's calls, on lane-major
planes), ``COMMAND_PLANES`` (the plane each command count is made of),
``command_count`` and ``metrics``; and, optionally, ``control_geometry``:
the geometry its control runs under, given the configuration's, for a
protocol whose quorums ``QuorumOfOne`` does not reach (counted in zones,
say).  Without it the control runs under ``QuorumOfOne``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List

import numpy as np
import torch

from simbench.program import Episode, Program, Window, episode_words
from simbench.reference.common import Faults, Geometry
from simbench.reference.runner import run_episode

# the prefix of the program's exchange counters among its metrics
NET_PREFIX = "net_"


@dataclass
class Number:
    name: str
    value: int
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass(frozen=True)
class QuorumOfOne(Geometry):
    """The control's geometry: every quorum is one replica, which breaks
    the quorum intersection that agreement and the conflict order rest
    on."""

    @property
    def majority(self) -> int:
        return 1

    @property
    def fast_size(self) -> int:
        return 1


def faults_of(prog: Program) -> Faults:
    return Faults(**prog.cell.traffic["fuzz"])


def choose_episodes(win: Window, seed: int, rounds: int,
                    n: int) -> List[Episode]:
    """The window's last episode when the window's end cut it, and whole
    episodes drawn from the seed, ``n`` in all (at least one)."""
    whole = [e for e in win.episodes if e.rounds == rounds]
    cut = [e for e in win.episodes if 0 < e.rounds < rounds]
    chosen = cut[-1:]
    k = min(max(n - len(chosen), 1 if not chosen else 0), len(whole))
    if k:
        gen = np.random.default_rng([seed % (1 << 63), 1])
        idx = np.sort(gen.choice(len(whole), size=k, replace=False))
        chosen = [whole[i] for i in idx] + chosen
    return chosen


def mismatch(got: Dict[str, torch.Tensor],
             want: Dict[str, torch.Tensor]) -> int:
    """Elements of ``got``'s planes that differ from ``want``'s; a plane
    that one side lacks, or that differs in shape or type, counts whole."""
    n = 0
    for k in sorted(set(got) | set(want)):
        a, b = got.get(k), want.get(k)
        if a is None or b is None:
            n += (a if b is None else b).numel()
            continue
        b = b.to(a.device)
        if a.shape != b.shape or a.dtype != b.dtype:
            n += max(a.numel(), b.numel())
            continue
        n += int((a != b).sum())
    return n


def reference_run(prog: Program, seed: int, episode: int, rounds: int,
                  lanes: np.ndarray, geo: Geometry = None):
    """The reference's episode for the groups ``lanes`` (lane-major):
    ``(state, violations, counts)`` as ``run_episode`` gives them."""
    return run_episode(prog.ref, geo or prog.geo, faults_of(prog),
                       episode_words(seed, episode), lanes, prog.groups,
                       rounds, prog.device)


def whole_batch(prog: Program) -> bool:
    return bool(prog.cell.config["check"].get("whole_batch", False))


def judge(prog: Program, win: Window, seed: int, lanes: np.ndarray,
          episodes: int = None) -> tuple:
    """``(numbers, info)``: the numbers compared, each with its limit, and
    what was checked; ``episodes`` overrides how many episodes the
    reference works out again (the configuration's ``check.episodes``)."""
    t0 = time.perf_counter()
    cmds_mismatch = sum(
        abs(int(e.metrics[prog.command])
            - int(prog.ref.command_count(e.counted, prog.command)))
        for e in win.episodes)
    violations = sum(int(e.violations)
                     + int(e.metrics.get("inscan_violations", 0))
                     for e in win.episodes)
    chosen = choose_episodes(win, seed, prog.rounds, int(
        episodes or prog.cell.config["check"]["episodes"]))
    batch = whole_batch(prog)
    run_lanes = np.arange(prog.groups) if batch else lanes
    state_mismatch = net_mismatch = 0
    for ep in chosen:
        state, _, counts = reference_run(prog, seed, ep.index, ep.rounds,
                                         run_lanes)
        if batch:
            cmds_mismatch += abs(
                int(ep.metrics[prog.command])
                - int(prog.ref.command_count(state, prog.command)))
            net_mismatch += sum(
                abs(int(ep.metrics[NET_PREFIX + k]) - int(v.sum()))
                for k, v in counts.items())
            idx = torch.as_tensor(lanes, device=prog.device)
            state = {k: v.index_select(-1, idx) for k, v in state.items()}
        want = {k: torch.movedim(v, -1, 0) for k, v in state.items()}
        state_mismatch += mismatch(ep.sampled, want)
    numbers = [Number("state_mismatch", state_mismatch, 0),
               Number("cmds_mismatch", cmds_mismatch, 0),
               Number("violations", violations, 0)]
    if batch:
        numbers.insert(2, Number("net_mismatch", net_mismatch, 0))
    info = {"episodes_checked": [e.index for e in chosen],
            "rounds_checked": [e.rounds for e in chosen],
            "groups_checked": int(len(run_lanes)),
            "groups_compared_plane_by_plane": int(len(lanes)),
            "check_s": time.perf_counter() - t0}
    return numbers, info


def control_geometry(prog: Program) -> Geometry:
    """The control's geometry: the reference module's
    ``control_geometry`` of the configuration's, where it has one, else
    the configuration's under ``QuorumOfOne``."""
    own = getattr(prog.ref, "control_geometry", None)
    if own is not None:
        return own(prog.geo)
    return replace(QuorumOfOne(), **prog.cell.config["sim"])


def control_window(prog: Program, seed: int, lanes: np.ndarray,
                   episodes: int = 1) -> Window:
    """The control in the program's place: the reference under
    ``control_geometry`` runs the window's first whole episodes, for the
    groups the check runs (the whole batch where it runs the whole batch,
    else the sample, at the cell's batch size: the draws are the batch's),
    and stands for the program's outputs: its command totals and counters
    over those groups, the sample's final planes."""
    geo = control_geometry(prog)
    run_lanes = np.arange(prog.groups) if whole_batch(prog) else lanes
    idx = torch.as_tensor(np.searchsorted(run_lanes, lanes),
                          device=prog.device)
    win = Window()
    for e in range(episodes):
        state, viol, counts = reference_run(prog, seed, e, prog.rounds,
                                            run_lanes, geo=geo)
        metrics = {prog.command: prog.ref.command_count(state, prog.command),
                   **{NET_PREFIX + k: v.sum() for k, v in counts.items()}}
        sampled = {k: torch.movedim(v.index_select(-1, idx), -1, 0)
                   for k, v in state.items()}
        plane = prog.ref.COMMAND_PLANES[prog.command]
        win.episodes.append(Episode(
            e, prog.rounds, metrics, torch.sum(viol, dtype=torch.int32),
            sampled, {plane: state[plane]}))
    return win
