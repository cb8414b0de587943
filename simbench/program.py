"""The system under test, driven by episodes: ``paxi_tpu_torch``'s runner.

An episode is the configuration's own run length from a fresh key: the
runner's ``init_carry``, one call of ``make_scan_body``'s round body a
round with the violations and ``net_*`` counters summed on the device (as
``run_steps`` sums them), and ``finish_run``.  Episodes follow each other
until the window's seconds have passed; the last one stops where the
window ends and is finished there.  Nothing in the loop waits for the
device: a round's time is the device clock's gap between the events
recorded at its two ends, read once the window has closed.

Of each episode's final state the window keeps the groups the check
samples (a gather on the device) and a handle on the plane that the
episode's command count is made of; the check recounts that plane once
the window has closed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from simbench import cells
from simbench.reference import prng
from simbench.reference.common import Geometry

# the episode index of the warm-up's key: no window episode takes it
WARM_EPISODE = 0xFFFFFFFF


def episode_words(seed: int, episode: int) -> tuple:
    """The key words of an episode: ``fold_in(seed's key, episode)``."""
    return prng.fold_words(*prng.key_words(seed), episode)


def sample_groups(seed: int, groups: int, n: int) -> np.ndarray:
    """The groups the check recomputes, drawn from the seed: ``n`` of
    ``groups`` without repeats, in increasing order."""
    gen = np.random.default_rng([seed % (1 << 63), groups, n])
    n = min(n, groups)
    return np.sort(gen.choice(groups, size=n, replace=False))


@dataclass
class Episode:
    index: int
    rounds: int
    metrics: Dict[str, torch.Tensor]      # the program's, on the device
    violations: torch.Tensor              # invariant violations, summed
    sampled: Dict[str, torch.Tensor]      # final planes of the sample
    counted: Dict[str, torch.Tensor]      # the command count's plane


@dataclass
class Window:
    episodes: List[Episode] = field(default_factory=list)
    marks: list = field(default_factory=list)    # one a round boundary
    seconds: float = 0.0

    @property
    def rounds(self) -> int:
        return sum(e.rounds for e in self.episodes)


class Clock:
    """Marks at round boundaries: CUDA events on the card (read after the
    window), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def gaps_ms(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def port_config(sim: Dict[str, Any]):
    """The port's ``SimConfig`` of a configuration's ``sim`` object: its
    ``workload`` object, if any, rebuilt as the port's ``Workload`` and
    checked against the key space."""
    from paxi_tpu_torch.sim import SimConfig
    from paxi_tpu_torch.workload import Workload, apply_workload

    wl = sim.get("workload")
    cfg = SimConfig(**dict(sim, workload=None))
    return apply_workload(cfg, None if wl is None else Workload.from_dict(wl))


class Program:
    """A cell's configuration and traffic as the port runs them."""

    def __init__(self, cell: cells.Cell, device, groups: Optional[int] = None):
        from paxi_tpu_torch.protocols import sim_protocol
        from paxi_tpu_torch.sim import FuzzConfig
        from paxi_tpu_torch.sim import runner

        self.cell = cell
        self.runner = runner
        self.proto = sim_protocol(cell.config["protocol"])
        self.cfg = port_config(cell.config["sim"])
        self.fuzz = FuzzConfig(**cell.traffic["fuzz"])
        self.groups = int(groups or cell.groups)
        self.rounds = cell.rounds
        self.device = torch.device(device)
        self.command = cell.config["commands"]
        self.ref = cells.reference(cell.config)
        # the reference imports nothing of the port: a workload stays the
        # plain dict of the configuration file
        self.geo = Geometry(**cell.config["sim"])

    def key(self, seed: int, episode: int) -> torch.Tensor:
        return torch.tensor(episode_words(seed, episode), dtype=torch.int64)

    def keys(self, seed: int, n: int) -> torch.Tensor:
        """The keys of episodes ``0..n-1`` on the device, made before the
        window (a copy from the host would wait for the device)."""
        return torch.stack([self.key(seed, e) for e in range(n)]).to(
            self.device)

    def run(self, keys: torch.Tensor, lanes: torch.Tensor, clock: Clock,
            seconds: Optional[float] = None, max_episodes: int = 1,
            rounds: Optional[int] = None, proto=None,
            first: int = 0) -> Window:
        """Episodes ``first, first + 1, ...`` (keys ``keys[first:]``) back
        to back until ``seconds`` have passed on the host clock (or
        ``max_episodes`` are done), each of ``rounds`` rounds (the
        configuration's run length unless given); the caller waits for the
        device.  ``proto`` stands in for the program's protocol (the
        traced run's wrapped one)."""
        rn, cfg, fuzz = self.runner, self.cfg, self.fuzz
        proto = self.proto if proto is None else proto
        body = rn.make_scan_body(proto, cfg, fuzz)
        win = Window()
        deadline = (None if seconds is None
                    else time.perf_counter() + seconds)

        def over() -> bool:
            return deadline is not None and time.perf_counter() >= deadline

        with torch.inference_mode():
            win.marks.append(clock.mark())
            for e in range(first, first + max_episodes):
                if e >= keys.shape[0]:
                    raise RuntimeError(f"the window ran past the {e} "
                                       "episode keys made for it")
                carry = rn.init_carry(proto, cfg, fuzz, self.groups,
                                      keys[e], self.device)
                viols = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
                counts = {rn.NET_PREFIX + k: torch.zeros_like(viols)
                          for k in rn.COUNTER_NAMES}
                t = 0
                while t < (rounds or self.rounds):
                    carry, (viol, c) = body(carry, t)
                    viols = viols + viol
                    counts = {k: v + c[k] for k, v in counts.items()}
                    t += 1
                    win.marks.append(clock.mark())
                    if over():
                        break
                win.episodes.append(self.finish(e, t, carry, viols, counts,
                                                lanes, proto))
                carry = None
                if over():
                    break
        return win

    def finish(self, e: int, rounds: int, carry, viols, counts,
               lanes: torch.Tensor, proto) -> Episode:
        state, metrics, viols = self.runner.finish_run(
            proto, self.cfg, carry, viols, counts)
        sampled = {k: v.index_select(0, lanes) for k, v in state.items()}
        plane = self.ref.COMMAND_PLANES[self.command]
        return Episode(e, rounds, metrics, viols, sampled,
                       {plane: carry[0][plane]})
