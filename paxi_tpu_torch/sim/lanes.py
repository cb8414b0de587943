"""Lane-major (G-last) wheel and fault-state machinery (torch twin of the
JAX package's ``sim/lanes.py``).

The group axis is the LAST dimension everywhere: state ``(R, S, G)``,
mailbox planes ``(src, dst, G)``, wheel ``(delay, F, src, dst, G)``.  One
PRNG key per run gives every group an independent schedule through shaped
draws.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.scenarios.schedule import forced_crash
from paxi_tpu_torch.sim.mailbox import Wheel, WheelBox
from paxi_tpu_torch.sim.types import FuzzConfig, resolve_device


@functools.lru_cache(maxsize=64)
def iota(n: int, device) -> torch.Tensor:
    """``arange(n)`` as int32 on ``device``, built once a size and device
    (a normal tensor, so a step may use it in and out of inference
    mode)."""
    with torch.inference_mode(False):
        return torch.arange(n, dtype=torch.int32, device=device)


def i32sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.sum`` over ``dim`` (every axis when None) in int32, as the
    reference sums (torch sums int32 and bool to int64)."""
    if dim is None:
        return torch.sum(x, dtype=torch.int32)
    return torch.sum(x, dim=dim, dtype=torch.int32)


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """int32 sum over every axis but the trailing group axis: ``(G,)``."""
    if x.ndim == 1:
        return x.to(torch.int32)
    return torch.sum(x, dim=tuple(range(x.ndim - 1)), dtype=torch.int32)


def empty_wheel(spec: Dict[str, Tuple[str, ...]], n: int, g: int,
                fuzz: FuzzConfig, device=None) -> Wheel:
    """Zeroed timing wheel: per message type a stacked
    ``(d, 1 + F, src, dst, G)`` int32 block, on ``device`` (the card
    unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    return {name: WheelBox(tuple(fields),
                           torch.zeros((fuzz.wheel, 1 + len(fields), n, n, g),
                                       dtype=torch.int32, device=device))
            for name, fields in spec.items()}


def fault_state_init(n: int, g: int, device=None) -> Dict[str, torch.Tensor]:
    """Connectivity + crash masks carried through the run, on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    return {
        "conn": torch.ones((n, n, g), dtype=torch.bool, device=device),
        "crashed": torch.zeros((n, g), dtype=torch.bool, device=device),
    }


def fault_state_refresh(fs, rng, t: int, fuzz: FuzzConfig, n: int):
    """Resample the partition/crash schedule every ``fuzz.window`` steps:
    a random bipartition cuts the edges across it, and each replica
    comms-crashes with ``p_crash``; ``perm_crash`` is held for good.  The
    draws of a step that keeps the old schedule are not formed (their key
    is used nowhere else).  A scenario's churn/outage/reconfig kills OR in
    every step, the same for every group (``scenarios/schedule.py``)."""
    scn = fuzz.scenario
    scn_kills = scn is not None and scn.kills_nodes()
    if not (fuzz.p_partition > 0 or fuzz.p_crash > 0
            or fuzz.perm_crash >= 0 or scn_kills):
        return fs
    new = dict(fs)
    if t % fuzz.window == 0:
        g = fs["crashed"].shape[-1]
        k = tr.split(rng, 3)
        side = tr.bernoulli(k[0], 0.5, (n, g))
        cut = tr.bernoulli(k[1], fuzz.p_partition, (g,))
        new["conn"] = torch.where(cut[None, None, :],
                                  side[:, None, :] == side[None, :, :], True)
        new["crashed"] = tr.bernoulli(k[2], fuzz.p_crash, (n, g))
    if fuzz.perm_crash >= 0 and t >= fuzz.perm_crash_at:
        forced = (torch.arange(n, device=rng.device)[:, None]
                  == fuzz.perm_crash)
        new["crashed"] = new["crashed"] | forced
    if scn_kills:
        # the carried plane holds last step's overlay: un-stick it before
        # OR-ing this step's, so churn revivals happen (a window-drawn
        # crash that coincides with a scenario kill revives with it)
        dev = rng.device
        new["crashed"] = (
            (new["crashed"] & ~forced_crash(scn, t - 1, n, dev)[:, None])
            | forced_crash(scn, t, n, dev)[:, None])
    return new
