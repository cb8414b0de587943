"""The message exchange and fault schedule of per-group kernels (torch twin
of the per-group form of the JAX package's ``paxi_tpu/sim/mailbox.py``).

A per-group kernel (``paxos_pg``) keeps the group axis LEADING, the layout
the reference's ``vmap`` over groups gives: mailbox planes ``(G, src,
dst)``, the timing wheel per message type ``{"valid": (G, d, src, dst)
bool, field: (G, d, src, dst) int32}`` (the reference's per-group wheel,
group axis first), the fault state ``conn (G, R, R)`` and ``crashed (G,
R)``.  Each group draws its faults from its own key, so every call here
takes a batch of keys ``(G, 2)`` and equals ``jax.vmap`` of the
reference's per-group call over it (``paxi_tpu_torch.random`` takes key
batches).

The reference runs this exchange as array code, never in a Pallas kernel
(only lane-major runs take the fused exchange), so this module is plain
torch tensor code on every device.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.scenarios.schedule import forced_crash
from paxi_tpu_torch.sim.types import FuzzConfig, Mailboxes, resolve_device

Wheel = Dict[str, Dict[str, torch.Tensor]]


def empty_wheel(spec: Dict[str, Tuple[str, ...]], n: int, g: int,
                fuzz: FuzzConfig, device=None) -> Wheel:
    """Zeroed timing wheel, slot ``s`` holding the messages that arrive in
    ``s + 1`` steps: per message type ``(G, d, src, dst)`` planes, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    shape = (g, fuzz.wheel, n, n)
    out = {}
    for name, fields in spec.items():
        box = {"valid": torch.zeros(shape, dtype=torch.bool, device=device)}
        for f in fields:
            box[f] = torch.zeros(shape, dtype=torch.int32, device=device)
        out[name] = box
    return out


def wheel_deliver(wheel: Wheel) -> Tuple[Mailboxes, Wheel]:
    """Pop slot 0 as this step's inbox; rotate the wheel forward, the last
    slot zeroed."""
    inbox, rolled = {}, {}
    for name, box in wheel.items():
        inbox[name] = {k: v[:, 0] for k, v in box.items()}
        rolled[name] = {k: torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])],
                                     dim=1)
                        for k, v in box.items()}
    return inbox, rolled


def fault_state_init(n: int, g: int, device=None) -> Dict[str, torch.Tensor]:
    """Connectivity + crash masks carried through the run, on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    device = resolve_device(device)
    return {
        "conn": torch.ones((g, n, n), dtype=torch.bool, device=device),
        "crashed": torch.zeros((g, n), dtype=torch.bool, device=device),
    }


def fault_state_refresh(fs, rngs, t: int, fuzz: FuzzConfig, n: int):
    """Resample each group's partition/crash schedule every
    ``fuzz.window`` steps from its key (``rngs (G, 2)``): a random
    bipartition cuts the edges across it, and each replica comms-crashes
    with ``p_crash``; ``perm_crash`` is held for good.  A step that keeps
    the old schedule forms no draws (their keys are used nowhere else).  A
    scenario's kills OR in every step (``scenarios/schedule.py``)."""
    scn = fuzz.scenario
    scn_kills = scn is not None and scn.kills_nodes()
    if not (fuzz.p_partition > 0 or fuzz.p_crash > 0
            or fuzz.perm_crash >= 0 or scn_kills):
        return fs
    new = dict(fs)
    if t % fuzz.window == 0:
        k = tr.split(rngs, 3)                              # (G, 3, 2)
        side = tr.bernoulli(k[:, 0], 0.5, (n,))            # (G, n)
        cut = tr.bernoulli(k[:, 1], fuzz.p_partition, ())  # (G,)
        new["conn"] = torch.where(cut[:, None, None],
                                  side[:, :, None] == side[:, None, :], True)
        new["crashed"] = tr.bernoulli(k[:, 2], fuzz.p_crash, (n,))
    if fuzz.perm_crash >= 0 and t >= fuzz.perm_crash_at:
        forced = (torch.arange(n, device=rngs.device) == fuzz.perm_crash)
        new["crashed"] = new["crashed"] | forced
    if scn_kills:
        # un-stick last step's overlay before OR-ing this step's, so churn
        # revivals happen
        dev = rngs.device
        new["crashed"] = ((new["crashed"] & ~forced_crash(scn, t - 1, n, dev))
                          | forced_crash(scn, t, n, dev))
    return new


@functools.lru_cache(maxsize=16)
def _delay_plane(scn, n: int, device) -> torch.Tensor:
    """A scenario's (1, src, dst) int32 latency plane on ``device``, built
    once."""
    from paxi_tpu_torch.scenarios.schedule import delay_base
    return torch.from_numpy(delay_base(scn, n)).to(device)[None]


def draw_edge_faults(rngs, outbox: Mailboxes, fuzz: FuzzConfig):
    """Each group's per-edge ``{"drop", "delay", "dup"}`` planes ``(G, src,
    dst)``, one triple per message type in sorted name order, from its
    key's ``split(key, 3 * len(names))`` (the reference's key structure).
    Under a scenario with zone latencies the delay is the zone matrix's
    per-edge latency plus a uniform 0..jitter draw, clipped to the wheel.
    When the schedule draws nothing the keys are not formed."""
    d = fuzz.wheel
    scn = fuzz.scenario
    geo = scn is not None and scn.zones is not None
    names = sorted(outbox.keys())
    draws = fuzz.p_drop > 0 or fuzz.p_dup > 0 or d > 1
    keys = tr.split(rngs, 3 * len(names)) if draws else None
    faults = {}
    for i, name in enumerate(names):
        valid = outbox[name]["valid"]
        shape, dev = tuple(valid.shape), valid.device
        edge = shape[1:]
        drop = (tr.bernoulli(keys[:, 3 * i], fuzz.p_drop, edge)
                if fuzz.p_drop > 0
                else torch.zeros(shape, dtype=torch.bool, device=dev))
        if geo:
            base = _delay_plane(scn, shape[1], dev)
            if scn.zones.jitter > 0:
                base = base + tr.randint(keys[:, 3 * i + 1], edge, 0,
                                         scn.zones.jitter + 1)
            delay = torch.clamp(base, 1, d).to(torch.int32) \
                .expand(shape).contiguous()
        elif d > 1:
            delay = tr.randint(keys[:, 3 * i + 1], edge, 1, d + 1)
        else:
            delay = torch.ones(shape, dtype=torch.int32, device=dev)
        dup = (tr.bernoulli(keys[:, 3 * i + 2], fuzz.p_dup, edge)
               if fuzz.p_dup > 0
               else torch.zeros(shape, dtype=torch.bool, device=dev))
        faults[name] = {"drop": drop, "delay": delay, "dup": dup}
    return faults


def live_mask(fs, n: int):
    """The delivery-validity predicate over ``(G, src, dst)`` planes: no
    self-edges, conn intact, both endpoints alive."""
    no_self = ~torch.eye(n, dtype=torch.bool, device=fs["conn"].device)
    alive = ~fs["crashed"][:, :, None] & ~fs["crashed"][:, None, :]
    return no_self & fs["conn"] & alive


def wheel_insert(wheel: Wheel, outbox: Mailboxes, fs, fuzz: FuzzConfig,
                 faults) -> Wheel:
    """Push this step's outbox into the wheel under the fault schedule
    ``faults`` (from ``draw_edge_faults``, or a recorded schedule): for
    each slot ``s`` a live, undropped send lands where its delay (or its
    duplicate's, one step later, clipped to the wheel) is ``s + 1``; it
    overwrites an undelivered message in that cell."""
    d = fuzz.wheel
    new_wheel = {}
    for name in sorted(outbox.keys()):
        box, wbox = outbox[name], wheel[name]
        n = box["valid"].shape[1]
        f = faults[name]
        valid = box["valid"] & live_mask(fs, n) & ~f["drop"]
        delay, dup = f["delay"], f["dup"]
        dup_delay = torch.clamp(delay + 1, max=d)
        puts = [valid & ((delay == s + 1) | (dup & (dup_delay == s + 1)))
                for s in range(d)]
        put = torch.stack(puts, dim=1)                    # (G, d, src, dst)
        out = {"valid": wbox["valid"] | put}
        for k, v in wbox.items():
            if k != "valid":
                out[k] = torch.where(put, box[k][:, None], v)
        new_wheel[name] = out
    return new_wheel
