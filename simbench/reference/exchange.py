"""The plain message exchange, fault schedule and exchange counters (frozen
copies of the port's ``sim/mailbox.py`` plain versions, ``sim/lanes.py``
without scenarios, and ``metrics/simcount.py`` per group).

Per message type a stacked int32 timing wheel ``(d, F, src, dst, G)``,
validity first; slot ``s`` holds what arrives in ``s + 1`` rounds.  A new
message overwrites an undelivered one in the same cell.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from simbench.reference import prng as tr
from simbench.reference.common import Faults, group_sum

# the exchange's counters, as the port's runner names them (``net_``)
COUNTER_NAMES = ("msgs_sent", "msgs_delivered", "msgs_dropped",
                 "msgs_duplicated", "msgs_delayed", "delay_collisions",
                 "crash_steps", "cut_edge_steps")


class WheelBox(NamedTuple):
    fields: Tuple[str, ...]   # plane i + 1 holds field i; plane 0 is valid
    planes: torch.Tensor      # (d, 1 + len(fields), src, dst, G) int32


def empty_wheel(spec: Dict[str, Tuple[str, ...]], n: int, g: int,
                faults: Faults, device) -> Dict[str, WheelBox]:
    return {name: WheelBox(tuple(fields),
                           torch.zeros((faults.wheel, 1 + len(fields), n, n,
                                        g), dtype=torch.int32,
                                       device=device))
            for name, fields in spec.items()}


def fault_state_init(n: int, g: int, device) -> Dict[str, torch.Tensor]:
    return {"conn": torch.ones((n, n, g), dtype=torch.bool, device=device),
            "crashed": torch.zeros((n, g), dtype=torch.bool, device=device)}


def fault_state_refresh(fs, rng, t: int, faults: Faults, n: int):
    """Every ``window`` rounds a random bipartition cuts the edges across
    it (with ``p_partition``) and each replica comms-crashes with
    ``p_crash``; nothing is drawn when both are 0."""
    if not (faults.p_partition > 0 or faults.p_crash > 0):
        return fs
    new = dict(fs)
    if t % faults.window == 0:
        g = fs["crashed"].shape[-1]
        k = tr.split(rng, 3)
        side = tr.bernoulli(k[0], 0.5, (n, g))
        cut = tr.bernoulli(k[1], faults.p_partition, (g,))
        new["conn"] = torch.where(cut[None, None, :],
                                  side[:, None, :] == side[None, :, :], True)
        new["crashed"] = tr.bernoulli(k[2], faults.p_crash, (n, g))
    return new


def stack_box(box, fields):
    planes = [box["valid"].to(torch.int32)] + [box[f] for f in fields]
    return torch.stack(planes, dim=-4)


def unstack_box(planes, fields):
    out = {"valid": planes[..., 0, :, :, :] != 0}
    for i, f in enumerate(fields):
        out[f] = planes[..., i + 1, :, :, :]
    return out


def wheel_deliver(wheel):
    """Pop slot 0 as this round's inbox; rotate the wheel one slot."""
    inbox, rolled = {}, {}
    for name, box in wheel.items():
        w = box.planes
        inbox[name] = unstack_box(w[0].clone(), box.fields)
        rolled[name] = WheelBox(
            box.fields, torch.cat([w[1:], torch.zeros_like(w[:1])], dim=0))
    return inbox, rolled


def live_mask(fs, n: int):
    """No self-edges, connectivity intact, both endpoints alive."""
    no_self = ~torch.eye(n, dtype=torch.bool,
                         device=fs["conn"].device)[:, :, None]
    alive = ~fs["crashed"][:, None, :] & ~fs["crashed"][None, :, :]
    return no_self & fs["conn"] & alive


def insert_planes(w, ob, eff, delay, dup):
    d = w.shape[0]
    dup_delay = torch.clamp(delay + 1, max=d)
    out = []
    for s in range(d):
        put = eff & ((delay == s + 1) | (dup & (dup_delay == s + 1)))
        valid = ((w[s, 0] != 0) | put).to(torch.int32)
        fields = torch.where(put, ob[1:], w[s, 1:])
        out.append(torch.cat([valid[None], fields], dim=0))
    return torch.stack(out)


def wheel_insert(wheel, outbox, fs, faults):
    """Push this round's outbox into the wheel under the drawn faults."""
    new_wheel = {}
    for name in sorted(outbox.keys()):
        box, wbox = outbox[name], wheel[name]
        n = box["valid"].shape[0]
        f = faults[name]
        eff = box["valid"] & live_mask(fs, n) & ~f["drop"]
        ob = stack_box(box, wbox.fields)
        new_wheel[name] = WheelBox(
            wbox.fields,
            insert_planes(wbox.planes, ob, eff, f["delay"], f["dup"]))
    return new_wheel


def draw_edge_faults(rng, outbox, faults: Faults):
    """Per message type, in sorted name order, the ``drop``, ``delay`` and
    ``dup`` planes from ``split(rng, 3 * types)``; nothing is drawn when
    the schedule is fault-free."""
    d = faults.wheel
    names = sorted(outbox.keys())
    draws = faults.p_drop > 0 or faults.p_dup > 0 or d > 1
    keys = tr.split(rng, 3 * len(names)) if draws else None
    out = {}
    for i, name in enumerate(names):
        valid = outbox[name]["valid"]
        shape, dev = tuple(valid.shape), valid.device
        drop = (tr.bernoulli(keys[3 * i], faults.p_drop, shape)
                if faults.p_drop > 0
                else torch.zeros(shape, dtype=torch.bool, device=dev))
        delay = (tr.randint(keys[3 * i + 1], shape, 1, d + 1) if d > 1
                 else torch.ones(shape, dtype=torch.int32, device=dev))
        dup = (tr.bernoulli(keys[3 * i + 2], faults.p_dup, shape)
               if faults.p_dup > 0
               else torch.zeros(shape, dtype=torch.bool, device=dev))
        out[name] = {"drop": drop, "delay": delay, "dup": dup}
    return out


def step_counts(inbox, outbox, faults, fs, n: int, wheel=None):
    """One round's counter increments for each group, ``(G,)`` int32
    apiece: messages sent (a type's plane counted at the shape the step
    made it), delivered, dropped on a live edge, duplicated and delayed of
    those kept, puts onto a cell of ``wheel`` (the wheel after delivery,
    before the insert) that still holds a message, and the round's
    crashed replicas and cut edges.  A one-slot wheel is empty before
    every insert and is not read."""
    live = live_mask(fs, n)
    sent = sum(group_sum(b["valid"]) for b in outbox.values())
    delivered = sum(group_sum(b["valid"]) for b in inbox.values())
    dropped = duplicated = delayed = collisions = 0
    for name in sorted(outbox.keys()):
        valid = outbox[name]["valid"] & live
        f = faults[name]
        dropped = dropped + group_sum(f["drop"] & valid)
        kept = valid & ~f["drop"]
        duplicated = duplicated + group_sum(f["dup"] & kept)
        delayed = delayed + group_sum((f["delay"] > 1) & kept)
        d = wheel[name].planes.shape[0] if wheel is not None else 1
        if d > 1:
            occupied = wheel[name].planes[:, 0] != 0
            dup_delay = torch.clamp(f["delay"] + 1, max=d)
            for s in range(d):
                put = kept & ((f["delay"] == s + 1)
                              | (f["dup"] & (dup_delay == s + 1)))
                collisions = collisions + group_sum(put & occupied[s])
    g = live.shape[-1]

    def plane(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.int32,
                                                  device=live.device), (g,))
    return dict(zip(COUNTER_NAMES, map(plane, (
        sent, delivered, dropped, duplicated, delayed, collisions,
        group_sum(fs["crashed"]), group_sum(~fs["conn"])))))
