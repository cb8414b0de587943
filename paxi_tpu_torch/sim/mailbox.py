"""Dense lock-step message exchange with a randomized fault schedule
(torch twin of the JAX package's ``sim/mailbox.py``, lane-major form).

Per message type there is one ``(src, dst, G)`` plane per int32 field plus
a validity mask; in-flight messages live in a timing wheel, slot ``s``
holding the messages that arrive in ``s + 1`` steps.  A newly sent message
overwrites an undelivered one in the same wheel cell (extra loss, counted
as ``delay_collisions``).

The wheel is scan carry, never public state, so it is stored the way the
exchange kernels (``ops/exchange.py``) read it: per message type one
stacked int32 block ``(d, F, src, dst, G)``, validity first as 0/1, then
the fields (a ``WheelBox``).  ``wheel_deliver`` and ``wheel_insert``
below (one type at a time through ``deliver_planes`` and
``insert_planes``) are the plain versions of the two kernels, which take
every type of a step in one launch: the CPU path runs them, and the card
path is held against them.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.sim.types import FuzzConfig, Mailboxes


class WheelBox(NamedTuple):
    """One message type's stacked timing-wheel planes."""

    fields: Tuple[str, ...]   # plane i + 1 holds field i; plane 0 is valid
    planes: torch.Tensor      # (d, 1 + len(fields), src, dst, G) int32


Wheel = Dict[str, WheelBox]


def stack_box(box: Dict[str, torch.Tensor],
              fields: Tuple[str, ...]) -> torch.Tensor:
    """{valid, *fields} planes -> one int32 block, valid first."""
    planes = [box["valid"].to(torch.int32)] + [box[f] for f in fields]
    return torch.stack(planes, dim=-4)


def unstack_box(planes: torch.Tensor,
                fields: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_box`` (fields are views of ``planes``)."""
    out = {"valid": planes[..., 0, :, :, :] != 0}
    for i, f in enumerate(fields):
        out[f] = planes[..., i + 1, :, :, :]
    return out


# ---- the plain versions of the two exchange kernels ---------------------

def deliver_planes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pop slot 0 of a stacked wheel ``(d, F, R, R, G)`` as the inbox
    ``(F, R, R, G)``; return it with the wheel rotated forward one slot,
    the last slot zeroed."""
    rolled = torch.cat([w[1:], torch.zeros_like(w[:1])], dim=0)
    return w[0].clone(), rolled


def insert_planes(w: torch.Tensor, ob: torch.Tensor, eff: torch.Tensor,
                  delay: torch.Tensor, dup: torch.Tensor) -> torch.Tensor:
    """Push a stacked outbox ``ob (F, R, R, G)`` into the stacked wheel
    ``w (d, F, R, R, G)``: for each slot ``s``, ``put = eff & (delay ==
    s+1 | dup & min(delay+1, d) == s+1)``; the valid plane ORs ``put`` in
    and every field takes the outbox value where ``put``.  ``eff``/``dup``
    are bool and ``delay`` int32, all ``(R, R, G)``."""
    d = w.shape[0]
    dup_delay = torch.clamp(delay + 1, max=d)
    out = []
    for s in range(d):
        put = eff & ((delay == s + 1) | (dup & (dup_delay == s + 1)))
        valid = ((w[s, 0] != 0) | put).to(torch.int32)
        fields = torch.where(put, ob[1:], w[s, 1:])
        out.append(torch.cat([valid[None], fields], dim=0))
    return torch.stack(out)


# ---- the exchange over a whole wheel ------------------------------------

def wheel_deliver(wheel: Wheel) -> Tuple[Mailboxes, Wheel]:
    """Pop slot 0 as this step's inbox; rotate the wheel forward (the
    plain version of ``ops/exchange.py``'s deliver kernel)."""
    inbox, rolled = {}, {}
    for name, box in wheel.items():
        ib, rw = deliver_planes(box.planes)
        inbox[name] = unstack_box(ib, box.fields)
        rolled[name] = WheelBox(box.fields, rw)
    return inbox, rolled


def live_mask(fs, n: int):
    """The delivery-validity predicate over lane-major ``(src, dst, G)``
    planes: no self-edges, conn intact, both endpoints alive."""
    no_self = ~torch.eye(n, dtype=torch.bool,
                         device=fs["conn"].device)[:, :, None]
    alive = ~fs["crashed"][:, None, :] & ~fs["crashed"][None, :, :]
    return no_self & fs["conn"] & alive


def wheel_insert(wheel: Wheel, outbox: Mailboxes, fs, faults) -> Wheel:
    """Push this step's outbox into the wheel under the fault schedule
    ``faults`` (from ``draw_edge_faults``): the plain version of
    ``ops/exchange.py``'s insert kernel, which forms ``eff`` itself and
    reads the outbox planes where they lie."""
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


def full_edges(outbox: Mailboxes, faults, groups: int):
    """Every type's validity and fault planes at the full ``(src, dst, G)``
    edge shape.  A validity plane that is the same for every group
    (``(src, dst, 1)``: chain's ack) has its faults drawn at its own
    shape, as in the reference; here it and its fault planes become
    planes of their own over the groups (the exchange kernels read groups
    at stride 1).  Other types pass through untouched."""
    narrow = [n for n, box in outbox.items()
              if box["valid"].shape[-1] != groups]
    if not narrow:
        return outbox, faults
    outbox, faults = dict(outbox), dict(faults)
    for name in narrow:
        box_shape = outbox[name]["valid"].shape[:-1] + (groups,)
        outbox[name] = dict(outbox[name], valid=outbox[name]["valid"]
                            .expand(box_shape).contiguous())
        faults[name] = {k: v.expand(box_shape).contiguous()
                        for k, v in faults[name].items()}
    return outbox, faults


@functools.lru_cache(maxsize=16)
def _delay_plane(scn, n: int, device) -> torch.Tensor:
    """A scenario's (src, dst, 1) int32 latency plane on ``device``, built
    once (a copy to the card each step would wait for the card)."""
    from paxi_tpu_torch.scenarios.schedule import delay_base
    return torch.from_numpy(delay_base(scn, n)).to(device)[:, :, None]


def draw_edge_faults(rng, outbox: Mailboxes, fuzz: FuzzConfig):
    """Draw the per-edge ``{"drop", "delay", "dup"}`` planes wheel_insert
    consumes, one triple per message type in sorted name order, from
    ``split(rng, 3 * len(names))`` — the reference's key structure.  Under
    a scenario with zone latencies the delay is the zone matrix's per-edge
    latency plus a uniform 0..jitter draw, clipped to the wheel.  When the
    schedule draws nothing the keys are not formed."""
    d = fuzz.wheel
    scn = fuzz.scenario
    geo = scn is not None and scn.zones is not None
    names = sorted(outbox.keys())
    draws = fuzz.p_drop > 0 or fuzz.p_dup > 0 or d > 1
    keys = tr.split(rng, 3 * len(names)) if draws else None
    faults = {}
    for i, name in enumerate(names):
        valid = outbox[name]["valid"]
        shape, dev = tuple(valid.shape), valid.device
        drop = (tr.bernoulli(keys[3 * i], fuzz.p_drop, shape)
                if fuzz.p_drop > 0
                else torch.zeros(shape, dtype=torch.bool, device=dev))
        if geo:
            base = _delay_plane(scn, shape[0], dev)
            if scn.zones.jitter > 0:
                base = base + tr.randint(keys[3 * i + 1], shape, 0,
                                         scn.zones.jitter + 1)
            delay = torch.clamp(base, 1, d).to(torch.int32) \
                .expand(shape).contiguous()
        elif d > 1:
            delay = tr.randint(keys[3 * i + 1], shape, 1, d + 1)
        else:
            delay = torch.ones(shape, dtype=torch.int32, device=dev)
        dup = (tr.bernoulli(keys[3 * i + 2], fuzz.p_dup, shape)
               if fuzz.p_dup > 0
               else torch.zeros(shape, dtype=torch.bool, device=dev))
        faults[name] = {"drop": drop, "delay": delay, "dup": dup}
    return faults
