"""Sim-side on-device counters (torch twin of the JAX package's
``metrics/simcount.py``).

Every step contributes one int32 per counter, summed over the whole group
batch; the runner accumulates them on the device and folds the totals
into the run's metrics under the ``net_`` prefix.  The counts are pure
functions of (inbox, outbox, fault planes, fault masks): no PRNG draws.
"""

from __future__ import annotations

from typing import Dict

import torch

NET_PREFIX = "net_"

COUNTER_NAMES = ("msgs_sent", "msgs_delivered", "msgs_dropped",
                 "msgs_duplicated", "msgs_delayed", "delay_collisions",
                 "crash_steps", "cut_edge_steps")


def _tot(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=torch.int32)


def _tot_per_group(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.ndim)), dtype=torch.int32)


def step_counts(inbox, outbox, faults, fs, n: int, wheel_valid=None,
                per_group: bool = False) -> Dict[str, torch.Tensor]:
    """One lock-step round's counter increments.

    ``wheel_valid`` maps each message type to the post-delivery,
    pre-insert wheel's validity planes, slot axis first (``(d, src, dst,
    G)`` lane-major, ``(d, G, src, dst)`` per-group); a put onto an
    occupied cell overwrites an in-flight message (``delay_collisions``).
    A one-slot wheel is rotated empty before every insert, so it can have
    no collisions and is skipped, as in the reference.

    ``per_group=True`` takes a per-group kernel's planes (group axis
    leading, ``sim/mailbox_pg.py``) and returns each group's counts,
    ``(G,)`` int32 apiece, as the reference's vmapped call does."""
    # function-local: sim.runner imports this module, so a top-level
    # sim.mailbox import would cycle through the sim package __init__
    from paxi_tpu_torch.sim import mailbox as mb
    from paxi_tpu_torch.sim import mailbox_pg

    sample = next(iter(outbox.values()))["valid"]
    live = (mailbox_pg.live_mask(fs, n) if per_group
            else mb.live_mask(fs, n))
    tot = _tot_per_group if per_group else _tot
    zero = torch.zeros(sample.shape[:1] if per_group else (),
                       dtype=torch.int32, device=sample.device)

    sent = sum((tot(b["valid"]) for b in outbox.values()), zero)
    delivered = sum((tot(b["valid"]) for b in inbox.values()), zero)
    dropped = duplicated = delayed = collisions = zero
    for name in sorted(outbox.keys()):
        valid = outbox[name]["valid"] & live
        f = faults[name]
        dropped = dropped + tot(f["drop"] & valid)
        kept = valid & ~f["drop"]
        duplicated = duplicated + tot(f["dup"] & kept)
        delayed = delayed + tot((f["delay"] > 1) & kept)
        if wheel_valid is not None and wheel_valid[name].shape[0] > 1:
            d = wheel_valid[name].shape[0]
            dup_delay = torch.clamp(f["delay"] + 1, max=d)
            for slot in range(d):
                put = kept & ((f["delay"] == slot + 1)
                              | (f["dup"] & (dup_delay == slot + 1)))
                collisions = collisions + tot(
                    put & wheel_valid[name][slot])
    return {
        NET_PREFIX + "msgs_sent": sent,
        NET_PREFIX + "msgs_delivered": delivered,
        NET_PREFIX + "msgs_dropped": dropped,
        NET_PREFIX + "msgs_duplicated": duplicated,
        NET_PREFIX + "msgs_delayed": delayed,
        NET_PREFIX + "delay_collisions": collisions,
        NET_PREFIX + "crash_steps": tot(fs["crashed"]),
        NET_PREFIX + "cut_edge_steps": tot(~fs["conn"]),
    }


def counters_of(metrics: Dict) -> Dict:
    """The runner's counters out of a metrics dict, prefix removed."""
    return {k[len(NET_PREFIX):]: v for k, v in metrics.items()
            if k.startswith(NET_PREFIX)}
