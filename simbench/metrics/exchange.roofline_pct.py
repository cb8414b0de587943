"""The exchange kernels' share of their roofline: the least time the card
could take to move the bytes the exchange's semantics need, at 3.35 TB/s,
over the deliver and insert kernels' summed device time, per round.

The bytes, per message type of ``F`` planes (validity and ``F - 1`` int32
fields) on ``E = R * R * G`` edges, each input read once and each output
written once, validity one byte:

- deliver: the arriving slot read (``E + 4 (F - 1) E``) and the inbox
  written (the same);
- insert: the outbox read (``E + 4 (F - 1) E``), its fault planes read
  (drop and dup one byte, delay four: ``6 E``), and each message written
  into its one delay slot (``E + 4 (F - 1) E``);
- once a round, the connectivity (``E``) and crash (``R * G``) masks.

Moving the other slots of a deeper wheel along is not counted: it is the
layout's cost, not the exchange's (``layout_bytes`` counts it, the bytes
today's kernels move)."""

from simbench.peaks import HBM_BYTES_PER_S


def needed_bytes(spec, replicas: int, groups: int) -> int:
    """Bytes one round's exchange needs (see the module's docstring)."""
    E = replicas * replicas * groups
    total = E + replicas * groups
    for fields in spec.values():
        msg = E + 4 * len(fields) * E
        total += 2 * msg                 # deliver: slot read, inbox written
        total += 2 * msg + 6 * E         # insert: outbox and faults read,
    return total                         # one slot written


def layout_bytes(spec, d: int, replicas: int, groups: int) -> int:
    """Bytes today's kernels move a round with a ``d``-slot wheel of int32
    planes: every slot read and written by each half."""
    E = replicas * replicas * groups
    deliver = insert = 0
    for fields in spec.values():
        F = 1 + len(fields)
        deliver += d * F * E * 4 + E + (F - 1) * E * 4 + d * F * E * 4
        insert += d * F * E * 4 + (F - 1) * E * 4 + 7 * E + d * F * E * 4
    return deliver + insert + E + replicas * groups


def read(r):
    us, _ = r.kernel_us("deliver_kernel", "insert_kernel")
    if us <= 0 or r.rounds <= 0:
        return None
    s = r.shapes
    least_s = (needed_bytes(s["spec"], s["replicas"], s["groups"])
               * r.rounds / HBM_BYTES_PER_S)
    return 100.0 * least_s / (us / 1e6)
