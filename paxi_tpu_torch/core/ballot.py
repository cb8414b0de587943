"""Ballot numbers.

Reference: paxi's ballot (paxos/ballot.go or paxos.go) packs
``n << 16 | leaderID`` into one integer so ballots order primarily by
round and tie-break by leader [med].  Same idea here with a wider,
range-checked leader half (zone and node get 12 bits each) so large
cluster ids cannot silently corrupt leader identity.
"""

from __future__ import annotations

from paxi_tpu_torch.core.ident import ID, new_id

_BITS = 12
_MASK = (1 << _BITS) - 1


def ballot(n: int, id: ID) -> int:
    i = ID(id)
    if not (0 < i.zone <= _MASK and 0 < i.node <= _MASK):
        raise ValueError(f"id {i} out of ballot range (1..{_MASK})")
    return (n << (2 * _BITS)) | (i.zone << _BITS) | i.node


def ballot_n(b: int) -> int:
    return b >> (2 * _BITS)


def ballot_id(b: int) -> ID:
    return new_id((b >> _BITS) & _MASK, b & _MASK)


def next_ballot(b: int, id: ID) -> int:
    """Smallest ballot owned by ``id`` greater than ``b``."""
    return ballot(ballot_n(b) + 1, id)
