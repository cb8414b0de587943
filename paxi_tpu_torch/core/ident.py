"""Node identifiers.

Reference: paxi id.go (``type ID string`` with "zone.node" format,
``Zone()``, ``Node()``, ``NewID``).  Zone-awareness is the basis for
WAN quorums and ``Multicast(zone)``.
"""

from __future__ import annotations

import functools


@functools.total_ordering
class ID(str):
    """A node identifier of the form ``"zone.node"`` (both 1-based ints).

    Subclasses ``str`` so it round-trips through JSON config keys exactly
    like the reference's ``type ID string``.
    """

    __slots__ = ()

    def __new__(cls, value: "str | ID"):
        s = str(value)
        if "." not in s:
            # tolerate bare node numbers: zone defaults to 1
            s = f"1.{s}"
        inst = super().__new__(cls, s)
        inst.zone, inst.node  # validate eagerly
        return inst

    @property
    def zone(self) -> int:
        return int(self.split(".", 1)[0])

    @property
    def node(self) -> int:
        return int(self.split(".", 1)[1])

    def __lt__(self, other) -> bool:  # numeric (zone, node) order, not lexical
        o = ID(other)
        return (self.zone, self.node) < (o.zone, o.node)

    def __eq__(self, other) -> bool:
        return str(self) == str(other)

    def __hash__(self) -> int:
        return str.__hash__(self)


def new_id(zone: int, node: int) -> ID:
    """Reference: id.go NewID(zone, node)."""
    return ID(f"{zone}.{node}")
