"""Host twin of the ``switchpaxos_nogap`` seeded-bug sim kernel.

The same deliberately UNSAFE ordered-multicast shortcut on the asyncio
runtime: on a detected sequence gap the replica SKIPS gap agreement
and unilaterally NOOP-commits the holes below the arriving frame —
holes the leader meanwhile commits real batches into, so a drop
schedule deterministically diverges committed values across replicas
(``HUNT_ORACLE`` counts the disagreement).  Because the sim twin and
this replica share the bug, a sim witness replayed through the
virtual-clock fabric + switch tier MUST classify ``reproduced`` — the
in-fabric tier's end-to-end hunt control.

NOT a correctness case: never add it to the fuzz-soak oracle matrix.
"""

from __future__ import annotations

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.protocols.paxos.host import Entry
from paxi_tpu_torch.protocols.switchpaxos.host import (  # noqa: F401
    HUNT_FABRIC_SETUP, HUNT_ORACLE, HUNT_TAIL_STEPS, SIM_STATE_MAP,
    TRACE_MSG_MAP, OmP2a, SwitchPaxosReplica)

# paxi-lint (analysis/tracemap.py): analyze this module AS its base —
# the message classes, maps and state vocabulary all live in host.py
TWIN_OF = "paxi_tpu_torch.protocols.switchpaxos.host"


class NoGapReplica(SwitchPaxosReplica):
    def _on_gap(self, m: OmP2a) -> None:
        """The seeded bug: "the multicast is ordered, so a gap must be
        a NOOP" — commit the holes instead of asking for retransmits."""
        self.gap_events += 1
        for s in range(self.execute, m.slot):
            if s not in self.log:
                self.log[s] = Entry(m.ballot, [], commit=True)
        self._exec()


def new_replica(id: ID, cfg: Config) -> NoGapReplica:
    return NoGapReplica(ID(id), cfg)
