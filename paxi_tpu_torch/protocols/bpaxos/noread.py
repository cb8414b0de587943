"""Host twin of the ``bpaxos_noread`` seeded-bug sim kernel.

The same deliberately UNSAFE recovery on the asyncio runtime: takeover
skips the grid's column read and blind-writes NOOP at a higher ballot
(``RECOVERY_READS = False`` in host.py), so a recovered slot can
overwrite an already-chosen batch — exactly the mistake the
row x column intersection (and paxi-lint's PXQ rowcol proof) exists to
prevent.  Because the sim twin and this replica share the bug, a sim
witness replayed through the virtual-clock fabric MUST reproduce on
the host (``HUNT_ORACLE`` counts the commit divergence), making this
the hunt pipeline's end-to-end ``reproduced`` control for a real
protocol (trace/demo_host.py covers the demo kernel).

NOT a correctness case: never add it to the fuzz-soak oracle matrix.
"""

from __future__ import annotations

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.protocols.bpaxos.host import (  # noqa: F401  (re-exports
    HUNT_ORACLE, HUNT_TAIL_STEPS, SIM_STATE_MAP, TRACE_MSG_MAP,
    BPaxosReplica)

# paxi-lint (analysis/tracemap.py): analyze this module AS its base —
# the message classes, maps and state vocabulary all live in host.py
TWIN_OF = "paxi_tpu_torch.protocols.bpaxos.host"


class NoReadReplica(BPaxosReplica):
    RECOVERY_READS = False


def new_replica(id: ID, cfg: Config) -> NoReadReplica:
    return NoReadReplica(ID(id), cfg)
