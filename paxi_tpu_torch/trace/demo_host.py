"""Host twin of the ``fragile_counter`` demo kernel (trace/demo.py).

The same deliberately UNSAFE protocol on the asyncio runtime: the
lowest-ID replica broadcasts a sequence number every logical step (a
virtual-clock fabric driver — see ``HUNT_DRIVER``), receivers require
strict in-order delivery and count a violation on every gap.  Because
the two implementations are behaviorally identical, a sim witness
(one dropped or reordered ``seq``) MUST reproduce on the host when the
fabric replays it — making this the hunt subsystem's end-to-end
``reproduced`` fixture, and any classification other than
``reproduced`` on a fragile witness a bug in the pipeline itself.

NOT a real protocol: it serves no client requests (the hunt classifier
reads its ``HUNT_ORACLE`` instead of a linearizability history).
"""

from __future__ import annotations

from dataclasses import dataclass

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


@register_message
@dataclass
class Seq:
    """The broadcast sequence number (sim mailbox ``seq``, field v)."""

    v: int


class FragileReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.last = 0      # highest seq applied (sim state "last")
        self.gaps = 0      # out-of-order deliveries (sim state "gaps")
        self._next = 0     # broadcaster's own sequence counter
        self.register(Seq, self.handle_seq)

    def handle_seq(self, m: Seq) -> None:
        if m.v > self.last + 1:
            self.gaps += 1
        self.last = max(self.last, m.v)

    def tick(self, t: int) -> None:
        """Per-step driver (sim: replica 0 broadcasts one fresh
        sequence number per lock-step round); only the lowest-ID
        replica ticks.  Sequenced off an own counter, not ``t`` —
        fabric drivers must tolerate clock jumps (the drain phase can
        advance the logical clock past the driven window)."""
        del t
        self._next += 1
        self.socket.broadcast(Seq(v=self._next))


def new_replica(id: ID, cfg: Config) -> FragileReplica:
    return FragileReplica(id, cfg)


# sim mailbox -> host message class (total: the one mailbox maps)
TRACE_MSG_MAP = {"seq": "Seq"}


# ---- hunt-engine hooks (hunt/classify.py) ----------------------
def HUNT_DRIVER(cluster, fabric) -> None:
    """Wire the broadcaster to the fabric's logical clock — the host
    analog of the sim kernel emitting one broadcast per lock-step
    round."""
    first = sorted(cluster.ids)[0]
    fabric.on_step(lambda t: cluster[first].tick(t))


def HUNT_ORACLE(cluster) -> int:
    """Safety-violation count after a replay (sim: the ``gaps``
    invariant counter summed over replicas)."""
    return sum(cluster[i].gaps for i in cluster.ids)
