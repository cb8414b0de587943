"""Host twin of the ``relay_churn`` demo kernel (scenarios/demo.py).

The same deliberately churn-sensitive sequence relay on the asyncio
runtime, with the SAME two seeded bugs (counter drift while
comms-dead, takeover off-by-one skip), so a sim churn witness MUST
classify ``reproduced`` when the virtual-clock fabric replays its
recorded crash plane — the scenario engine's end-to-end positive
control, exactly as ``fragile_counter`` is for drop schedules.

NOT a real protocol: it serves no client requests (the hunt classifier
reads its ``HUNT_ORACLE`` instead of a linearizability history).
"""

from __future__ import annotations

from dataclasses import dataclass

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

# matches SimConfig.election_timeout's default — the hunt case
# (hunt/cases.py DEMO_CASES) runs the sim twin at that default, and
# the rank-staggered takeover thresholds must agree across runtimes
TIMEOUT = 8


@register_message
@dataclass
class Seq:
    """The broadcast sequence number (sim mailbox ``seq``, field v)."""

    v: int


class RelayReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.last = 0       # highest seq applied (sim state "last")
        self.silence = 0    # steps since a seq (sim state "silence")
        self.gaps = 0       # ordering violations (sim state "gaps")
        self.rank = sorted(cfg.ids).index(id)
        self._got = False
        self.register(Seq, self.handle_seq)

    def handle_seq(self, m: Seq) -> None:
        if m.v > self.last + 1:
            self.gaps += 1
        self.last = max(self.last, m.v)
        self._got = True

    def tick(self, t: int) -> None:
        """One lock-step round (sim step() mirrored): deliveries have
        already landed this fabric step, so settle the silence counter,
        then broadcast if my rank-staggered timeout has expired —
        skipping one sequence number on the FIRST takeover broadcast
        (the seeded handoff bug).  The broadcaster advances its own
        counter unconditionally (the drift bug: a fabric-crashed node
        keeps ticking, exactly like the sim kernel whose sends are
        masked but whose state keeps running)."""
        del t
        self.silence = 0 if self._got else self.silence + 1
        self._got = False
        thr = TIMEOUT * self.rank
        if self.silence >= thr:
            self.last += 2 if (self.rank > 0
                               and self.silence == thr) else 1
            self.socket.broadcast(Seq(v=self.last))


def new_replica(id: ID, cfg: Config) -> RelayReplica:
    return RelayReplica(id, cfg)


# sim mailbox -> host message class (total: the one mailbox maps)
TRACE_MSG_MAP = {"seq": "Seq"}


# ---- hunt-engine hooks (hunt/classify.py) -------------------------------
def HUNT_DRIVER(cluster, fabric) -> None:
    """Every replica ticks per logical step (takeover logic needs the
    whole cluster on the clock, unlike fragile_counter's single
    broadcaster)."""
    for i in cluster.ids:
        fabric.on_step(lambda t, i=i: cluster[i].tick(t))


def HUNT_ORACLE(cluster) -> int:
    """Safety-violation count after a replay (sim: the ``gaps``
    invariant counter summed over replicas)."""
    return sum(cluster[i].gaps for i in cluster.ids)
