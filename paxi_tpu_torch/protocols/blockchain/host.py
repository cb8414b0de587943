"""Blockchain (longest-chain toy) replica for the host runtime.

Reference: the paxi lineage's blockchain/ package (SURVEY §2.2 "others")
— the probabilistic contrast case: miners extend the longest chain they
know, blocks gossip, forks resolve by length.  Client commands ride in
blocks and are acknowledged once their block is buried ``CONFIRM``
deep on the adopted chain — eventual, not immediate, commitment (the
benchmark's linearizability checker is EXPECTED to be able to catch
this protocol under contention; that is the point of the contrast).

Host form: real block objects with parent links (the sim kernel keeps
hash chains by reference instead); a missing parent triggers an
ancestor fetch; adoption replays the chain into the KV store (reorgs
rebuild — chains in the test workloads are short).
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

GENESIS = "genesis"
CONFIRM = 1          # blocks of burial before a command is acknowledged


@register_message
@dataclass
class BlockMsg:
    id: str
    parent: str
    height: int
    miner: str
    # [[key, value, client_id, command_id], ...]
    txs: List[list] = field(default_factory=list)


@register_message
@dataclass
class BlockReq:
    """Fetch a missing ancestor."""

    id: str
    asker: str


class BlockchainReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.blocks: Dict[str, BlockMsg] = {
            GENESIS: BlockMsg(GENESIS, "", 0, "")}
        self.orphans: Dict[str, List[BlockMsg]] = {}
        self.head = GENESIS
        self.mempool: List[Tuple[Command, Optional[Request]]] = []
        self.replied: set = set()
        self.inchain: set = set()   # (cid, cmid) on my adopted chain
        self.rng = random.Random(str(self.id))
        self.register(Request, self.handle_request)
        self.register(BlockMsg, self.handle_block)
        self.register(BlockReq, self.handle_blockreq)

    async def start(self) -> None:
        await super().start()
        self._tasks.append(asyncio.create_task(self._miner()))

    async def _miner(self) -> None:
        """Mining lottery: n replicas x p=1/(2n) per 0.02s tick =
        expected one block per ~0.04s cluster-wide."""
        try:
            while True:
                await asyncio.sleep(0.02)
                if self.rng.random() < 1.0 / (2 * self.cfg.n):
                    self._mine()
        except asyncio.CancelledError:
            pass

    # ---- chain bookkeeping ---------------------------------------------
    def _height(self, bid: str) -> int:
        return self.blocks[bid].height

    def _mine(self) -> None:
        parent = self.head
        h = self._height(parent) + 1
        bid = f"{self.id}:{h}:{self.rng.randrange(1 << 30)}"
        txs = [[c.key, c.value, c.client_id, c.command_id]
               for c, _ in self.mempool
               if (c.client_id, c.command_id) not in self.inchain]
        b = BlockMsg(bid, parent, h, str(self.id), txs)
        self.blocks[bid] = b
        self.socket.broadcast(b)
        self._adopt(bid)

    def handle_block(self, m: BlockMsg) -> None:
        if m.id in self.blocks:
            return
        if m.parent not in self.blocks:
            self.orphans.setdefault(m.parent, []).append(m)
            self.socket.send(ID(m.miner), BlockReq(m.parent, str(self.id)))
            return
        self.blocks[m.id] = m
        # connect EVERY orphan waiting on this block (siblings fork)
        children = self.orphans.pop(m.id, [])
        # longest chain wins; ties: lexicographically smaller head id
        cur_h = self._height(self.head)
        if m.height > cur_h or (m.height == cur_h and m.id < self.head):
            self._adopt(m.id)
        for child in children:
            self.handle_block(child)

    def handle_blockreq(self, m: BlockReq) -> None:
        b = self.blocks.get(m.id)
        if b is not None and m.id != GENESIS:
            self.socket.send(ID(m.asker), b)

    def _chain(self, bid: str) -> List[BlockMsg]:
        out = []
        while bid != GENESIS:
            b = self.blocks[bid]
            out.append(b)
            bid = b.parent
        return list(reversed(out))

    def _adopt(self, bid: str) -> None:
        # fast path: the new head EXTENDS my current chain — apply just
        # the delta blocks and scan only the blocks whose burial depth
        # crosses CONFIRM (a full genesis walk per block would decay
        # quadratically; a reorg still pays one O(chain) rebuild)
        delta: List[BlockMsg] = []
        cur = bid
        while cur != GENESIS and cur != self.head:
            delta.append(self.blocks[cur])
            cur = self.blocks[cur].parent
        extends = cur == self.head
        self.head = bid
        new_h = self._height(bid)
        conf_frontier = new_h - CONFIRM       # heights <= this confirmed
        confirmed: List[BlockMsg] = []
        if extends:
            old_frontier = conf_frontier - len(delta)
            for b in reversed(delta):
                for key, value, cid, cmid in b.txs:
                    self.db.execute(Command(int(key), value, cid,
                                            int(cmid)))
                    self.inchain.add((cid, int(cmid)))
            # newly confirmed: heights (old_frontier, conf_frontier] —
            # at most len(delta) + CONFIRM blocks from the tip
            cur = bid
            while cur != GENESIS:
                b = self.blocks[cur]
                if b.height <= old_frontier:
                    break
                if b.height <= conf_frontier:
                    confirmed.append(b)
                cur = b.parent
        else:
            # true reorg: rebuild from scratch (rare; once per fork)
            self.db.reset()
            self.inchain = set()
            for b in self._chain(bid):
                for key, value, cid, cmid in b.txs:
                    self.db.execute(Command(int(key), value, cid,
                                            int(cmid)))
                    self.inchain.add((cid, int(cmid)))
                if b.height <= conf_frontier:
                    confirmed.append(b)
        # acknowledge my own newly confirmed commands (once)
        mine_done = {(cid, int(cmid))
                     for b in confirmed if b.miner == str(self.id)
                     for _k, _v, cid, cmid in b.txs}
        still = []
        for cmd, req in self.mempool:
            tag = (cmd.client_id, cmd.command_id)
            if tag in mine_done and tag not in self.replied:
                self.replied.add(tag)
                if req is not None:
                    req.reply(Reply(cmd, value=b""))
            elif tag not in mine_done:
                still.append((cmd, req))
        self.mempool = still

    # ---- client requests -----------------------------------------------
    def handle_request(self, req: Request) -> None:
        cmd = req.command
        if cmd.is_read():
            # reads serve the adopted chain's state (eventually
            # consistent by design)
            req.reply(Reply(cmd, value=self.db.get(cmd.key) or b""))
            return
        self.mempool.append((cmd, req))


def new_replica(id: ID, cfg: Config) -> BlockchainReplica:
    return BlockchainReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  The sim's single ``head`` plane
# announces each replica's chain head; the host announces heads by
# broadcasting the block itself (BlockMsg) — BlockReq is the pull-side
# repair with no sim analog (the sim plane carries the whole head
# state, so there is nothing to fetch).
TRACE_MSG_MAP = {
    "head": "BlockMsg",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    "ring":       "blocks",  # height-ring of block ids <-> block store
    "miner_ring": "blocks",  # miner-per-height plane <-> Block.miner
    "mined":      "",  # per-replica mined counter (metrics)
    "reorgs":     "",  # rewind counter (metrics)
}
