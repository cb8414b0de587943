"""Live data migration & elastic resharding (the wpaxos steal at
shard-range granularity).

``ShardMap.move_range`` is control-plane only: the map flips, but a
moved range arrives empty at its new owner.  This module makes
resharding a first-class ONLINE operation — a range moves with its
data, under load, without losing a write or serving a stale read from
the wrong side of the handoff.  The protocol is wpaxos phase-1 key
stealing lifted from per-object to range granularity: every state
transition of the handoff is one opaque record (core/command.pack_mig)
committed in a group's OWN Paxos log, so crash recovery at any point
is just replaying the log — the epoch state machine lives in
``Database._execute_mig``, and the coordinator here is a stateless
driver that can die and re-run.

Epochs (``MigrationCoordinator.move_range``), for ``[lo, hi)`` moving
``src -> dst``:

1. **snapshot** — ``begin``@dst opens the install window (and dirty
   tracking: any key the window sees written after ``begin`` is
   *dirty*, and later ``install``s skip it, so a streamed item can
   never clobber a newer duplicated write).  Then the bulk stream:
   ``read``@src pages committed range state out of src's log in key
   order, ``install``@dst commits each chunk into dst's log.
2. **double-write** — the map gains a migration entry
   (``ShardMap.with_migration``, version + 1) and is installed on
   every holder/router: writes in the range now ship to BOTH groups
   (router.py's dual-write fence), reads still come from src.  After
   a per-router ``barrier(src)`` (all previously accepted writes are
   on src's wire), ``start``@src commits the fence: it log-orders
   after every pre-fence write AND freezes new 2PC prepares on the
   range, so the catch-up stream that follows it observes everything
   the bulk stream raced with.
3. **cutover** — ``complete_migration`` (version + 2, dst owns) is
   installed on the holders FIRST, then ``cutover``@src releases the
   range — busy-retried while any in-doubt 2PC stage intersects it
   (releasing earlier could strand that transaction's commit).  From
   here src answers the range with the MOVED marker and stale routers
   bounce + refresh (router.py ``_rebounce``).
4. **drain** — a final catch-up stream picks up freeze-window 2PC
   commits of pre-fence-staged transactions (src's range is immutable
   post-cutover, so this stream is complete by construction), then
   ``done``@dst closes the window and ``drop``@src deletes the moved
   keys.  The released marker persists so laggards keep bouncing.

Recovery is re-running ``move_range`` with the same arguments: every
record is idempotent, ``begin`` answers ``done`` for a finished
migration, a map that already carries the migration entry resumes at
double-write, and a map that already routes the range to ``dst``
resumes at drain.  Known limits (documented, tested as such): a
repeat migration of the SAME (lo, hi, dst) triple needs an explicit
fresh ``mid``; negative keys are missed by the cursor-paged stream
(the KV surfaces in this repo use non-negative keys); and a
post-cutover crash resumed without ``src`` skips the final ``drop``
(the old owner leaks the moved keys until a manual drain).

The **Rebalancer** is the elastic policy plane: off the router's
per-group routed-command counters and its 64-bucket key histogram it
decides — with hysteresis (``min_ticks`` consecutive observations, a
``cooldown`` after every action) — to split a hot range at its load
median onto the least-loaded group, or merge a cold group's range
into its neighbor.  ``tick`` is pure (explicit inputs, a plan dict or
None out) so tests drive it deterministically; ``step`` wires it to a
live router + coordinator.

``MapHolder`` is the minimal fenced holder of the versioned map for
coordinator deployments without a router in-process (fabric tests,
CLI tools): the same lock/snapshot/version-guarded-swap discipline as
``ShardRouter`` — the shape the epoch-fence lint family (PXE15x)
proves of the router and of this file.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, List, Optional, Sequence

from paxi_tpu_torch.shard.shardmap import ShardMap

_BUCKETS = 64       # must match ShardRouter._bucket_hits


class MigrationError(Exception):
    """A handoff step failed in a way re-running cannot mask (bad
    arguments, transport failure, a starved cutover)."""


class MigrationKilled(Exception):
    """Crash injection marker (the migration analog of
    txn.CoordinatorKilled): raised at the configured epoch so tests
    can kill the coordinator mid-protocol and assert that a re-run
    converges by log order."""


class MapHolder:
    """A fenced ``ShardMap`` holder for router-less deployments: the
    exact swap discipline the router documents — snapshot under the
    lock, install only under the lock behind a strict version-advance
    guard — so fabric tests and CLI tools share the PXE-proven shape
    instead of growing a third, unchecked map cache."""

    def __init__(self, shard_map: ShardMap):
        shard_map.validate()
        self._lock = threading.Lock()
        self._map = shard_map

    @property
    def shard_map(self) -> ShardMap:
        with self._lock:
            return self._map

    def install_map(self, new_map: ShardMap) -> None:
        new_map.validate()
        with self._lock:
            if new_map.version <= self._map.version:
                raise ValueError(
                    f"stale map: version {new_map.version} <= "
                    f"installed {self._map.version}")
            self._map = new_map


class MigrationCoordinator:
    """Drives one range handoff through its epochs.

    ``submit(group, key, rec)`` is the record transport (the 2PC
    coordinator's shape): commit one migration record dict in
    ``group``'s log and return ``(ok, reply_payload)`` — HTTP POST
    /mig in live deployments, direct leader injection in fabric
    tests.  ``holders`` are the map caches to keep in lockstep
    (ShardRouter and/or MapHolder instances; the FIRST is the
    authority whose map seeds each derivation); holders exposing a
    ``barrier(group)`` coroutine (routers) are fenced before the
    ``start`` record so the fence log-orders after every write they
    already accepted.
    """

    BUSY_TRIES = 200

    def __init__(self, submit, holders: Sequence, chunk: int = 64,
                 crash_at: Optional[str] = None,
                 busy_wait_s: float = 0.05):
        if not holders:
            raise ValueError("need at least one map holder")
        self._submit = submit
        self._holders = list(holders)
        self.chunk = int(chunk)
        # one-shot crash injection: "snapshot" (after the first bulk
        # chunk), "double_write" (fence committed, catch-up not run),
        # "cutover" (range released, drain not run)
        self.crash_at = crash_at
        self.busy_wait_s = busy_wait_s
        self.state: Dict = {}

    def status(self) -> Dict:
        return dict(self.state)

    # ---- the driver -----------------------------------------------------
    async def move_range(self, lo: int, hi: int, dst: int,
                         mid: Optional[str] = None,
                         src: Optional[int] = None) -> Dict:
        """Move ``[lo, hi)`` to group ``dst`` with its data; returns
        the final status dict.  Re-running with the same arguments
        resumes an interrupted handoff at the epoch the logs prove it
        reached."""
        m = self._holders[0].shard_map
        mid = mid or f"m{lo}-{hi}-{dst}"
        span = m.span
        mig = m.migration_of(lo)
        if mig is not None:
            if (mig[0], mig[1], mig[3]) != (lo, hi, dst):
                raise MigrationError(
                    f"range [{lo}, {hi}) overlaps in-flight "
                    f"migration {mig}")
            # the map already carries the window: a previous run got
            # past the double-write install — resume there (begin and
            # every later record are idempotent)
            self._begin_state(mid, lo, hi, mig[2], dst, "double-write")
            began = await self._begin(dst, mid, lo, hi, span)
            if began == b"done":
                raise MigrationError(
                    f"migration {mid} marked done at dst but the map "
                    f"still carries its window")
            return await self._double_write(mid, lo, hi, span,
                                            mig[2], dst)
        owner = m.group_of(lo)
        if owner == dst:
            # post-cutover resume (or an outright no-op): the map
            # already routes the range to dst — finish the drain
            self._begin_state(mid, lo, hi, src, dst, "drain")
            return await self._drain(mid, lo, hi, span, src, dst)
        src = owner
        if any(m.group_of(k) != src for k in m.starts if lo < k < hi):
            raise MigrationError(
                f"range [{lo}, {hi}) spans several owner groups")
        # ---- epoch 1: snapshot ----
        self._begin_state(mid, lo, hi, src, dst, "snapshot")
        began = await self._begin(dst, mid, lo, hi, span)
        if began == b"done":
            raise MigrationError(
                f"mid {mid} was already used for a completed "
                f"migration; pass a fresh explicit mid")
        await self._stream(mid, lo, hi, span, src, dst,
                           kill="snapshot")
        return await self._double_write(mid, lo, hi, span, src, dst)

    async def _double_write(self, mid: str, lo: int, hi: int,
                            span: int, src: int, dst: int) -> Dict:
        # ---- epoch 2: double-write ----
        self.state["epoch"] = "double-write"
        mp = self._holders[0].shard_map
        if mp.migration_of(lo) is None:
            m1 = mp.with_migration(lo, hi, dst)
            self._install_everywhere(m1)
        await self._barriers(src)
        await self._mig(src, lo, {"kind": "start", "mid": mid,
                                  "lo": lo, "hi": hi, "span": span})
        self._maybe_kill("double_write")
        await self._stream(mid, lo, hi, span, src, dst)
        # ---- epoch 3: cutover ----
        self.state["epoch"] = "cutover"
        mp = self._holders[0].shard_map
        if mp.migration_of(lo) is not None:
            m2 = mp.complete_migration(lo, hi)
            self._install_everywhere(m2)
        for _ in range(self.BUSY_TRIES):
            out = await self._mig(
                src, lo, {"kind": "cutover", "mid": mid, "lo": lo,
                          "hi": hi, "span": span})
            if out != b"busy":
                break
            # an in-doubt 2PC stage intersects the range: wait for
            # its coordinator (or recovery) to decide, then retry
            await asyncio.sleep(self.busy_wait_s)
        else:
            raise MigrationError(
                f"cutover of [{lo}, {hi}) starved by staged 2PC "
                f"transactions")
        self._maybe_kill("cutover")
        return await self._drain(mid, lo, hi, span, src, dst)

    async def _drain(self, mid: str, lo: int, hi: int, span: int,
                     src: Optional[int], dst: int) -> Dict:
        # ---- epoch 4: drain ----
        self.state["epoch"] = "drain"
        if src is not None:
            await self._stream(mid, lo, hi, span, src, dst)
        await self._mig(dst, lo, {"kind": "done", "mid": mid})
        if src is not None:
            await self._mig(src, lo, {"kind": "drop", "mid": mid,
                                      "lo": lo, "hi": hi,
                                      "span": span})
        self.state["epoch"] = "complete"
        return self.status()

    # ---- steps ----------------------------------------------------------
    def _begin_state(self, mid, lo, hi, src, dst, epoch) -> None:
        self.state = {"mid": mid, "lo": lo, "hi": hi, "src": src,
                      "dst": dst, "epoch": epoch, "chunks": 0,
                      "installed": 0}

    async def _begin(self, dst: int, mid: str, lo: int, hi: int,
                     span: int) -> bytes:
        return await self._mig(dst, lo, {"kind": "begin", "mid": mid,
                                         "lo": lo, "hi": hi,
                                         "span": span})

    async def _mig(self, group: int, key: int, rec: dict) -> bytes:
        ok, payload = await self._submit(group, key, rec)
        if not ok:
            raise MigrationError(
                f"{rec['kind']}@group{group} failed: {payload!r}")
        return payload

    async def _stream(self, mid: str, lo: int, hi: int, span: int,
                      src: int, dst: int,
                      kill: Optional[str] = None) -> int:
        """One read/install pass over the range: pages src's
        committed state in key order and commits each chunk into
        dst's log; ``install`` skips keys dst saw written since
        ``begin``, so any pass after the first only fills gaps."""
        cursor, total = -1, 0
        while True:
            payload = await self._mig(
                src, lo, {"kind": "read", "mid": mid, "lo": lo,
                          "hi": hi, "span": span, "cursor": cursor,
                          "limit": self.chunk})
            if not payload.startswith(b"items:"):
                raise MigrationError(
                    f"bad read reply from group {src}: {payload!r}")
            doc = json.loads(payload[len(b"items:"):].decode())
            items = [(int(k), v.encode("latin1"))
                     for k, v in doc["items"]]
            if items:
                await self._mig(
                    dst, lo, {"kind": "install", "mid": mid,
                              "lo": lo, "hi": hi, "span": span,
                              "items": items})
                total += len(items)
            self.state["chunks"] += 1
            self.state["installed"] += len(items)
            if kill is not None:
                self._maybe_kill(kill)
            if doc["next"] < 0:
                return total
            cursor = doc["next"]

    def _install_everywhere(self, new_map: ShardMap) -> None:
        for h in self._holders:
            try:
                h.install_map(new_map)
            except ValueError:
                pass   # that holder already saw this (or a newer) map

    async def _barriers(self, group: int) -> None:
        for h in self._holders:
            b = getattr(h, "barrier", None)
            if b is not None:
                await b(group)

    def _maybe_kill(self, point: str) -> None:
        if self.crash_at == point:
            self.crash_at = None   # one-shot, so a re-run completes
            raise MigrationKilled(f"killed at {point} "
                                  f"({self.state.get('mid')})")


class Rebalancer:
    """Load-driven auto-split/merge with hysteresis.

    Per tick the caller hands in the current (fenced) map, the
    per-group routed-command counts SINCE THE LAST TICK, and the
    router's 64-bucket key-histogram deltas.  A group holding at
    least ``hot_share`` of the tick's commands for ``min_ticks``
    consecutive ticks triggers a **split** plan: its hottest range is
    cut at the load median (the bucket boundary that halves the
    range's hits) and the upper half is assigned to the least-loaded
    group.  A group at or under ``cold_share`` for ``min_ticks``
    ticks triggers a **merge** plan: its first range folds into the
    neighboring owner.  After any plan, ``cooldown`` ticks pass
    before the next decision, and ticks with fewer than ``min_cmds``
    total commands reset the streaks — both guards against flapping
    on noise.

    ``tick`` is pure decision-making (a plan dict or None);
    ``step`` executes the loop against a live router + coordinator.
    """

    def __init__(self, hot_share: float = 0.5,
                 cold_share: float = 0.05, min_ticks: int = 3,
                 min_cmds: int = 50, cooldown: int = 3):
        self.hot_share = hot_share
        self.cold_share = cold_share
        self.min_ticks = min_ticks
        self.min_cmds = min_cmds
        self.cooldown = cooldown
        self._hot: Dict[int, int] = {}
        self._cold: Dict[int, int] = {}
        self._quiet = 0
        self._last_cmds: Optional[List[float]] = None

    def tick(self, shard_map: ShardMap, group_cmds: Sequence[float],
             bucket_hits: Sequence[int]) -> Optional[Dict]:
        total = sum(group_cmds)
        if self._quiet > 0:
            self._quiet -= 1
            return None
        if total < self.min_cmds:
            self._hot.clear()
            self._cold.clear()
            return None
        for g, c in enumerate(group_cmds):
            share = c / total
            self._hot[g] = self._hot.get(g, 0) + 1 \
                if share >= self.hot_share else 0
            self._cold[g] = self._cold.get(g, 0) + 1 \
                if share <= self.cold_share else 0
        hot = max(range(len(group_cmds)),
                  key=lambda g: group_cmds[g])
        if self._hot.get(hot, 0) >= self.min_ticks:
            plan = self._split_plan(shard_map, hot, group_cmds,
                                    bucket_hits)
            if plan is not None:
                return self._emit(plan)
        cold = min(range(len(group_cmds)),
                   key=lambda g: group_cmds[g])
        if self._cold.get(cold, 0) >= self.min_ticks \
                and len(set(shard_map.groups)) > 1:
            plan = self._merge_plan(shard_map, cold)
            if plan is not None:
                return self._emit(plan)
        return None

    def _emit(self, plan: Dict) -> Dict:
        self._hot.clear()
        self._cold.clear()
        self._quiet = self.cooldown
        return plan

    def _split_plan(self, m: ShardMap, hot: int,
                    group_cmds: Sequence[float],
                    bucket_hits: Sequence[int]) -> Optional[Dict]:
        others = [g for g in range(len(group_cmds)) if g != hot]
        if not others:
            return None
        dst = min(others, key=lambda g: group_cmds[g])
        ranges = m.ranges_of(hot)
        if not ranges:
            return None
        best = max(ranges,
                   key=lambda r: self._range_hits(m.span,
                                                  bucket_hits, *r))
        lo, hi = best
        at = self._median_cut(m.span, bucket_hits, lo, hi)
        if at is None:
            return None
        return {"action": "split", "lo": at, "hi": hi, "src": hot,
                "dst": dst}

    def _merge_plan(self, m: ShardMap, cold: int) -> Optional[Dict]:
        ranges = m.ranges_of(cold)
        if not ranges:
            return None
        lo, hi = ranges[0]
        # fold into the neighboring owner: the range just below, or
        # just above when the cold range starts the span
        probe = lo - 1 if lo > 0 else hi
        dst = m.group_of(probe)
        if dst == cold:
            return None
        return {"action": "merge", "lo": lo, "hi": hi, "src": cold,
                "dst": dst}

    @staticmethod
    def _range_hits(span: int, hits: Sequence[int], lo: int,
                    hi: int) -> int:
        total = 0
        for b, h in enumerate(hits):
            mid = (b * span + span // 2) // _BUCKETS
            if lo <= mid < hi:
                total += h
        return total

    @staticmethod
    def _median_cut(span: int, hits: Sequence[int], lo: int,
                    hi: int) -> Optional[int]:
        """The bucket boundary strictly inside (lo, hi) closest to
        halving the range's hits; the arithmetic midpoint when the
        histogram is too coarse to cut (all hits in one bucket)."""
        inside = []
        for b in range(len(hits)):
            edge = (b * span) // _BUCKETS
            if lo < edge < hi:
                inside.append((edge, b))
        if not inside:
            return (lo + hi) // 2 if hi - lo > 1 else None
        def mass_below(edge):
            return sum(h for b, h in enumerate(hits)
                       if lo <= (b * span + span // 2) // _BUCKETS
                       < edge)
        half = Rebalancer._range_hits(span, hits, lo, hi) / 2
        if half <= 0:
            return None
        return min((e for e, _ in inside),
                   key=lambda e: abs(mass_below(e) - half))

    async def step(self, router, coordinator) -> Optional[Dict]:
        """One live iteration: read the router's evidence (command
        deltas + histogram), decide, and when a plan comes out run
        the streamed move for it.  Returns the executed plan."""
        cmds = [c.value for c in router._group_fwd]
        if self._last_cmds is None:
            self._last_cmds = cmds
            return None
        deltas = [c - p for c, p in zip(cmds, self._last_cmds)]
        self._last_cmds = cmds
        hits = router.bucket_hits(reset=True)
        plan = self.tick(router.shard_map, deltas, hits)
        if plan is None:
            return None
        await coordinator.move_range(plan["lo"], plan["hi"],
                                     plan["dst"])
        return plan
