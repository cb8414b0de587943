"""The replicated state machine: an in-memory KV store.

Reference: paxi db.go — ``Database`` interface with ``Execute(Command)
Value`` backed by ``map[Key]Value`` + RWMutex, optional multi-version
history.  Host-runtime replicas execute committed commands against this;
the sim runtime keeps the KV as a dense ``(replica, key)`` int32 array
(see protocols' sim kernels).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from paxi_tpu_torch.core.command import (MIG_MAGIC, MOVED_MAGIC, TPC_MAGIC,
                                   TXN_MAGIC, Command, Key, Value,
                                   pack_values, unpack_mig, unpack_tpc,
                                   unpack_transaction)


class Database:
    """In-memory KV store with optional per-key version history."""

    def __init__(self, multi_version: bool = False):
        self._data: Dict[Key, Value] = {}
        self._history: Dict[Key, List[Value]] = {}
        self._multi_version = multi_version
        self._lock = threading.RLock()
        self._version = 0
        # cross-shard 2PC participant state (shard/txn.py):
        # every replica of a group executes the same ordered prepare/
        # decide/commit/abort records, so these dicts evolve
        # deterministically across the group — the participant log IS
        # the group's consensus log.  ``_staged``: txid -> staged ops;
        # ``_decided``: txid -> "c"|"a", FIRST decide record wins (the
        # coordinator-recovery tiebreak rides on log order).
        self._staged: Dict[str, list] = {}
        self._decided: Dict[str, str] = {}
        # live-migration state (shard/migrate.py): evolves
        # only through ordered ``mig`` records, so — like the 2PC
        # dicts — it is identical at every replica of a group and
        # crash recovery is log replay.
        #   _mig_open: destination-side install windows, mid ->
        #     {lo, hi, span, src, dirty}.  ``dirty`` holds keys this
        #     replica wrote AFTER the window opened (double-write
        #     duplicates / post-cutover traffic); ``install`` chunks
        #     skip them so a late snapshot item can never clobber a
        #     newer duplicated write.
        #   _mig_done: completed migration ids — a replayed ``begin``
        #     must not re-open a finished window.
        #   _frozen: source-side fence (the ``start`` record): 2PC
        #     prepares on the range vote NO from the fence until
        #     cutover, so no transaction can stage into the range
        #     after the catch-up stream's log position.
        #   _released: source-side post-cutover ranges: plain reads
        #     and writes of a released key return MOVED_MAGIC instead
        #     of executing — the bounce a stale router turns into a
        #     reroute.
        self._mig_open: Dict[str, dict] = {}
        self._mig_done: set = set()
        self._frozen: Dict[str, tuple] = {}
        self._released: Dict[str, tuple] = {}

    def execute(self, cmd: Command) -> Value:
        """Apply a command; returns the PREVIOUS value (read for gets,
        old-value for puts) exactly like the reference's Execute.

        A command whose value packs a Transaction (command.py
        pack_transaction) applies the whole batch atomically and returns
        the packed previous values — this is how transactions replicate:
        as one ordered command through whatever protocol runs."""
        with self._lock:
            if cmd.value.startswith(TPC_MAGIC):
                rec = unpack_tpc(cmd.value)
                if rec is not None:
                    return self._execute_tpc(rec)
            if cmd.value.startswith(MIG_MAGIC):
                mrec = unpack_mig(cmd.value)
                if mrec is not None:
                    return self._execute_mig(mrec)
            batch = unpack_transaction(cmd.value) if cmd.value else None
            if batch is not None:
                return pack_values(self.execute_transaction(batch))
            if self._released and self._moved_key(cmd.key):
                return MOVED_MAGIC
            prev = self._data.get(cmd.key, b"")
            if cmd.is_write():
                self._data[cmd.key] = cmd.value
                self._version += 1
                if self._mig_open:
                    self._note_write(cmd.key)
                if self._multi_version:
                    self._history.setdefault(cmd.key, []).append(cmd.value)
            return prev

    def apply_batch(self, cmds: List[Command],
                    ctab: Dict[str, tuple]) -> None:
        """Tight-loop state-machine application of a committed batch
        with per-client at-most-once filtering — the execute path for
        replicas holding no client connections (one lock acquisition,
        no Reply objects).  ``ctab`` is the caller's session table
        (client_id -> (highest executed command_id, its value)),
        updated exactly as the execute() path would.  Transaction-
        packed and multi-version commands fall back to execute()
        (the RLock makes that re-entrant)."""
        with self._lock:
            data = self._data
            for cmd in cmds:
                if cmd.key < 0:
                    continue   # NOOP filler
                cid = cmd.client_id
                if cid:
                    last = ctab.get(cid)
                    if last is not None and cmd.command_id <= last[0]:
                        continue   # duplicate: already executed
                v = cmd.value
                if self._multi_version or v.startswith(TPC_MAGIC) \
                        or v.startswith(MIG_MAGIC):
                    out = self.execute(cmd)
                elif v.startswith(TXN_MAGIC):
                    batch = unpack_transaction(v)
                    # same outcome as execute(): packed previous values
                    # (ctab must agree across replicas for duplicate
                    # replies after leader changes), one unpack + one
                    # inline loop instead of nested executes
                    out = (pack_values(self.execute_transaction(batch))
                           if batch is not None
                           else self.execute(cmd))
                elif self._released and self._moved_key(cmd.key):
                    out = MOVED_MAGIC
                else:
                    out = data.get(cmd.key, b"")
                    if v:
                        data[cmd.key] = v
                        self._version += 1
                        if self._mig_open:
                            self._note_write(cmd.key)
                if cid:
                    ctab[cid] = (cmd.command_id, out)

    def execute_transaction(self, commands: List[Command]) -> List[Value]:
        """Apply a command batch atomically (msg.go Transaction surface):
        all commands run under one lock acquisition, returning each
        command's previous value in order.  Plain sub-commands apply
        inline (no nested execute/lock per sub-command — with batched
        clients this loop IS the state-machine hot path); nested
        transaction-packed or multi-version sub-commands keep
        execute()'s exact semantics via the re-entrant fallback."""
        with self._lock:
            data = self._data
            out = []
            for c in commands:
                v = c.value
                if self._multi_version or v.startswith(TXN_MAGIC) \
                        or v.startswith(TPC_MAGIC) \
                        or v.startswith(MIG_MAGIC):
                    out.append(self.execute(c))
                    continue
                if self._released and self._moved_key(c.key):
                    out.append(MOVED_MAGIC)
                    continue
                prev = data.get(c.key, b"")
                if v:
                    data[c.key] = v
                    self._version += 1
                    if self._mig_open:
                        self._note_write(c.key)
                out.append(prev)
            return out

    def _execute_tpc(self, rec: dict) -> Value:
        """Apply one cross-shard 2PC record (shard/txn.py taxonomy);
        caller holds the lock.  Deterministic and idempotent per kind,
        so duplicate records (retries, leader-change re-proposals)
        converge at every replica:

        - ``prepare``: stage the ops unless a key is staged by another
          in-flight txn (vote NO — the conflict-abort that gives 2PC
          its txn-txn isolation).  Reply ``yes:`` + packed
          prepare-point previous values, or ``no``.
        - ``decide``: record the outcome ONCE; the reply is the
          winning outcome, so a racing coordinator/recovery learns the
          truth from its own (ordered) decide record.
        - ``commit``: apply the staged writes atomically, drop the
          stage.  ``abort``: drop the stage.

        The RLock re-enters for free under execute()'s hold; taking
        it here keeps the method safe for any caller.
        """
        with self._lock:
            kind, txid = rec["kind"], rec["txid"]
            if kind == "prepare":
                ops = rec.get("ops") or []
                if (self._frozen or self._released) and any(
                        self._fenced_key(k) for k, _ in ops):
                    # the range is mid-handoff (post-fence) or already
                    # released: staging here could strand a committed
                    # write at the old owner — vote NO, the
                    # presumed-abort path retries under a fresh map
                    if txid not in self._staged:
                        return b"no"
                if txid not in self._staged:
                    for other, oops in self._staged.items():
                        if other == txid:
                            continue
                        held = {k for k, _ in oops}
                        if any(k in held for k, _ in ops):
                            return b"no"
                    if self._decided.get(txid):
                        # late duplicate of a finished txn: never
                        # re-stage
                        return b"no"
                    self._staged[txid] = ops
                prev = [self._data.get(k, b"")
                        for k, _ in self._staged[txid]]
                return b"yes:" + pack_values(prev)
            if kind == "decide":
                out = self._decided.setdefault(txid,
                                               rec.get("outcome", "a"))
                return out.encode()
            # commit / abort
            ops = self._staged.pop(txid, None)
            self._decided.setdefault(
                txid, "c" if kind == "commit" else "a")
            if kind == "commit" and ops is not None:
                for k, v in ops:
                    if v:
                        self._data[k] = v
                        self._version += 1
                        if self._mig_open:
                            self._note_write(k)
                        if self._multi_version:
                            self._history.setdefault(k, []).append(v)
            return b"done"

    # ---- live-migration records (shard/migrate.py) ---------------------
    @staticmethod
    def _folds(key: Key, lo: int, hi: int, span: int) -> bool:
        return lo <= int(key) % span < hi

    def _moved_key(self, key: Key) -> bool:
        return any(self._folds(key, lo, hi, span)
                   for lo, hi, span in self._released.values())

    def _fenced_key(self, key: Key) -> bool:
        """Is ``key`` inside a post-fence (frozen) or released range?"""
        return any(self._folds(key, lo, hi, span)
                   for lo, hi, span in self._frozen.values()) \
            or self._moved_key(key)

    def _note_write(self, key: Key) -> None:
        """Mark ``key`` dirty in every open install window it folds
        into — callers gate on ``self._mig_open`` so the steady-state
        write path never pays for this."""
        for w in self._mig_open.values():
            if self._folds(key, w["lo"], w["hi"], w["span"]):
                w["dirty"].add(int(key))

    def _execute_mig(self, rec: dict) -> Value:
        """Apply one migration record (shard/migrate.py epochs);
        caller holds the lock.  Every kind is deterministic and
        idempotent, so duplicate records (retries, leader-change
        re-proposals) converge at every replica:

        - ``begin`` (dst): open the install window + dirty tracking,
          and clear released markers the window intersects (a range
          migrating back home must stop answering MOVED here).  A
          replay keeps the existing window's dirty set; a ``begin``
          for a finished migration replies ``done`` (recovery's
          already-complete signal) and never re-opens.
        - ``read`` (src): stream one chunk of committed range state,
          ordered by key from ``cursor`` — the reply is
          ``items:{"items": [...], "next": cursor|-1}``.  Read-only,
          so follower execution is a no-op with the same outcome.
        - ``install`` (dst): upsert a chunk, SKIPPING dirty keys (a
          duplicated write ordered after ``begin`` always wins over a
          snapshot item).  Ignored once the window is closed.
        - ``start`` (src): the fence — freeze 2PC prepares on the
          range (see ``_execute_tpc``); every pre-fence write is
          log-ordered before this record, which is what makes the
          post-fence catch-up stream complete.
        - ``cutover`` (src): release the range — but only once no
          in-doubt 2PC stage intersects it (reply ``busy`` until the
          coordinator's retries find it clean); from here plain
          reads/writes of the range return MOVED_MAGIC.
        - ``done`` (dst): close the window, remember the mid.
        - ``drop`` (src): delete the moved keys (the drain); the
          released marker stays so stale routers keep bouncing.
        """
        with self._lock:
            kind, mid = rec["kind"], rec["mid"]
            if kind == "begin":
                if mid in self._mig_done:
                    return b"done"
                if mid not in self._mig_open:
                    self._mig_open[mid] = {
                        "lo": rec["lo"], "hi": rec["hi"],
                        "span": rec["span"], "dirty": set()}
                    # becoming the owner again (a split migrating back
                    # home): drop released markers that intersect the
                    # incoming window, else the re-owned range would
                    # answer MOVED forever — routers that missed BOTH
                    # handoffs still reroute via map-version staleness
                    for m_ in [m_ for m_, (rlo, rhi, rspan)
                               in self._released.items()
                               if rspan == rec["span"]
                               and rlo < rec["hi"] and rec["lo"] < rhi]:
                        del self._released[m_]
                return b"open"
            if kind == "read":
                lo, hi, span = rec["lo"], rec["hi"], rec["span"]
                cursor, limit = rec.get("cursor", -1), \
                    rec.get("limit", 256) or 256
                keys = sorted(k for k in self._data
                              if k > cursor
                              and self._folds(k, lo, hi, span))
                chunk = keys[:limit]
                nxt = chunk[-1] if len(keys) > limit else -1
                doc = {"items": [[k, self._data[k].decode("latin1")]
                                 for k in chunk],
                       "next": nxt}
                import json
                return b"items:" + json.dumps(doc).encode()
            if kind == "install":
                w = self._mig_open.get(mid)
                if w is None:
                    return b"stale"   # window closed (or never opened)
                for k, v in rec.get("items", []):
                    if k not in w["dirty"]:
                        self._data[k] = v
                        self._version += 1
                        if self._multi_version:
                            self._history.setdefault(k, []).append(v)
                return b"ok"
            if kind == "start":
                if mid not in self._released:
                    self._frozen[mid] = (rec["lo"], rec["hi"],
                                         rec["span"])
                return b"fenced"
            if kind == "cutover":
                lo, hi, span = rec["lo"], rec["hi"], rec["span"]
                if mid not in self._released:
                    for ops in self._staged.values():
                        if any(self._folds(k, lo, hi, span)
                               for k, _ in ops):
                            # an in-doubt 2PC stage intersects the
                            # range: releasing now could strand its
                            # commit — the coordinator retries
                            return b"busy"
                    self._released[mid] = (lo, hi, span)
                    self._frozen.pop(mid, None)
                return b"ok"
            if kind == "done":
                self._mig_open.pop(mid, None)
                self._mig_done.add(mid)
                return b"ok"
            # drop: drain the moved keys from the old owner
            lo, hi, span = rec["lo"], rec["hi"], rec["span"]
            for k in [k for k in self._data
                      if self._folds(k, lo, hi, span)]:
                del self._data[k]
            return b"ok"

    def migration_state(self) -> dict:
        """Diagnostic view of the migration planes (tests/status)."""
        with self._lock:
            return {"open": sorted(self._mig_open),
                    "done": sorted(self._mig_done),
                    "frozen": dict(self._frozen),
                    "released": dict(self._released)}

    def staged_txns(self) -> List[str]:
        """In-doubt txids (prepared, no commit/abort executed yet) —
        the coordinator-recovery scan surface."""
        with self._lock:
            return sorted(self._staged)

    def decided(self, txid: str) -> Optional[str]:
        with self._lock:
            return self._decided.get(txid)

    def get(self, key: Key) -> Optional[Value]:
        with self._lock:
            return self._data.get(key)

    def put(self, key: Key, value: Value) -> None:
        with self._lock:
            self._data[key] = value
            if self._multi_version:
                self._history.setdefault(key, []).append(value)

    def snapshot(self) -> Dict[Key, Value]:
        """Copy of the full KV map — the state-transfer payload for
        leader-change log compaction (P1b snap)."""
        with self._lock:
            return dict(self._data)

    def aux_snapshot(self) -> dict:
        """The non-KV replicated state riding the P1b snapshot
        (protocols/paxos/host.py): staged/decided 2PC planes and the
        migration planes.  Without this, a leader change whose
        frontier jump compacts past an in-doubt txn's prepare (or a
        migration window's begin) would drop staged ops the decide
        record still commits — the documented 2PC gap, now closed.
        Wire-friendly: sets become sorted lists, values stay bytes
        (the codec round-trips bytes like the KV snap)."""
        with self._lock:
            return {
                "staged": {t: [[int(k), v] for k, v in ops]
                           for t, ops in self._staged.items()},
                "decided": dict(self._decided),
                "mig_open": {m: {"lo": w["lo"], "hi": w["hi"],
                                 "span": w["span"],
                                 "dirty": sorted(w["dirty"])}
                             for m, w in self._mig_open.items()},
                "mig_done": sorted(self._mig_done),
                "frozen": {m: list(r)
                           for m, r in self._frozen.items()},
                "released": {m: list(r)
                             for m, r in self._released.items()},
            }

    def restore_aux(self, aux: dict) -> None:
        """Adopt an aux snapshot at a P1b frontier jump.  Upsert
        semantics like :meth:`restore`: decided outcomes merge
        first-wins-preserving (``setdefault``), stages only land for
        txns not already decided locally, windows/fences/releases
        union — so a replica that is AHEAD on any plane keeps its own
        state."""
        if not aux:
            return
        with self._lock:
            for t, o in (aux.get("decided") or {}).items():
                self._decided.setdefault(t, o)
            for t, ops in (aux.get("staged") or {}).items():
                if t not in self._decided and t not in self._staged:
                    self._staged[t] = [(int(k), v) for k, v in ops]
            for m in aux.get("mig_done") or []:
                self._mig_done.add(m)
                self._mig_open.pop(m, None)
            for m, w in (aux.get("mig_open") or {}).items():
                if m in self._mig_done:
                    continue
                mine = self._mig_open.setdefault(
                    m, {"lo": int(w["lo"]), "hi": int(w["hi"]),
                        "span": int(w["span"]), "dirty": set()})
                mine["dirty"].update(int(k) for k in w["dirty"])
            for m, r in (aux.get("released") or {}).items():
                self._released.setdefault(m, tuple(int(x) for x in r))
                self._frozen.pop(m, None)
            for m, r in (aux.get("frozen") or {}).items():
                if m not in self._released:
                    self._frozen.setdefault(
                        m, tuple(int(x) for x in r))

    def restore(self, snap: Dict[Key, Value]) -> None:
        """Adopt a snapshot (state transfer at leader change).  Upsert
        semantics: snapshots from a more-advanced replica are a
        superset of the committed state, so absent keys need no
        deletion.  Use :meth:`reset` when the new state REPLACES the
        old (e.g. a blockchain reorg replay)."""
        with self._lock:
            for k, v in snap.items():
                self.put(int(k), v)

    def reset(self) -> None:
        """Drop every key (and history): the caller is rebuilding the
        state from scratch — a chain reorg replay, not a state
        transfer."""
        with self._lock:
            self._data.clear()
            self._history.clear()

    def history(self, key: Key) -> List[Value]:
        with self._lock:
            return list(self._history.get(key, []))

    def version(self) -> int:
        return self._version

    def __len__(self) -> int:
        return len(self._data)
