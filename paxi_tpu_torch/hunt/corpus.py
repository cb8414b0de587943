"""The hunt corpus: a persistent, deduplicated store of violation
witnesses (the port's copy of the JAX package's ``hunt/corpus.py``; the
same layout, so either runtime's corpus loads in the other)::

    corpus/
      index.json                  # schedule_hash -> entry metadata
      <protocol>_<hash16>.npz     # the trace files themselves

Traces dedup by ``trace.format.schedule_hash``, the content hash of
(protocol, schedule planes), so rerunning a campaign never stores one
witness twice.  ``seed_from`` imports a trace directory (the fuzz soak's
dumps); files that predate hash stamping are hashed on import.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from paxi_tpu_torch.trace import format as tfmt
from paxi_tpu_torch.trace.format import Trace


class Corpus:
    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._index_path = self.root / "index.json"
        self.index: Dict[str, dict] = {}
        if self._index_path.exists():
            with open(self._index_path) as f:
                self.index = json.load(f)

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, schedule_hash: str) -> bool:
        return schedule_hash in self.index

    def _flush(self) -> None:
        tmp = str(self._index_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.index, f, indent=1, sort_keys=True)
        os.replace(tmp, self._index_path)

    def add(self, trace: Trace, origin: str = "") -> Tuple[str, bool]:
        """Store ``trace`` (no-op on a hash hit).  Returns
        (schedule_hash, newly_added)."""
        h = trace.meta.get("schedule_hash") or tfmt.schedule_hash(trace)
        if h in self.index:
            return h, False
        fname = f"{trace.protocol}_{h[:16]}.npz"
        tfmt.save(str(self.root / fname), trace)
        self.index[h] = {
            "file": fname,
            "protocol": trace.protocol,
            "steps": trace.n_steps,
            "events": trace.n_events(),
            "violations": int(trace.meta.get("group_violations", -1)),
            "shrunk": bool(trace.meta.get("shrunk", False)),
            "seed": trace.seed,
            "origin": origin,
            "ordinal": len(self.index),
        }
        self._flush()
        return h, True

    def path_of(self, schedule_hash: str) -> Optional[Path]:
        e = self.index.get(schedule_hash)
        return self.root / e["file"] if e else None

    def load(self, schedule_hash: str) -> Trace:
        p = self.path_of(schedule_hash)
        if p is None:
            raise KeyError(f"no corpus entry {schedule_hash!r}")
        return tfmt.load(str(p))

    def seed_from(self, traces_dir) -> Tuple[int, int]:
        """Import every loadable trace under ``traces_dir``; returns
        (newly added, skipped as duplicate/unreadable)."""
        traces_dir = Path(traces_dir)
        added = skipped = 0
        if not traces_dir.is_dir():
            return 0, 0
        for p in sorted(traces_dir.glob("*.npz")):
            if p.resolve().parent == self.root.resolve():
                continue
            try:
                t = tfmt.load(str(p))
            except (ValueError, OSError, KeyError):
                skipped += 1    # a foreign or stale npz: not a witness
                continue
            _, new = self.add(t, origin=f"seed:{p.name}")
            added += int(new)
            skipped += int(not new)
        return added, skipped
