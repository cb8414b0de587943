"""Operation history + linearizability checker — the safety oracle.

Reference: paxi history.go (+ linearizability.go) — ``History`` records
``{input, output, start, end}`` per key; the checker builds a precedence
graph (real-time order + data order) over one key's operations and
counts anomalies via cycle detection; ``WriteFile`` dumps per-key op
logs [high].

Algorithm here (register semantics, unique written values — the
benchmark writes ``client_id:command_id`` payloads so this holds):

1. nodes = operations; real-time edge A→B if A.end < B.start
2. read-from edge write(v) → read(v)
3. closure rule: a read of v precedes every write that (transitively)
   follows write(v) — iterated to fixpoint
4. any cycle is an anomaly; the checker removes one offending read per
   cycle and recounts, so the result is "number of non-linearizable
   reads", matching the reference's anomaly count.

Histories of 32 or more operations per key go to a C++ checker of the
same algorithm (``host/csrc/lincheck.cpp`` through ``host/native.py``,
same answers).  A vectorized stale-read variant of the same oracle for
big sim histories, torch tensor code on the card, lives in
``paxi_tpu_torch.sim.lincheck``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Operation:
    """Reference: history.go operation{input, output, start, end}."""

    input: Optional[bytes]    # written value; None for reads
    output: Optional[bytes]   # read value; None for writes
    start: float
    end: float

    @property
    def is_read(self) -> bool:
        return self.input is None


class History:
    def __init__(self):
        self._ops: Dict[int, List[Operation]] = {}

    def add(self, key: int, input: Optional[bytes], output: Optional[bytes],
            start: float, end: float) -> None:
        self._ops.setdefault(key, []).append(
            Operation(input, output, start, end))

    def add_operation(self, key: int, op: Operation) -> None:
        self._ops.setdefault(key, []).append(op)

    def keys(self) -> List[int]:
        return sorted(self._ops)

    def ops(self, key: int) -> List[Operation]:
        return list(self._ops.get(key, []))

    def __len__(self) -> int:
        return sum(len(v) for v in self._ops.values())

    # ---- the checker ---------------------------------------------------
    def linearizable(self) -> int:
        """Total anomalous reads across keys (0 == linearizable)."""
        return sum(check_key(ops) for ops in self._ops.values())

    # ---- persistence (history.go WriteFile) ----------------------------
    def write_file(self, path: str) -> None:
        dump = {
            str(k): [{"input": o.input.decode("latin1") if o.input is not None else None,
                      "output": o.output.decode("latin1") if o.output is not None else None,
                      "start": o.start,
                      "end": None if math.isinf(o.end) else o.end}
                     for o in sorted(v, key=lambda o: o.start)]
            for k, v in self._ops.items()
        }
        with open(path, "w") as f:
            json.dump(dump, f, indent=1)


def check_key(ops: List[Operation]) -> int:
    """Anomalous-read count for one key's operations (module docstring).

    Large histories go through the native checker (host/native.py, same
    algorithm; ~50x faster); small ones and the fallback stay here."""
    ops = sorted(ops, key=lambda o: (o.start, o.end))
    if len(ops) >= 32:
        from paxi_tpu_torch.host.native import check_key_native
        r = check_key_native(ops)
        if r is not None:
            return r
    anomalies = 0
    while True:
        bad = _find_cycle_read(ops)
        if bad is None:
            return anomalies
        anomalies += 1
        ops = [o for o in ops if o is not bad]


def _find_cycle_read(ops: List[Operation]) -> Optional[Operation]:
    """Build the precedence graph + closure; return a read on a cycle,
    or None if the history is linearizable.

    Rows of the adjacency/reachability matrices are Python-int bitsets
    (bit j of adj[i] = edge i→j), so Warshall closure costs n^3/64 word
    ops — fast enough to check benchmark-sized hot keys inline."""
    n = len(ops)
    if n == 0:
        return None
    writes_by_val: Dict[bytes, int] = {}
    writes = []
    for i, o in enumerate(ops):
        if not o.is_read and o.input is not None:
            writes_by_val[o.input] = i
            writes.append(i)

    adj = [0] * n
    for i in range(n):
        oi_end = ops[i].end
        row = 0
        for j in range(n):
            if i != j and oi_end < ops[j].start:
                row |= 1 << j   # real-time precedence
        adj[i] = row

    # read-from edges; a read of a value never written (and non-empty) is
    # itself an anomaly
    read_from: Dict[int, int] = {}
    for i, o in enumerate(ops):
        if not o.is_read:
            continue
        if o.output:
            w = writes_by_val.get(o.output)
            if w is None:
                return o
            adj[w] |= 1 << i
            read_from[i] = w
        else:
            # read of the initial (empty) register: it observed no write,
            # so it precedes every write — a write completing before it
            # then closes a cycle (lost-update detection; mirrors
            # sim/lincheck.py's stale-initial-read rule)
            for w2 in writes:
                adj[i] |= 1 << w2

    # closure to fixpoint, two data-order rules per read r of write w:
    #   (a) every other write preceding r precedes w (r observed w last)
    #   (b) r precedes every write that follows w (r didn't observe them)
    while True:
        reach = _transitive_closure(adj)
        changed = False
        for r, w in read_from.items():
            for w2 in writes:
                if w2 == w:
                    continue
                if (reach[w2] >> r) & 1 and not (adj[w2] >> w) & 1:
                    adj[w2] |= 1 << w
                    changed = True
                if (reach[w] >> w2) & 1 and not (adj[r] >> w2) & 1 \
                        and r != w2:
                    adj[r] |= 1 << w2
                    changed = True
        if not changed:
            break

    reach = _transitive_closure(adj)
    on_cycle = [i for i in range(n) if (reach[i] >> i) & 1]
    if not on_cycle:
        return None
    for i in on_cycle:           # prefer blaming a read
        if ops[i].is_read:
            return ops[i]
    return ops[on_cycle[0]]


def _transitive_closure(adj: List[int]) -> List[int]:
    n = len(adj)
    reach = list(adj)
    for k in range(n):
        rk = reach[k]
        bit = 1 << k
        for i in range(n):
            if reach[i] & bit:
                reach[i] |= rk
    return reach
