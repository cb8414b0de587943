"""Stitching — merging per-node span exports into causal trees.

Collectors are per-node rings; a trace's spans land wherever the work
ran (router, entry node, leader, 2PC participants).  This module is
the read side: merge scraped exports, stamp shard-group labels the
same way the metrics path stamps its ``group`` label, rebuild the
parent/child trees, detect orphans (a participant span whose parent
never arrived — the 2PC kill-matrix regression the tests pin), and
derive the five-phase latency decomposition
(queue / batch / quorum / exec / writeback) that bench-host rows
carry.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# the five phases of one command's end-to-end latency, in causal order
PHASES = ("queue", "batch", "quorum", "exec", "writeback")

# span kinds that can root a trace tree (parent == "")
ROOT_KINDS = ("request", "txn", "serve")


def sid_key(sid: str) -> Tuple[str, int]:
    """Collation key for span ids: ``<node>-<seq>`` sorts by node then
    numeric sequence (plain string order would put 1.1-10 < 1.1-9)."""
    node, _, seq = sid.rpartition("-")
    try:
        return (node, int(seq))
    except ValueError:
        return (sid, 0)


def merge(span_lists: Iterable[Sequence[dict]]) -> List[dict]:
    """Per-node exports -> one canonically ordered list.  Ordering is
    (t0, trace, sid): total given per-collector sequential sids, so a
    merged fabric timeline is itself deterministic."""
    out: List[dict] = []
    for spans in span_lists:
        out.extend(spans)
    out.sort(key=lambda d: (d["t0"], d["trace"], sid_key(d["sid"])))
    return out


def label_group(spans: Sequence[dict], group: int) -> List[dict]:
    """Stamp the shard-group label onto scraped spans, mirroring
    ``shard.router.label_group`` for metric snapshots.  Spans that
    already carry one (coordinator records) keep it."""
    for d in spans:
        labels = d.setdefault("labels", {})
        labels.setdefault("group", str(group))
    return list(spans)


def by_trace(spans: Sequence[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for d in spans:
        out.setdefault(d["trace"], []).append(d)
    return out


def trees(spans: Sequence[dict]) -> Dict[str, List[dict]]:
    """trace id -> list of root nodes, each ``{"span": doc,
    "children": [...]}`` with children in canonical order."""
    out: Dict[str, List[dict]] = {}
    for trace, docs in by_trace(spans).items():
        nodes = {d["sid"]: {"span": d, "children": []} for d in docs}
        roots: List[dict] = []
        for d in sorted(docs, key=lambda d: (d["t0"], sid_key(d["sid"]))):
            parent = nodes.get(d["parent"]) if d["parent"] else None
            if parent is not None:
                parent["children"].append(nodes[d["sid"]])
            else:
                roots.append(nodes[d["sid"]])
        out[trace] = roots
    return out


def orphans(spans: Sequence[dict]) -> List[dict]:
    """Spans claiming a parent that is absent from their own trace —
    a stitch failure (e.g. a 2PC participant whose coordinator record
    span was lost).  Roots (``parent == ""``) are never orphans."""
    out: List[dict] = []
    for docs in by_trace(spans).values():
        sids = {d["sid"] for d in docs}
        out.extend(d for d in docs
                   if d["parent"] and d["parent"] not in sids)
    return out


def stitched_traces(spans: Sequence[dict]) -> List[str]:
    """Traces forming a single fully-stitched tree: exactly one root,
    no orphans, >= 2 spans (a lone root proves nothing)."""
    got = []
    forest = trees(spans)
    for trace, docs in by_trace(spans).items():
        sids = {d["sid"] for d in docs}
        if (len(forest[trace]) == 1 and len(docs) >= 2
                and all(not d["parent"] or d["parent"] in sids
                        for d in docs)):
            got.append(trace)
    return sorted(got)


def groups_of(spans: Sequence[dict], trace: str) -> List[str]:
    """Distinct shard-group labels inside one trace — a cross-shard
    2PC tree must cover >= 2."""
    gs = {d.get("labels", {}).get("group")
          for d in spans if d["trace"] == trace}
    return sorted(g for g in gs if g)


# ---- five-phase decomposition ------------------------------------------

def _root_of(docs: Sequence[dict]) -> Optional[dict]:
    roots = [d for d in docs
             if not d["parent"] and d["kind"] in ROOT_KINDS]
    if not roots:
        return None
    return min(roots, key=lambda d: (d["t0"], sid_key(d["sid"])))


def phases(spans: Sequence[dict], trace: str) -> Optional[dict]:
    """One trace -> ``{queue, batch, quorum, exec, writeback, other,
    e2e}`` in the collector's time unit (seconds live, fabric steps
    under replay).  ``queue`` is the derived gap from the root's start
    to batch admission; ``other`` is the unattributed residual, so the
    five phases plus ``other`` always sum to ``e2e`` exactly — the
    consistency the acceptance gate checks."""
    docs = [d for d in spans if d["trace"] == trace]
    root = _root_of(docs)
    if root is None or root["t1"] < root["t0"]:
        return None
    e2e = root["t1"] - root["t0"]

    def dur_sum(kind: str) -> float:
        return sum(d["t1"] - d["t0"] for d in docs
                   if d["kind"] == kind and d["t1"] >= d["t0"])

    batches = [d for d in docs if d["kind"] == "batch"]
    queue = (max(0.0, min(b["t0"] for b in batches) - root["t0"])
             if batches else 0.0)
    out = {"queue": queue, "batch": dur_sum("batch"),
           "quorum": dur_sum("quorum"), "exec": dur_sum("exec"),
           "writeback": dur_sum("writeback"), "e2e": e2e}
    out["other"] = max(0.0, e2e - sum(out[p] for p in PHASES))
    return out


def aggregate_phases(spans: Sequence[dict]) -> dict:
    """All traces -> mean per-phase durations plus the coverage ratio
    (attributed time / end-to-end time).  This is the bench-host row
    payload."""
    rows = [p for t in by_trace(spans)
            for p in [phases(spans, t)] if p is not None]
    if not rows:
        return {"traces": 0}
    n = len(rows)
    agg = {"traces": n,
           "e2e_mean": sum(r["e2e"] for r in rows) / n,
           "phase_mean": {p: sum(r[p] for r in rows) / n
                          for p in PHASES + ("other",)}}
    total_e2e = sum(r["e2e"] for r in rows)
    attributed = sum(sum(r[p] for p in PHASES) for r in rows)
    agg["coverage"] = (attributed / total_e2e) if total_e2e > 0 else 0.0
    return agg
