"""Causal span model — the unit of the tracing subsystem.

A :class:`Span` is one timed interval of work attributed to a trace: a
trace id shared by everything one client command caused, a span id
unique within the emitting process, the parent span id that makes the
set a tree, a ``kind`` from the taxonomy below, ``t0``/``t1``
timestamps, the emitting node, and free-form string labels.

Span taxonomy (kinds):

- ``request``   — root: one client command, opened where sampling was
                  decided (node HTTP server or RouterServer)
- ``route``     — router-internal wait: enqueue in the per-group
                  pending queue until shipped to the backend group
- ``serve``     — backend node serving a command whose trace was
                  sampled upstream (child of the router's root)
- ``batch``     — BatchBuffer residency: add() to flush()
- ``quorum``    — leader tally: propose (P2a out) to commit (majority)
- ``exec``      — state-machine apply: the ``db.execute`` call
- ``writeback`` — reply fan-out: building + delivering the Reply
- ``txn``       — root of a cross-shard transaction (RouterServer)
- ``prepare``/``decide``/``commit``/``abort`` — coordinator 2PC
                  records, one per (group, record)
- ``tpc``       — participant-side handling of one 2PC record at the
                  home/participant group's entry node

Timestamps come from the virtual-clock fabric when the emitting
collector holds one (``t`` is the integer fabric step — deterministic,
byte-identical across replays of the same schedule) and from
``time.perf_counter()`` in live serving (monotonic seconds, comparable
only within one process).

The wire encoding of a trace context is the single properties value
``"<trace>:<parent-span>"`` under key ``"trace"`` — it rides the
existing Client-Id/Command-Id pass-through (``Request.properties`` /
``WireRequest.properties`` and the ``Property-Trace`` HTTP header), so
no frame layout changes and unsampled traffic pays nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

# properties key / HTTP header carrying an encoded TraceCtx
TRACE_PROP = "trace"
TRACE_HEADER = "Property-Trace"

KINDS = ("request", "route", "serve", "batch", "quorum", "exec",
         "writeback", "txn", "prepare", "decide", "commit", "abort",
         "tpc")


@dataclass(frozen=True)
class TraceCtx:
    """What propagates: the trace id plus the span id new children
    should parent under.  ``span == ""`` means "root position" — a
    span started from such a context becomes a tree root."""

    trace: str
    span: str = ""

    def encode(self) -> str:
        return f"{self.trace}:{self.span}"

    @staticmethod
    def decode(s: Optional[str]) -> Optional["TraceCtx"]:
        if not s:
            return None
        trace, _, span = s.partition(":")
        if not trace:
            return None
        return TraceCtx(trace, span)


def ctx_of(obj: Any) -> Optional[TraceCtx]:
    """Trace context riding an object's ``properties`` dict (Request,
    WireRequest, ...), or None.  Absence == unsampled: every
    instrumentation site keys off this one check."""
    props = getattr(obj, "properties", None)
    if not props:
        return None
    return TraceCtx.decode(props.get(TRACE_PROP))


def first_ctx(objs: Optional[Iterable[Any]]) -> Optional[TraceCtx]:
    """First trace context among ``objs`` (a batch shares one quorum
    round; the earliest sampled member claims the span)."""
    for o in objs or ():
        c = ctx_of(o)
        if c is not None:
            return c
    return None


@dataclass
class Span:
    trace: str
    sid: str
    parent: str
    kind: str
    node: str
    t0: float
    t1: float = -1.0               # -1: still open
    labels: Dict[str, str] = field(default_factory=dict)

    def child(self) -> TraceCtx:
        """The context downstream work should propagate."""
        return TraceCtx(self.trace, self.sid)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0 if self.t1 >= 0 else 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "Span":
        return Span(trace=d["trace"], sid=d["sid"], parent=d["parent"],
                    kind=d["kind"], node=d["node"], t0=float(d["t0"]),
                    t1=float(d["t1"]), labels=dict(d.get("labels") or {}))


# exported-document schema: key -> required type(s); the span tests
# validate against this
SCHEMA = {
    "trace": str, "sid": str, "parent": str, "kind": str, "node": str,
    "t0": (int, float), "t1": (int, float), "labels": dict,
}


def validate_spans(docs: Iterable[dict]) -> List[str]:
    """Schema-check exported span documents; returns human-readable
    problems (empty == valid)."""
    errs: List[str] = []
    for i, d in enumerate(docs):
        if not isinstance(d, dict):
            errs.append(f"span[{i}]: not an object")
            continue
        for k, t in SCHEMA.items():
            if k not in d:
                errs.append(f"span[{i}]: missing {k!r}")
            elif not isinstance(d[k], t):
                errs.append(f"span[{i}].{k}: {type(d[k]).__name__}")
        if d.get("t1", 0) < d.get("t0", 0):
            errs.append(f"span[{i}]: t1 < t0")
        for lk, lv in (d.get("labels") or {}).items():
            if not isinstance(lk, str) or not isinstance(lv, str):
                errs.append(f"span[{i}].labels: non-string entry")
                break
    return errs
