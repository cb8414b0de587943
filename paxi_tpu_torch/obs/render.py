"""Rendering — ASCII timelines and Chrome trace-event export.

``ascii_timeline`` is intentionally *canonical*: ordering, indentation
and number formatting depend only on span content, so two fabric
replays of one witness render byte-identical text and divergence
debugging is ``diff timeline_a timeline_b``.  ``chrome_trace`` emits
the Trace Event Format (``chrome://tracing`` / Perfetto) with one
process row per trace and one thread row per node.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from paxi_tpu_torch.obs import stitch


def _fmt_t(t: float) -> str:
    # fabric steps are integral floats -> render as ints; wall-clock
    # seconds get microsecond precision
    if float(t).is_integer():
        return str(int(t))
    return f"{t:.6f}"


def _walk(node: dict, depth: int, t_lo: float, t_hi: float,
          width: int, out: List[str]) -> None:
    d = node["span"]
    span_w = max(t_hi - t_lo, 1e-12)
    lo = int((d["t0"] - t_lo) / span_w * width)
    hi = max(lo + 1, int((d["t1"] - t_lo) / span_w * width))
    bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
    labels = d.get("labels") or {}
    extra = ("" if not labels else " " + ",".join(
        f"{k}={labels[k]}" for k in sorted(labels)))
    out.append(f"  {'. ' * depth}{d['kind']:<9} |{bar}| "
               f"[{_fmt_t(d['t0'])}..{_fmt_t(d['t1'])}] "
               f"{d['node']} {d['sid']}{extra}")
    for c in node["children"]:
        _walk(c, depth + 1, t_lo, t_hi, width, out)


def ascii_timeline(spans: Sequence[dict], width: int = 48) -> str:
    """All traces, one block each: a proportional bar chart over the
    trace's own [t0, t1] window, children indented under parents."""
    out: List[str] = []
    forest = stitch.trees(spans)
    for trace in sorted(forest):
        docs = [d for d in spans if d["trace"] == trace]
        t_lo = min(d["t0"] for d in docs)
        t_hi = max(max(d["t1"], d["t0"]) for d in docs)
        out.append(f"trace {trace}  "
                   f"[{_fmt_t(t_lo)}..{_fmt_t(t_hi)}]  "
                   f"{len(docs)} spans")
        for root in forest[trace]:
            _walk(root, 0, t_lo, t_hi, width, out)
        ph = stitch.phases(docs, trace)
        if ph is not None:
            out.append("  phases: " + "  ".join(
                f"{p}={_fmt_t(ph[p])}"
                for p in stitch.PHASES + ("other", "e2e")))
        out.append("")
    return "\n".join(out)


def chrome_trace(spans: Sequence[dict]) -> dict:
    """Trace Event Format document: complete ("X") events; pid = trace
    index, tid = node index, with metadata naming both.  Fabric-step
    times are exported as-if-microseconds so Perfetto's zoom works."""
    traces = sorted({d["trace"] for d in spans})
    nodes = sorted({d["node"] for d in spans})
    pid = {t: i + 1 for i, t in enumerate(traces)}
    tid = {n: i + 1 for i, n in enumerate(nodes)}
    events: List[dict] = []
    for t in traces:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid[t], "tid": 0,
                       "args": {"name": f"trace {t}"}})
    for n in nodes:
        for t in traces:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid[t], "tid": tid[n],
                           "args": {"name": f"node {n}"}})
    for d in sorted(spans, key=lambda d: (d["t0"], d["trace"],
                                          stitch.sid_key(d["sid"]))):
        args: Dict[str, str] = dict(d.get("labels") or {})
        args["sid"] = d["sid"]
        args["parent"] = d["parent"]
        events.append({
            "ph": "X", "name": d["kind"], "cat": "paxi",
            "pid": pid[d["trace"]], "tid": tid[d["node"]],
            "ts": d["t0"] * 1e6, "dur": max(d["t1"] - d["t0"], 0) * 1e6,
            "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
