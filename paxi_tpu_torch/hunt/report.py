"""Campaign reports: HUNT_REPORT.json (machine) and HUNT_REPORT.md
(triage); the port's copy of the JAX package's ``hunt/report.py``, the
same JSON.

The markdown is for whoever opens it after a campaign found something:
every witness row names its corpus file and verdict, and the taxonomy
section says what to do with each verdict."""

from __future__ import annotations

from typing import Dict, List

from paxi_tpu_torch.hunt.classify import OUTCOMES


def summarize(state: dict, corpus, budget: int,
              protocols: List[str]) -> dict:
    runs = state["runs"]
    per: Dict[str, dict] = {}
    for p in protocols:
        per[p] = {"runs": len(state["done"].get(p, [])),
                  "budget": budget, "violations": 0, "witnesses": 0,
                  **{o: 0 for o in OUTCOMES}, "unclassified": 0}
    for r in runs:
        p = r["protocol"]
        if p in per:
            per[p]["violations"] += r.get("violations", 0)
    for w in state["witnesses"].values():
        p = w["protocol"]
        if p not in per:
            continue
        per[p]["witnesses"] += 1
        outcome = w.get("classification", {}).get("outcome",
                                                  "unclassified")
        per[p][outcome if outcome in OUTCOMES else "unclassified"] += 1
    totals = {k: sum(per[p][k] for p in per)
              for k in ("runs", "violations", "witnesses", "unclassified",
                        *OUTCOMES)}
    return {"protocols": per, "totals": totals,
            "corpus_size": len(corpus)}


def build_report(state: dict, corpus, budget: int,
                 protocols: List[str]) -> dict:
    return {
        "summary": summarize(state, corpus, budget, protocols),
        "witnesses": state["witnesses"],
        "runs": state["runs"],
        "corpus": corpus.index,
    }


def render_markdown(rep: dict) -> str:
    s = rep["summary"]
    t = s["totals"]
    lines = [
        "# Divergence-hunt campaign report",
        "",
        f"**{t['runs']} fuzz runs** over {len(s['protocols'])} "
        f"protocol(s) — {t['violations']} sim violation(s), "
        f"{t['witnesses']} distinct witness(es), corpus size "
        f"{s['corpus_size']}.",
        "",
        f"Verdicts: **{t['reproduced']} reproduced** / "
        f"{t['diverged']} diverged / {t['unmappable']} unmappable / "
        f"{t['unclassified']} unclassified.",
        "",
        "| protocol | runs | sim violations | witnesses | reproduced |"
        " diverged | unmappable | unclassified |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for p in sorted(s["protocols"]):
        r = s["protocols"][p]
        lines.append(
            f"| {p} | {r['runs']}/{r['budget']} | {r['violations']} | "
            f"{r['witnesses']} | {r['reproduced']} | {r['diverged']} | "
            f"{r['unmappable']} | {r['unclassified']} |")
    if rep["witnesses"]:
        lines += ["", "## Witnesses", ""]
        for h, w in sorted(rep["witnesses"].items()):
            c = w.get("classification", {})
            entry = rep["corpus"].get(w.get("minimal", h), {})
            lines += [
                f"### `{h[:16]}` — {w['protocol']} — "
                f"**{c.get('outcome', 'unclassified')}**",
                "",
                f"- artifact: `corpus/{entry.get('file', '?')}` "
                f"({w.get('events_after', '?')} events, shrunk from "
                f"{w.get('events_before', '?')})",
                f"- sim violations: {w.get('violations')}",
                f"- verdict: {c.get('reason', '').strip()}",
                "",
            ]
    lines += [
        "## Taxonomy / triage",
        "",
        "- **reproduced** — the host runtime violated safety under the",
        "  exact replayed schedule: a host bug candidate.  Triage:",
        "  `python -m paxi_tpu_torch trace info corpus/<file>` for the",
        "  schedule, `trace host corpus/<file>` for the directive",
        "  projection, then turn it into a regression test driving the",
        "  directives through `trace.host.apply_immediate`.",
        "- **diverged** — the host stayed safe: either the sim models a",
        "  fault the host tolerates (modeling gap — compare the kernel",
        "  against the host handler) or the occurrence-indexed",
        "  projection aimed at a send the host never made (check the",
        "  replay's fabric stats in HUNT_REPORT.json).",
        "- **unmappable** — the witness needs events the host surface",
        "  cannot express exactly (baselined kernel-internal mailboxes,",
        "  or message duplication), or host replay was off",
        "  (`--no-host`).  Anything else means a TRACE_MSG_MAP lost",
        "  coverage (paxi-lint PXT302 will also fire).",
        "",
    ]
    return "\n".join(lines)
