"""The divergence-hunting campaign engine (the port's copy of the JAX
package's ``hunt/engine.py``).

One campaign is a budgeted sweep of the adversarial case matrix
(``hunt/cases.py``), per protocol:

    fuzz the sim  ->  capture each violating run as a trace
                  ->  dedup against the corpus (schedule hash)
                  ->  ddmin-shrink new witnesses to minimal schedules
                  ->  replay the minimal witness on the host runtime
                      through the virtual-clock fabric (on the CPU)
                  ->  classify: reproduced / diverged / unmappable

State lives under the campaign directory (default ``build/hunt/`` in the
checkout, apart from the JAX package's ``hunt/``)::

    state.json        # resumable progress: done runs + witness verdicts
    corpus/           # deduplicated witness store (hunt/corpus.py)
    HUNT_REPORT.json  # machine-readable campaign report
    HUNT_REPORT.md    # human triage report

``state.json`` (version 1), the corpus and the reports are the JAX
package's formats, equal to its campaign's apart from ``wall_s``.  Every
completed (case, schedule, seed) run is recorded before the next starts,
so an interrupted campaign resumes where it left off, and a raised
budget extends the seed stream.  The runs go on
``device``: the card unless ``"cpu"`` is asked for; the host replay
(on by default) runs every protocol's asyncio host twin on the CPU.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

from paxi_tpu_torch.hunt import cases as hc
from paxi_tpu_torch.hunt.classify import classify_witness
from paxi_tpu_torch.hunt.corpus import Corpus

_STATE_VERSION = 1
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def default_campaign_dir() -> str:
    return str(BUILD_DIR / "hunt")


def default_traces_dir() -> str:
    """The port's fuzz soak dump directory, the corpus's first seed."""
    return str(BUILD_DIR / "traces")


class Campaign:
    def __init__(self, root=None, protocols: Optional[List[str]] = None,
                 budget: int = 5, quick: bool = False,
                 shrink_trials: int = 120, host_replay: bool = True,
                 traces_dir: Optional[str] = None, log=None, device=None):
        self.root = Path(default_campaign_dir() if root is None else root)
        self.cases = hc.hunt_cases(protocols, quick=quick)
        if protocols:
            missing = sorted(set(protocols) - set(self.cases))
            if missing:
                raise KeyError(f"no hunt cases for protocols {missing}; "
                               f"have {sorted(set(c[0] for c in hc.CASES + hc.DEMO_CASES))}")
        self.root.mkdir(parents=True, exist_ok=True)
        self.corpus = Corpus(self.root / "corpus")
        self.budget = int(budget)
        self.quick = quick
        self.shrink_trials = shrink_trials
        self.host_replay = host_replay
        self.device = device
        self.traces_dir = (default_traces_dir() if traces_dir is None
                           else traces_dir)
        self.log = log or (lambda m: print(m, flush=True))
        self._state_path = self.root / "state.json"
        self.state = self._load_state()
        # one runner per (protocol, geometry, schedule), reused by later
        # rounds of the seed stream
        self._run_cache: Dict[tuple, object] = {}

    # ---- state -----------------------------------------------------------
    def _load_state(self) -> dict:
        if self._state_path.exists():
            with open(self._state_path) as f:
                st = json.load(f)
            if st.get("version") != _STATE_VERSION:
                raise ValueError(
                    f"{self._state_path}: campaign state v"
                    f"{st.get('version')} != v{_STATE_VERSION}; start a "
                    "fresh --dir")
            return st
        return {"version": _STATE_VERSION, "seeded": False,
                "done": {}, "runs": [], "witnesses": {}}

    def _save_state(self) -> None:
        tmp = str(self._state_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
        os.replace(tmp, self._state_path)

    # ---- planning --------------------------------------------------------
    def _plan(self, protocol: str) -> List[tuple]:
        """The next runs for ``protocol``: the deterministic (case,
        schedule, seed) enumeration minus completed runs, capped at
        ``budget`` completed + planned."""
        done = set(self.state["done"].get(protocol, []))
        plan, total = [], len(done)
        rounds = 0
        while total + len(plan) < self.budget and rounds < 10_000:
            for ci, (_, cfg, scheds, groups, steps, pkey) in enumerate(
                    self.cases[protocol]):
                for fz in scheds:
                    key = f"{ci}:{hc.sched_name(fz)}:{rounds}"
                    if key in done or total + len(plan) >= self.budget:
                        continue
                    plan.append((key, cfg, fz, rounds, groups, steps,
                                 pkey))
            rounds += 1
        return plan

    # ---- one fuzz run ----------------------------------------------------
    def _run_one(self, protocol: str, key: str, cfg, fz, seed: int,
                 groups: int, steps: int, pkey: str) -> dict:
        from paxi_tpu_torch import random as tr
        from paxi_tpu_torch.protocols import sim_protocol
        from paxi_tpu_torch.sim import make_run

        proto = sim_protocol(protocol)
        t0 = time.perf_counter()
        ck = (protocol, cfg, fz)
        run = self._run_cache.get(ck)
        if run is None:
            run = self._run_cache[ck] = make_run(proto, cfg, fz,
                                                 device=self.device)
        _, metrics, viols = run(tr.PRNGKey(seed), groups, steps)
        v = int(viols)
        rec = {"protocol": protocol, "run": key,
               "schedule": hc.sched_name(fz), "seed": seed,
               "groups": groups, "steps": steps, "violations": v,
               "progress": int(metrics[pkey]),
               "wall_s": round(time.perf_counter() - t0, 3)}
        if v == 0:
            return rec
        rec.update(self._process_witness(proto, protocol, cfg, fz, seed,
                                         groups, steps))
        return rec

    def _seen(self, h: str) -> bool:
        """Has this schedule hash already been through the classifier
        (as a capture or as a minimal witness)?"""
        ws = self.state["witnesses"]
        return h in ws or any(w.get("capture") == h for w in ws.values())

    def _classification(self, trace) -> dict:
        try:
            c = classify_witness(trace, host_replay=self.host_replay)
            self.log(f"  -> {c.outcome}: {c.reason}")
            return c.to_json()
        except Exception:
            self.log("  -> UNCLASSIFIED (classifier error)")
            return {"outcome": "unclassified",
                    "reason": traceback.format_exc(limit=3)}

    def _process_witness(self, proto, protocol: str, cfg, fz, seed: int,
                         groups: int, steps: int) -> dict:
        from paxi_tpu_torch import trace as tr

        t = tr.capture(proto, cfg, fz, seed, groups, steps,
                       proto_name=protocol, device=self.device)
        if t is None:
            return {"witness": None, "note": "violation did not recapture"}
        h, new = self.corpus.add(t, origin=f"hunt:{protocol}:s{seed}")
        if not new and self._seen(h):
            return {"witness": h, "note": "duplicate schedule (corpus hit)"}
        self.log(f"  witness {h[:16]} ({t.n_events()} events) — shrinking")
        wit = {"protocol": protocol, "capture": h,
               "violations": int(t.meta.get("group_violations", 0)),
               "events_before": t.n_events()}
        try:
            mini, sstats = tr.shrink(t, proto,
                                     max_trials=self.shrink_trials,
                                     device=self.device)
            mh, _ = self.corpus.add(mini,
                                    origin=f"shrunk:{h[:16]}")
            # ``trials`` is the key the reference reads, which its shrink
            # never sets (it says ``replays``): kept so state.json matches
            wit.update(minimal=mh, events_after=mini.n_events(),
                       shrink_trials=sstats.get("trials"))
        except ValueError as e:
            # a capture that does not reproduce under shrink's oracle is
            # still classifiable from the unshrunk schedule
            mini = t
            wit.update(minimal=h, events_after=t.n_events(),
                       shrink_error=str(e))
        wit["classification"] = self._classification(mini)
        self.state["witnesses"][wit.get("minimal") or h] = wit
        return {"witness": h,
                "outcome": wit["classification"]["outcome"]}

    # ---- the campaign ----------------------------------------------------
    def run(self) -> dict:
        if not self.state["seeded"]:
            added, skipped = self.corpus.seed_from(self.traces_dir)
            self.state["seeded"] = True
            if added or skipped:
                self.log(f"corpus: seeded {added} trace(s) from "
                         f"{self.traces_dir} ({skipped} skipped)")
            self._save_state()
        for protocol in sorted(self.cases):
            plan = self._plan(protocol)
            if not plan:
                continue
            self.log(f"{protocol}: {len(plan)} run(s) "
                     f"({len(self.state['done'].get(protocol, []))} done)")
            for key, cfg, fz, seed, groups, steps, pkey in plan:
                rec = self._run_one(protocol, key, cfg, fz, seed,
                                    groups, steps, pkey)
                self.state["runs"].append(rec)
                self.state["done"].setdefault(protocol, []).append(key)
                self._save_state()
                if rec["violations"]:
                    self.log(f"  {key}: {rec['violations']} violation(s)")
        self._classify_backlog()
        return self.write_report()

    def _classify_backlog(self) -> None:
        """Verdicts for corpus entries that never went through the
        classifier: seeded traces of the campaign's protocols."""
        for h, e in sorted(self.corpus.index.items(),
                           key=lambda kv: kv[1]["ordinal"]):
            if e["protocol"] not in self.cases or self._seen(h):
                continue
            self.log(f"backlog witness {h[:16]} ({e['protocol']}, "
                     f"{e['origin']})")
            wit = {"protocol": e["protocol"], "capture": h, "minimal": h,
                   "violations": e["violations"],
                   "events_before": e["events"],
                   "events_after": e["events"]}
            wit["classification"] = self._classification(
                self.corpus.load(h))
            self.state["witnesses"][h] = wit
            self._save_state()

    # ---- reporting -------------------------------------------------------
    def status(self) -> dict:
        from paxi_tpu_torch.hunt.report import summarize
        return summarize(self.state, self.corpus, self.budget,
                         sorted(self.cases))

    def write_report(self) -> dict:
        from paxi_tpu_torch.hunt.report import build_report, render_markdown
        rep = build_report(self.state, self.corpus, self.budget,
                           sorted(self.cases))
        with open(self.root / "HUNT_REPORT.json", "w") as f:
            json.dump(rep, f, indent=1)
        with open(self.root / "HUNT_REPORT.md", "w") as f:
            f.write(render_markdown(rep))
        return rep
