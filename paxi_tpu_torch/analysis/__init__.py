"""paxi-lint for the port: protocol-aware static analysis of the PyTorch
sim kernels and the asyncio host runtime (the JAX package's
``paxi_tpu/analysis``, family for family, over ``paxi_tpu_torch/``).

Rule families, in the JAX package's order:

- ``kernel-purity``         (purity.py,      PXK10x) — rewritten for
  eager PyTorch: host syncs in per-step code (PXK104), device tensors
  built from host data every step (PXK107), and the JAX package's
  determinism codes (PXK101-103, 105, 106);
- ``handler-completeness``  (handlers.py,    PXH20x) — every
  ``@register_message`` class has a registered handler, and every
  ``handle_*`` method is registered;
- ``trace-map``             (tracemap.py,    PXT30x) — registry x
  ``mailbox_spec`` x each host twin's ``TRACE_MSG_MAP`` and its message
  classes;
- ``host-concurrency``      (concurrency.py, PXC40x + PXC45x) — lockset
  checks over every ``paxi_tpu_torch`` module, deferred callbacks and
  alias mutations;
- ``quorum-safety``         (quorum.py,      PXQ50x) — intersection
  proofs: the host replicas' ``Quorum`` predicates and size comparisons
  (PXQ501, the row/column grid and the ``SwitchVote``/``SwitchSnap``
  form) and the sim kernels' ``SimConfig`` sizes (PXQ502-505);
- ``ballot-guard``          (ballots.py,     PXB60x) — message-derived
  host state writes dominated by a ballot comparison;
- ``sim-host-parity``       (parity.py,      PXS70x) — every kernel's
  ``init_state`` field matched to host state by name or ``SIM_STATE_MAP``
  (a pair rule over the registry's sim/host pairs);
- ``cross-module-flow``     (crossflow.py,   PXF80x) — epoch-plane write
  domination through ``ballot_ring``/``cell_ring`` call sites, shared-
  plane interference, cross-module quorum flow, over PyTorch's update
  forms;
- ``async-atomicity``       (asyncflow.py,   PXA90x) — read-modify-write
  across an ``await`` in the host runtime;
- ``measurement-isolation`` (measure.py,     PXM10x) — m_ planes never
  feed protocol state;
- ``fixed-cell-layout``     (layout.py,      PXL11x) — the five
  fixed-cell kernels never import a sliding-window shift;
- ``workload-purity``       (workload.py,    PXW12x) — workload draws
  come from the counter hash;
- ``span-isolation``        (spanrule.py,    PXO13x) — spans are
  write-only in the protocol host modules;
- ``replay-determinism``    (determinism.py, PXD14x) — clock, order and
  ambient taint over ``host/``, ``shard/``, ``switchnet/`` and ``obs/``,
  sanctioned only by the fabric-resolution guards;
- ``epoch-fence``           (epochfence.py,  PXE15x) — every ShardMap
  read fenced, every swap monotone;
- ``lease-flow``            (leaseflow.py,   PXR16x) — local reads behind
  ``_lease_ok``, monotone renewals, fenced elections and 2PC recovery;
- ``wire-record``           (wirerecord.py,  PXV17x) — the ``*_MAGIC``
  wire records: disjoint prefixes, pack/unpack round trips, a guarded
  interpreter chain, reserved-prefix ingress rejection.

Shared engine: ``flow.py`` (module model, guard domination, ``SymEval``,
the fabric-guard taint helpers) and ``project.py`` (the ``ProjectIndex``
over ``paxi_tpu_torch/``: import resolution, the cross-module call graph
and the wire-frame sink model; ``lint --graph`` dumps the graph as DOT).

Entry points: ``python -m paxi_tpu_torch lint [--rule ...] [--json]``
(cli.py; ``--rule`` takes family names or code prefixes like
``PXK,PXF``) and :func:`run_lint` for tests and tooling.  Intentional
exceptions live in ``analysis/baseline.toml``, each with its reason;
one-line escapes use an inline ``# paxi-lint: disable=CODE`` comment.
Purely static — no module under analysis is ever imported, so the
linter needs neither torch nor a card.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from paxi_tpu_torch.analysis import (astutil, asyncflow, ballots,
                                     concurrency, crossflow, determinism,
                                     epochfence, handlers, layout,
                                     leaseflow, measure, parity, purity,
                                     quorum, spanrule, tracemap,
                                     wirerecord, workload)
from paxi_tpu_torch.analysis.model import (LintReport, Suppression,
                                           Violation, apply_suppressions,
                                           inline_disables, load_baseline)

__all__ = ["RULES", "CODE_PREFIXES", "DEFAULT_BASELINE", "LintReport",
           "Suppression", "Violation", "repo_root", "resolve_rules",
           "run_lint"]

# rule family name -> module exposing check(root, files=None)
RULES = {
    purity.RULE: purity,
    handlers.RULE: handlers,
    tracemap.RULE: tracemap,
    concurrency.RULE: concurrency,
    quorum.RULE: quorum,
    ballots.RULE: ballots,
    parity.RULE: parity,
    crossflow.RULE: crossflow,
    asyncflow.RULE: asyncflow,
    measure.RULE: measure,
    layout.RULE: layout,
    workload.RULE: workload,
    spanrule.RULE: spanrule,
    determinism.RULE: determinism,
    epochfence.RULE: epochfence,
    leaseflow.RULE: leaseflow,
    wirerecord.RULE: wirerecord,
}

# violation-code prefix -> rule family, the CLI's short spelling
# (`--rule PXK,PXF`); PXC covers both the lockset checks and the PXC45x
# deepening (one module)
CODE_PREFIXES = {
    "PXK": purity.RULE,
    "PXH": handlers.RULE,
    "PXT": tracemap.RULE,
    "PXC": concurrency.RULE,
    "PXQ": quorum.RULE,
    "PXB": ballots.RULE,
    "PXS": parity.RULE,
    "PXF": crossflow.RULE,
    "PXA": asyncflow.RULE,
    "PXM": measure.RULE,
    "PXL": layout.RULE,
    "PXW": workload.RULE,
    "PXO": spanrule.RULE,
    "PXD": determinism.RULE,
    "PXE": epochfence.RULE,
    "PXR": leaseflow.RULE,
    "PXV": wirerecord.RULE,
}

# pair-driven rules (the registry's sim/host pairs instead of globs); the
# port's trace-map rule reads the registry through its own globs
_PAIR_RULES = {parity.RULE: parity}


def resolve_rules(specs: Sequence[str]) -> List[str]:
    """Family names, ``PXQ``-style code prefixes, and comma-separated
    combinations thereof -> unique family names (raises KeyError on
    anything unknown)."""
    out: List[str] = []
    for spec in specs:
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            name = (token if token in RULES
                    else CODE_PREFIXES.get(token.upper()))
            if name is None:
                raise KeyError(
                    f"unknown rule {token!r}; have {sorted(RULES)} "
                    f"or prefixes {sorted(CODE_PREFIXES)}")
            if name not in out:
                out.append(name)
    return out


DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.toml"


def repo_root() -> Path:
    """The directory holding the ``paxi_tpu_torch`` package."""
    return Path(__file__).resolve().parent.parent.parent


def _target_files(root: Path, rule_mod,
                  paths: Sequence[Path],
                  strict: bool = False) -> List[Path]:
    """A rule's default file set restricted to ``paths`` (files or
    directories), plus any explicitly named file outside the rule's
    globs — that is how fixture tests drive a rule over seeded
    modules.  ``strict=True`` drops that out-of-glob escape so a
    scoped run (``lint --changed``) reports exactly what a full run
    would for the same files."""
    dirs = [p.resolve() for p in paths if p.is_dir()]
    files = {p.resolve() for p in paths if p.is_file()}
    defaults = list(astutil.iter_py(root, getattr(rule_mod, "TARGETS", ())))
    wanted = [p for p in defaults
              if p.resolve() in files
              or any(str(p.resolve()).startswith(str(d) + "/")
                     for d in dirs)]
    if not strict:
        default_set = {p.resolve() for p in defaults}
        wanted += [Path(f) for f in sorted(files - default_set)]
    return sorted(set(wanted))


def run_lint(root: Optional[Path] = None,
             rules: Optional[Sequence[str]] = None,
             baseline_path: Optional[Path] = DEFAULT_BASELINE,
             paths: Optional[Sequence[Path]] = None,
             strict_targets: bool = False) -> LintReport:
    """Run the selected rule families and apply both suppression
    layers.  ``baseline_path=None`` disables the baseline (the
    "show me everything" mode).  ``strict_targets=True`` keeps every
    rule on its own globs even for explicitly named files — the
    ``lint --changed`` contract that scoped and full runs agree."""
    root = (root or repo_root()).resolve()
    selected = resolve_rules(rules) if rules else list(RULES)
    if paths is not None:
        paths = [Path(p) for p in paths]
        missing = [str(p) for p in paths if not p.exists()]
        if missing:
            raise ValueError(f"no such path(s): {', '.join(missing)}")

    raw: List[Violation] = []
    checked: set = set()
    timings: Dict[str, float] = {}
    for name in selected:
        mod = RULES[name]
        t0 = time.perf_counter()
        if name in _PAIR_RULES:
            # restriction matches the sim or host module, directories
            # match their subtrees
            for protocol, sp, hp in mod.analyzed_pairs(root, paths):
                raw.extend(mod.check_pair(protocol, sp, hp, root))
                checked.update((sp, hp))
            timings[name] = time.perf_counter() - t0
            continue
        files = (None if paths is None
                 else _target_files(root, mod, paths,
                                    strict=strict_targets))
        raw.extend(mod.check(root, files=files))
        checked.update(files if files is not None
                       else astutil.iter_py(root, mod.TARGETS))
        timings[name] = time.perf_counter() - t0

    baseline = (load_baseline(baseline_path)
                if baseline_path is not None else [])
    inline: Dict[str, Dict[int, set]] = {}
    for path in {v.path for v in raw}:
        try:
            inline[path] = inline_disables((root / path).read_text())
        except OSError:
            inline[path] = {}
    kept, dropped = apply_suppressions(raw, baseline, inline)
    # stale-baseline warnings only make sense when every rule ran over
    # the whole tree — a restricted run never exercises most entries
    complete = paths is None and set(selected) == set(RULES)
    unused = [s for s in baseline if not s.used] if complete else []
    return LintReport(violations=kept, suppressed=dropped,
                      unused_baseline=unused, checked_files=len(checked),
                      timings=timings)
