"""Quorum-safety rule family (PXQ5xx) — static intersection proofs over
the port's host replicas and sim kernels (the JAX package's
``analysis/quorum.py``).

The framework's safety story (SIGMOD'19 "Dissecting...", and the
Bipartisan Paxos decomposition in PAPERS.md) reduces every protocol to
quorum arithmetic plus ballot-guarded handlers.  The quorum half of
that obligation is *statically checkable*: every quorum a protocol
waits on is declared in source as either a :class:`core.quorum.Quorum`
predicate call (``majority()``, ``fast_quorum()``, ``grid_q1(q)``...)
or an explicit size comparison (``len(e.acked) >= self.fast``,
``op.quorum.size() >= self.W``), and every threshold is a small
floor-linear expression of the cluster size.  This rule symbolically
evaluates those thresholds (analysis/flow.SymEval — exact rational
arithmetic, so ``-(-3*n//4)`` and ``math.ceil(3*n/4)`` agree) and
proves the pairwise intersection obligations over all config sizes:

- a **phase-1 quorum** (election/prepare/recovery) must intersect
  every **phase-2 quorum** (accept/commit) on the same id universe;
- a **read quorum** must intersect every **write quorum** likewise;
- flexible grid quorums (WPaxos) intersect when ``q1 + q2 > Z``.

"All config n" means every n in ``2..MAX_N`` (and every zone count /
grid knob up to ``MAX_Z``): the thresholds this repo can express are
floor-linear with denominator <= 4, so any non-intersection has a
counterexample far below the bound; the bound is generous rather than
clever on purpose.

Scope notes: analysis is
module-local; a quorum's id *universe* is the text of its constructor
argument (``Quorum(self.cfg.ids)`` vs ``Quorum(self.zone_ids)``), and
only same-universe pairs owe each other intersection.  Bare
``len(...)``-comparison sites default to the whole-cluster universe.
Sites whose thresholds the evaluator cannot resolve are *reported*
(PXQ502) rather than skipped — silence is a proof here, so it must be
earned.

Checks:

- **PXQ501** a host-runtime phase-1 x phase-2 (or read x write) quorum
  pair on one universe can fail to intersect; the message carries the
  counterexample size
- **PXQ502** a quorum site whose threshold or receiver the analyzer
  cannot resolve symbolically
- **PXQ503** a sim-kernel quorum threshold pair (``cfg.majority`` /
  ``cfg.fast_size`` aliases, zone-grid thresholds) can fail to
  intersect
- **PXQ505** the switchnet in-fabric tier's recovery obligation
  (paxi_tpu_torch/switchnet): a module that commits on the in-network vote
  (calls ``apply_fast_commits``/``fast_commit_mask``, or — host form
  — registers a ``SwitchVote`` handler) runs a write quorum of
  {switch register}; the ONLY recovery quorum intersecting it is one
  that reads the register file, so the module must also consult it
  (sim: a ``recovery_fold`` call on the phase-1 win path; host: a
  registered ``SwitchSnap`` handler).  Skipping the read is the
  lost-fast-commit bug: a value whose only durable copy is the
  bounded register file vanishes across a leader failover.  The
  replica fall-back quorum (``cfg.majority`` aliases) x recovery
  majority pairs are enumerated for all n by the PXQ503 machinery as
  usual — together the two cover every write-path x recovery pair of
  the tier.

- **PXQ504** a rectangular-grid (rowcol) read x write pair can fail
  to intersect — the BPaxos quorum system, and the first non-majority
  system this rule proves.  The grid is also the *thrifty* variant
  (messages go to exactly the quorum), so this check subsumes the
  thrifty-quorum obligation: a thrifty write is safe
  iff the minimal sets themselves intersect, which is precisely what
  is enumerated here.  Two forms:

  - sim kernels: write sites compare a ``*_row_quorums`` tally, read
    sites a ``*_col_quorums`` tally; the per-line *fullness* threshold
    is DERIVED from the tally helper's own body (``per >= GC``) and
    must demand complete lines — a full row and a full column of one
    grid always share exactly one cell, but a row short one cell can
    dodge a column, which is the counterexample the message carries;
  - host replicas: ``Quorum.grid_row(cols)`` x ``Quorum.grid_col(cols)``
    call pairs on one universe; the predicates are modeled as
    complete-line tests (their bodies — core/quorum.py — are covered
    by a runtime structural test), so the proof obligation is that
    both sites derive the grid from the SAME ``cols`` expression for
    every geometry; a mismatch re-shapes the grid between read and
    write and loses the shared cell.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, \
    Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation

RULE = "quorum-safety"

TARGETS = (
    "paxi_tpu_torch/protocols/*/host.py",
    "paxi_tpu_torch/protocols/*/sim.py",
    "paxi_tpu_torch/protocols/*/sim_pg.py",
)

QUORUM_MODULE = "paxi_tpu_torch/core/quorum.py"
SIM_TYPES = "paxi_tpu_torch/sim/types.py"

MAX_N = 48     # cluster sizes the "for all n" proof enumerates
MAX_Z = 8      # zone counts / grid knobs likewise

PHASE1 = frozenset({"p1"})
PHASE2 = frozenset({"p2"})
ANY_PHASE = frozenset({"p1", "p2", "read", "write"})

_AMBIG = object()


# ---------------------------------------------------------------------------
# the predicate model (core/quorum.py) and SimConfig thresholds
# ---------------------------------------------------------------------------


@dataclass
class Predicates:
    """What each ``Quorum`` method means, derived from its source."""

    # name -> threshold fn: universe size n -> min acks, or None
    count: Dict[str, Callable[[int], Optional[int]]]
    # zone-structured predicates (modeled, not derived): name -> phase
    grid: Dict[str, FrozenSet[str]]
    # rectangular-grid predicates (modeled as complete-line tests;
    # core/quorum.py's bodies are covered by a runtime structural
    # test): name -> phase ("write" = row, "read" = column)
    rowcol: Dict[str, str]
    # module-level size helpers usable in thresholds:
    # name -> (params, return expr)
    funcs: Dict[str, Tuple[List[str], ast.expr]]


def _single_return(fn: ast.AST) -> Optional[ast.expr]:
    rets = [s for s in ast.walk(fn) if isinstance(s, ast.Return)]
    return rets[0].value if len(rets) == 1 else None


def load_predicates(root: Path) -> Predicates:
    """Derive each count predicate's threshold from its own body: the
    smallest ack count satisfying the returned comparison (so a quorum
    refactor in core/quorum.py re-derives the model for free)."""
    tree, _ = astutil.parse_file(root / QUORUM_MODULE)
    count: Dict[str, Callable[[int], Optional[int]]] = {}
    funcs: Dict[str, Tuple[List[str], ast.expr]] = {}
    for node in tree.body:
        if isinstance(node, astutil.FuncNode):
            expr = _single_return(node)
            if expr is not None:
                funcs[node.name] = (
                    [a.arg for a in node.args.args], expr)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if not isinstance(item, astutil.FuncNode):
                continue
            expr = _single_return(item)
            if expr is None:
                continue
            # the ack-count term is the len(...) call in the predicate
            lens = [n for n in ast.walk(expr)
                    if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id == "len"]
            if len(lens) != 1 or not isinstance(expr, (ast.Compare,
                                                       ast.BoolOp)):
                continue
            key = ast.unparse(lens[0])

            def mk(pred_expr=expr, count_key=key):
                def thresh(n: int) -> Optional[int]:
                    ev = flow.SymEval({"self.n": Fraction(n)}, funcs=funcs)
                    return flow.min_satisfying(pred_expr, count_key,
                                               ev, n)
                return thresh

            count[item.name] = mk()
    grid = {"grid_q1": PHASE1, "grid_q2": PHASE2}
    rowcol = {"grid_row": "write", "grid_col": "read"}
    return Predicates(count=count, grid=grid, rowcol=rowcol, funcs=funcs)


def load_sim_props(root: Path) -> Dict[str, Callable[[int],
                                                     Optional[int]]]:
    """SimConfig's derived quorum sizes (``majority``, ``fast_size``):
    property name -> size fn of n_replicas."""
    tree, _ = astutil.parse_file(root / SIM_TYPES)
    out: Dict[str, Callable[[int], Optional[int]]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name == "SimConfig"):
            continue
        for item in node.body:
            if not isinstance(item, astutil.FuncNode):
                continue
            if "property" not in astutil.decorator_names(item):
                continue
            expr = _single_return(item)
            if expr is None:
                continue

            def mk(e=expr):
                def size(n: int) -> Optional[int]:
                    v = flow.SymEval(
                        {"self.n_replicas": Fraction(n)}).eval(e)
                    return int(v) if v is not None and v.denominator == 1 \
                        else None
                return size

            out[item.name] = mk()
    return out


# ---------------------------------------------------------------------------
# per-module symbol resolution
# ---------------------------------------------------------------------------


class Resolver:
    """Chase names through their (unique) assignments, module-wide.

    ``self.X`` resolves through any class's single ``self.X = expr``
    assignment; a bare name through module-level then unique
    function-local single assignments.  Conflicting assignments make a
    name unresolvable (the rule then reports PXQ502 rather than
    guessing which definition a site sees)."""

    def __init__(self, tree: ast.Module):
        self.attr: Dict[str, object] = {}
        self.local: Dict[str, object] = {}
        self.modlvl: Dict[str, object] = {}

        def put(table: Dict[str, object], key: str,
                expr: ast.expr) -> None:
            old = table.get(key)
            if old is None:
                table[key] = expr
            elif old is not _AMBIG and ast.unparse(old) != \
                    ast.unparse(expr):
                table[key] = _AMBIG

        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                put(self.modlvl, node.targets[0].id, node.value)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            targets = node.targets
            values: List[Tuple[ast.expr, ast.expr]] = []
            if len(targets) == 1 and isinstance(targets[0], ast.Tuple) \
                    and isinstance(node.value, ast.Tuple) and \
                    len(targets[0].elts) == len(node.value.elts):
                values = list(zip(targets[0].elts, node.value.elts))
            else:
                values = [(t, node.value) for t in targets]
            for t, v in values:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    put(self.attr, t.attr, v)
                elif isinstance(t, ast.Name):
                    put(self.local, t.id, v)

    def __call__(self, key: str) -> Optional[ast.expr]:
        if key.startswith("self."):
            hit = self.attr.get(key[5:])
        else:
            hit = self.modlvl.get(key)
            if hit is None:
                hit = self.local.get(key)
        return None if hit is _AMBIG else hit


# ---------------------------------------------------------------------------
# quorum sites
# ---------------------------------------------------------------------------


@dataclass
class Site:
    kind: str                 # "count" | "grid" | "rowcol"
    line: int
    col: int
    text: str
    universe: str
    phases: FrozenSet[str]
    # count: universe size n -> min quorum size
    size_fn: Optional[Callable[[int], Optional[int]]] = None
    # grid: (zones, grid_q2 knob) -> zone-majorities required
    # rowcol/sim: (rows, cols) -> complete lines required
    # rowcol/host: (rows, cols) -> the site's resolved ``cols`` arg
    zones_fn: Optional[Callable[[int, int], Optional[int]]] = None
    # rowcol/sim only: (rows, cols) -> cells per counted line, derived
    # from the ``*_row_quorums``/``*_col_quorums`` helper body — the
    # fullness the intersection proof hinges on
    fill_fn: Optional[Callable[[int, int], Optional[int]]] = None
    resolved: bool = True
    why_unresolved: str = ""


_P1_HINTS = ("p1", "phase1", "prepare", "become_leader", "elect",
             "recover", "seq1")
_P2_HINTS = ("p2", "accept", "commit")


def _phases(fn_name: str, recv: str, pred: str) -> FrozenSet[str]:
    name = f"{fn_name} {recv} {pred}".lower()
    out: Set[str] = set()
    if any(h in name for h in _P1_HINTS):
        out.add("p1")
    if any(h in name for h in _P2_HINTS):
        out.add("p2")
    if "read" in name:
        out.add("read")
    if "write" in name:
        out.add("write")
    return frozenset(out) or ANY_PHASE


def _norm_universe(expr: ast.expr) -> str:
    text = ast.unparse(expr)
    return text[5:] if text.startswith("self.") else text


def _enclosing_functions(tree: ast.Module) -> Dict[int, str]:
    """id(node) -> name of the innermost def containing it."""
    out: Dict[int, str] = {}

    def walk(node: ast.AST, fn: str) -> None:
        for child in ast.iter_child_nodes(node):
            here = child.name if isinstance(child, astutil.FuncNode) \
                else fn
            out[id(child)] = here
            walk(child, here)

    walk(tree, "<module>")
    return out


def _universes(tree: ast.Module) -> Dict[str, Set[str]]:
    """quorum-holding name (local name or attribute tail) -> universe
    texts of the ``Quorum(...)`` constructions flowing into it."""
    local: Dict[str, Set[str]] = {}
    attr: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                (astutil.dotted_name(node.value.func) or ""
                 ).split(".")[-1] == "Quorum" and node.value.args:
            univ = _norm_universe(node.value.args[0])
            for t in node.targets:
                if isinstance(t, ast.Name):
                    local.setdefault(t.id, set()).add(univ)
                elif isinstance(t, ast.Attribute):
                    attr.setdefault(t.attr, set()).add(univ)
        # Entry(..., quorum=q): the local's universe flows to the field
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and isinstance(kw.value, ast.Name) and \
                        kw.value.id in local:
                    attr.setdefault(kw.arg, set()).update(
                        local[kw.value.id])
    merged = dict(attr)
    for k, v in local.items():
        merged.setdefault(k, set()).update(v)
    return merged


def _size_term(node: ast.expr) -> Optional[Tuple[str, ast.expr]]:
    """(receiver-name, receiver-expr) when ``node`` is a quorum size
    term: ``X.size()`` or ``len(X)``."""
    if isinstance(node, ast.Call) and not node.args and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "size":
        recv = node.func.value
        tail = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else None)
        if tail:
            return tail, recv
    if isinstance(node, ast.Call) and len(node.args) == 1 and \
            isinstance(node.func, ast.Name) and node.func.id == "len":
        # only ack/vote collections count — `len(order)`-style list
        # bookkeeping is not a quorum tally
        arg = node.args[0]
        name = (arg.attr if isinstance(arg, ast.Attribute)
                else arg.id if isinstance(arg, ast.Name) else "")
        if any(h in name.lower() for h in ("ack", "vote", "quorum",
                                           "promis", "replies")):
            return "len", arg
    return None


def _count_env(n: int) -> Dict[str, Fraction]:
    f = Fraction(n)
    return {"self.n": f, "cfg.n": f, "self.cfg.n": f, "n": f,
            "len(cfg.ids)": f, "len(self.cfg.ids)": f,
            "len(self.ids)": f, "len(ids)": f}


def _grid_env(z: int, q2: int) -> Dict[str, Fraction]:
    fz = Fraction(z)
    return {"cfg.n_zones": fz, "self.cfg.n_zones": fz,
            "len(cfg.zones())": fz, "len(self.cfg.zones())": fz,
            "z": fz, "cfg.grid_q2": Fraction(q2),
            "self.cfg.grid_q2": Fraction(q2)}


def _rowcol_env(rows: int, cols: int) -> Dict[str, Fraction]:
    fr, fc = Fraction(rows), Fraction(cols)
    return {"cfg.grid_rows": fr, "self.cfg.grid_rows": fr,
            "cfg.grid_cols": fc, "self.cfg.grid_cols": fc}


def host_sites(tree: ast.Module, preds: Predicates,
               resolver: Resolver) -> List[Site]:
    universes = _universes(tree)
    owner = _enclosing_functions(tree)
    sites: List[Site] = []

    def threshold_fn(expr: ast.expr,
                     strict: bool) -> Callable[[int], Optional[int]]:
        def size(n: int) -> Optional[int]:
            ev = flow.SymEval(_count_env(n), resolve=resolver,
                              funcs=preds.funcs)
            v = ev.eval(expr)
            if v is None:
                return None
            # min integer size passing the comparison: `size > T` is
            # floor(T)+1 (NOT ceil(T)+1 — for fractional T like n/3
            # those differ), `size >= T` is ceil(T)
            if strict:
                return int(v.__floor__()) + 1
            return int(-((-v).__floor__()))
        return size

    def grid_fn(expr: ast.expr) -> Callable[[int, int], Optional[int]]:
        def zones(z: int, q2: int) -> Optional[int]:
            ev = flow.SymEval(dict(_grid_env(z, q2), **_count_env(z)),
                              resolve=resolver, funcs=preds.funcs)
            v = ev.eval(expr)
            return int(v) if v is not None and v.denominator == 1 \
                else None
        return zones

    def rowcol_fn(expr: ast.expr) -> Callable[[int, int], Optional[int]]:
        def cols(rows: int, cols_: int) -> Optional[int]:
            ev = flow.SymEval(dict(_rowcol_env(rows, cols_),
                                   **_count_env(rows * cols_)),
                              resolve=resolver, funcs=preds.funcs)
            v = ev.eval(expr)
            return int(v) if v is not None and v.denominator == 1 \
                else None
        return cols

    for node in ast.walk(tree):
        # predicate calls: X.majority(), e.quorum.grid_q2(self.q2), ...
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            pred = node.func.attr
            recv = node.func.value
            tail = recv.attr if isinstance(recv, ast.Attribute) else (
                recv.id if isinstance(recv, ast.Name) else "")
            fn_name = owner.get(id(node), "")
            if pred in preds.rowcol:
                site = Site(kind="rowcol", line=node.lineno,
                            col=node.col_offset,
                            text=ast.unparse(node),
                            universe=" | ".join(sorted(
                                universes.get(tail, {"cfg.ids"}))),
                            phases=frozenset({preds.rowcol[pred]}))
                if node.args:
                    site.zones_fn = rowcol_fn(node.args[0])
                    if site.zones_fn(2, 3) is None:
                        site.resolved = False
                        site.why_unresolved = (
                            f"grid `cols` argument "
                            f"`{ast.unparse(node.args[0])}` does not "
                            "evaluate symbolically")
                else:
                    site.resolved = False
                    site.why_unresolved = "grid predicate without a " \
                                          "cols argument"
                sites.append(site)
                continue
            if pred in preds.grid:
                site = Site(kind="grid", line=node.lineno,
                            col=node.col_offset,
                            text=ast.unparse(node),
                            universe=" | ".join(sorted(
                                universes.get(tail, {"cfg.ids"}))),
                            phases=preds.grid[pred])
                if node.args:
                    site.zones_fn = grid_fn(node.args[0])
                else:
                    site.resolved = False
                    site.why_unresolved = "grid predicate without a " \
                                          "zone-count argument"
                sites.append(site)
                continue
            if pred in preds.count:
                univs = universes.get(tail)
                site = Site(kind="count", line=node.lineno,
                            col=node.col_offset,
                            text=ast.unparse(node),
                            universe=" | ".join(sorted(univs))
                            if univs else "?",
                            phases=_phases(fn_name, tail, pred),
                            size_fn=preds.count[pred])
                if not univs:
                    site.resolved = False
                    site.why_unresolved = (
                        f"receiver `{tail or ast.unparse(recv)}` binds "
                        "to no Quorum(...) construction in this module")
                sites.append(site)
                continue
        # explicit size comparisons: len(e.acked) >= self.fast,
        # op.quorum.size() >= self.W, ...
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            left, op, right = node.left, node.ops[0], node.comparators[0]
            for a, b, opc in ((left, right, op), (right, left, op)):
                term = _size_term(a)
                if term is None:
                    continue
                if not isinstance(opc, (ast.Gt, ast.GtE, ast.Lt,
                                        ast.LtE)):
                    continue
                # normalize to the pass-side threshold `size >= k`:
                # `size > T` and `T >= size` (fail side) both mean the
                # quorum is satisfied from T+1; `size >= T` / `size < T`
                # (early return) from ceil(T)
                if a is left:
                    strict = isinstance(opc, (ast.Gt, ast.LtE))
                else:
                    strict = isinstance(opc, (ast.Lt, ast.GtE))
                tail, recv_expr = term
                fn = threshold_fn(b, strict)
                a5, b29 = fn(5), fn(29)
                if a5 is not None and a5 == b29:
                    continue   # a resolvable CONSTANT is not a quorum
                univs = (universes.get(tail)
                         if tail != "len" else None) or {"cfg.ids"}
                fn_name = owner.get(id(node), "")
                site = Site(
                    kind="count", line=node.lineno, col=node.col_offset,
                    text=ast.unparse(node),
                    universe=" | ".join(sorted(univs)),
                    phases=_phases(fn_name, ast.unparse(recv_expr), ""),
                    size_fn=fn)
                if a5 is None and b29 is None:
                    site.resolved = False
                    site.why_unresolved = (
                        f"threshold `{ast.unparse(b)}` does not "
                        "evaluate symbolically")
                sites.append(site)
                break
    return sites


# ---------------------------------------------------------------------------
# pair checking
# ---------------------------------------------------------------------------


def _owes_intersection(a: Site, b: Site) -> bool:
    """p1 x p2 or read x write across the two sites (in either order).
    Same-phase pairs owe nothing: two phase-2 quorums of one ballot
    never disagree (same leader), and FPaxos explicitly drops the
    p1 x p1 requirement."""
    def cross(x: FrozenSet[str], y: FrozenSet[str]) -> bool:
        return ("p1" in x and "p2" in y) or ("read" in x and "write" in y)
    return cross(a.phases, b.phases) or cross(b.phases, a.phases)


def _check_count_pair(a: Site, b: Site) -> Optional[Tuple[int, int, int]]:
    for n in range(2, MAX_N + 1):
        sa, sb = a.size_fn(n), b.size_fn(n)
        if sa is None or sb is None:
            continue
        if 0 < sa <= n and 0 < sb <= n and sa + sb <= n:
            return n, sa, sb
    return None


def _check_grid_pair(a: Site, b: Site) -> Optional[Tuple[int, int, int]]:
    for z in range(1, MAX_Z + 1):
        for q2 in range(1, z + 1):
            za, zb = a.zones_fn(z, q2), b.zones_fn(z, q2)
            if za is None or zb is None:
                continue
            if 0 < za <= z and 0 < zb <= z and za + zb <= z:
                return z, za, zb
    return None


def _check_rowcol_pair(a: Site, b: Site) -> Optional[Tuple[int, int, str]]:
    """Grid read x write intersection over every rows x cols geometry.

    A set of COMPLETE rows and a set of COMPLETE columns of one grid
    always share a cell (row i x column j meet at (i, j)), so the
    obligations are: at least one line on each side, derived fullness
    (sim tallies must count only full lines), and — host form — both
    predicates shaping the grid with the same ``cols``.  Returns
    (rows, cols, why) for the first geometry that breaks one."""
    w, r = (a, b) if "write" in a.phases else (b, a)
    for gr in range(1, MAX_Z + 1):
        for gc in range(1, MAX_Z + 1):
            if w.fill_fn is not None and r.fill_fn is not None:
                tw, fw = w.zones_fn(gr, gc), w.fill_fn(gr, gc)
                tr, fr = r.zones_fn(gr, gc), r.fill_fn(gr, gc)
                if None in (tw, fw, tr, fr):
                    continue
                if tw < 1 or tr < 1:
                    return (gr, gc, "a quorum satisfiable with ZERO "
                            f"complete lines ({tw} rows / {tr} columns "
                            "required)")
                if tw > gr or tr > gc:
                    continue   # unsatisfiable: nothing ever commits
                if fw < gc:
                    return (gr, gc, f"write rows count as complete at "
                            f"{fw}/{gc} cells — a short row dodges "
                            "column " f"{fw}")
                if fr < gr:
                    return (gr, gc, f"read columns count as complete "
                            f"at {fr}/{gr} cells — a short column "
                            f"dodges row {fr}")
            else:
                cw, cr = w.zones_fn(gr, gc), r.zones_fn(gr, gc)
                if cw is None or cr is None:
                    continue
                if cw != cr:
                    return (gr, gc, "grid geometry mismatch: "
                            f"grid_row(cols={cw}) vs "
                            f"grid_col(cols={cr}) re-shape the grid "
                            "between write and read")
    return None


def _pair_violations(sites: List[Site], relpath: str,
                     code: str, scope: str) -> List[Violation]:
    out: List[Violation] = []
    by_universe: Dict[str, List[Site]] = {}
    for s in sites:
        if s.resolved:
            by_universe.setdefault(s.universe, []).append(s)
    seen: Set[Tuple[int, int]] = set()
    for univ, group in by_universe.items():
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                if a.kind != b.kind or not _owes_intersection(a, b):
                    continue
                key = (a.line, b.line)
                if key in seen:
                    continue
                if a.kind == "rowcol":
                    bad_rc = _check_rowcol_pair(a, b)
                    if bad_rc is None:
                        continue
                    seen.add(key)
                    gr, gc, why = bad_rc
                    out.append(Violation(
                        rule=RULE, code="PXQ504", path=relpath,
                        line=a.line, col=a.col,
                        message=(
                            f"{scope} grid quorums `{a.text}` (line "
                            f"{a.line}, {'/'.join(sorted(a.phases))}) "
                            f"and `{b.text}` (line {b.line}, "
                            f"{'/'.join(sorted(b.phases))}) on "
                            f"universe `{univ}` can fail to intersect "
                            f"at a {gr}x{gc} grid: {why}")))
                    continue
                if a.kind == "count":
                    bad = _check_count_pair(a, b)
                    unit = "sizes"
                else:
                    bad = _check_grid_pair(a, b)
                    unit = "zone-quorums"
                if bad is None:
                    continue
                seen.add(key)
                n, sa, sb = bad
                out.append(Violation(
                    rule=RULE, code=code, path=relpath,
                    line=a.line, col=a.col,
                    message=(
                        f"{scope} quorums `{a.text}` (line {a.line}, "
                        f"phases {'/'.join(sorted(a.phases))}) and "
                        f"`{b.text}` (line {b.line}, phases "
                        f"{'/'.join(sorted(b.phases))}) on universe "
                        f"`{univ}` can fail to intersect: at "
                        f"{'Z' if a.kind == 'grid' else 'n'}={n} the "
                        f"{unit} are {sa}+{sb} <= {n}")))
    return out


# ---------------------------------------------------------------------------
# sim kernels
# ---------------------------------------------------------------------------


def _line_fullness(tree: ast.Module, helper: str, resolver: Resolver
                   ) -> Optional[Callable[[int, int], Optional[int]]]:
    """Derive a ``*_row_quorums``/``*_col_quorums`` helper's per-line
    fullness threshold from its own body: the single ``per >= K``
    comparison deciding when a line counts as complete.  Returns None
    when the body has no unique derivable comparison — the site is
    then reported (PXQ502), not silently trusted."""
    fn = next((n for n in tree.body
               if isinstance(n, astutil.FuncNode) and n.name == helper),
              None)
    if fn is None:
        return None
    cmps = [n for n in ast.walk(fn)
            if isinstance(n, ast.Compare) and len(n.ops) == 1
            and isinstance(n.ops[0], (ast.GtE, ast.Gt))]
    if len(cmps) != 1:
        return None
    thr = cmps[0].comparators[0]
    strict = isinstance(cmps[0].ops[0], ast.Gt)

    def fill(rows: int, cols: int) -> Optional[int]:
        ev = flow.SymEval(_rowcol_env(rows, cols), resolve=resolver)
        v = ev.eval(thr)
        if v is None or v.denominator != 1:
            return None
        return int(v) + (1 if strict else 0)

    return fill


def sim_sites(tree: ast.Module,
              props: Dict[str, Callable[[int], Optional[int]]],
              resolver: Resolver) -> List[Site]:
    """Quorum thresholds a sim kernel consumes: aliases of the
    SimConfig-derived sizes (``MAJ = cfg.majority``), zone-grid
    thresholds compared against ``*_zone_quorums(...)`` tallies, and
    rectangular-grid thresholds compared against ``*_row_quorums``/
    ``*_col_quorums`` tallies (the BPaxos quorum system)."""
    sites: List[Site] = []
    zone_locals: Set[str] = set()
    rowcol_locals: Dict[str, Tuple[str, str]] = {}  # name -> (phase, helper)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        pairs: List[Tuple[ast.expr, ast.expr]] = []
        if len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Tuple) and \
                isinstance(node.value, ast.Tuple) and \
                len(node.targets[0].elts) == len(node.value.elts):
            pairs = list(zip(node.targets[0].elts, node.value.elts))
        else:
            pairs = [(t, node.value) for t in node.targets]
        for t, v in pairs:
            if not isinstance(t, ast.Name):
                continue
            dn = astutil.dotted_name(v) or ""
            prop = dn.split(".")[-1]
            if dn.startswith("cfg.") and prop in props:
                sites.append(Site(
                    kind="count", line=node.lineno, col=node.col_offset,
                    text=f"{t.id} = {dn}", universe="replicas",
                    phases=ANY_PHASE, size_fn=props[prop]))
            if isinstance(v, ast.Call):
                callee = (astutil.dotted_name(v.func) or ""
                          ).split(".")[-1]
                if callee.endswith("zone_quorums"):
                    zone_locals.add(t.id)
                elif callee.endswith("row_quorums"):
                    rowcol_locals[t.id] = ("write", callee)
                elif callee.endswith("col_quorums"):
                    rowcol_locals[t.id] = ("read", callee)
    # compares of rowcol tallies against line-count thresholds: the
    # lines-needed side comes from the compare, the per-line fullness
    # from the tally helper's own body
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.GtE, ast.Gt))):
            continue
        lhs_names = {n.id for n in ast.walk(node.left)
                     if isinstance(n, ast.Name)}
        hit = sorted(lhs_names & set(rowcol_locals))
        if not hit:
            continue
        phase, helper = rowcol_locals[hit[0]]
        thr = node.comparators[0]
        strict = isinstance(node.ops[0], ast.Gt)

        def lines_fn(e=thr, s=strict):
            def lines(rows: int, cols: int) -> Optional[int]:
                ev = flow.SymEval(_rowcol_env(rows, cols),
                                  resolve=resolver)
                v = ev.eval(e)
                if v is None or v.denominator != 1:
                    return None
                return int(v) + (1 if s else 0)
            return lines

        site = Site(kind="rowcol", line=node.lineno,
                    col=node.col_offset, text=ast.unparse(node),
                    universe="grid", phases=frozenset({phase}),
                    zones_fn=lines_fn(),
                    fill_fn=_line_fullness(tree, helper, resolver))
        if site.fill_fn is None:
            site.resolved = False
            site.why_unresolved = (
                f"tally helper `{helper}` has no unique derivable "
                "per-line completeness comparison")
        elif site.zones_fn(2, 3) is None:
            site.resolved = False
            site.why_unresolved = (f"line-count threshold "
                                   f"`{ast.unparse(thr)}` does not "
                                   "evaluate symbolically")
        sites.append(site)
    # compares of zone tallies against grid thresholds
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.GtE, ast.Gt))):
            continue
        lhs_names = {n.id for n in ast.walk(node.left)
                     if isinstance(n, ast.Name)}
        if not (lhs_names & zone_locals):
            continue
        thr = node.comparators[0]
        thr_name = (thr.id if isinstance(thr, ast.Name)
                    else ast.unparse(thr)).lower()
        phases = (PHASE1 if "1" in thr_name
                  else PHASE2 if "2" in thr_name else ANY_PHASE)

        def zfn(e=thr, strict=isinstance(node.ops[0], ast.Gt)):
            def zones(z: int, q2: int) -> Optional[int]:
                ev = flow.SymEval(dict(_grid_env(z, q2)),
                                  resolve=resolver)
                v = ev.eval(e)
                if v is None or v.denominator != 1:
                    return None
                return int(v) + (1 if strict else 0)
            return zones

        sites.append(Site(
            kind="grid", line=node.lineno, col=node.col_offset,
            text=ast.unparse(node), universe="zones", phases=phases,
            zones_fn=zfn()))
    return sites


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


# switchnet structural obligation (PXQ505): fast-path commit sites and
# the register reads that keep them recoverable, by callable name
_SWITCH_FAST = frozenset({"apply_fast_commits", "fast_commit_mask"})
_SWITCH_RECOVER = "recovery_fold"


def check_switchnet(tree: ast.Module, relpath: str,
                    is_sim: bool) -> List[Violation]:
    """The in-network vote register x recovery quorum intersection
    (module docstring, PXQ505): presence of the fast path obliges
    presence of the register read on the recovery path."""
    called: Set[str] = set()
    registered: Set[str] = set()
    lines: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = (astutil.dotted_name(node.func) or "").split(".")[-1]
        called.add(name)
        lines.setdefault(name, node.lineno)
        if name == "register" and node.args:
            arg0 = astutil.dotted_name(node.args[0])
            if arg0:
                registered.add(arg0.split(".")[-1])
    out: List[Violation] = []
    if is_sim:
        fast = sorted(called & _SWITCH_FAST)
        if fast and _SWITCH_RECOVER not in called:
            out.append(Violation(
                rule=RULE, code="PXQ505", path=relpath,
                line=lines[fast[0]], col=0,
                message=(
                    f"in-network fast-path commit (`{fast[0]}`) without "
                    f"a `{_SWITCH_RECOVER}` register read on the "
                    "phase-1 win path — the {switch} write quorum "
                    "intersects no recovery quorum, so a vote-only "
                    "commit is lost across leader failover")))
    elif "SwitchVote" in registered and "SwitchSnap" not in registered:
        out.append(Violation(
            rule=RULE, code="PXQ505", path=relpath,
            line=lines.get("register", 1), col=0,
            message=(
                "host replica commits on SwitchVote but registers no "
                "SwitchSnap handler — recovery never reads the switch "
                "register file, so a vote-only commit is lost across "
                "leader failover")))
    return out


def _is_sim_module(tree: ast.Module) -> bool:
    """Sim kernels all export a top-level ``mailbox_spec``; host
    modules never do — steadier than filename matching (fixtures)."""
    return any(isinstance(n, astutil.FuncNode)
               and n.name == "mailbox_spec" for n in tree.body)


def check_file(path: Path, root: Path, preds: Optional[Predicates],
               props: Dict[str, Callable[[int],
                                         Optional[int]]]) -> List[Violation]:
    """``preds`` None: a host module loads ``core/quorum.py``'s model
    itself (a root of sim kernels alone needs none)."""
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    resolver = Resolver(tree)
    out: List[Violation] = []
    out.extend(check_switchnet(tree, relpath, _is_sim_module(tree)))
    if not _is_sim_module(tree):
        sites = host_sites(tree, preds or load_predicates(root), resolver)
        for s in sites:
            if s.resolved and s.kind == "count" and \
                    not any(s.size_fn(n) is not None
                            for n in range(2, MAX_N + 1)):
                s.resolved = False
                s.why_unresolved = "threshold expression does not " \
                    "evaluate for any cluster size"
        for s in sites:
            if not s.resolved:
                out.append(Violation(
                    rule=RULE, code="PXQ502", path=relpath,
                    line=s.line, col=s.col,
                    message=f"unresolvable quorum site `{s.text}`: "
                            f"{s.why_unresolved} — intersection cannot "
                            "be proven, resolve or baseline it"))
        out.extend(_pair_violations(
            [s for s in sites if s.resolved], relpath, "PXQ501", "host"))
    else:
        sites = sim_sites(tree, props, resolver)
        for s in sites:
            if not s.resolved:
                out.append(Violation(
                    rule=RULE, code="PXQ502", path=relpath,
                    line=s.line, col=s.col,
                    message=f"unresolvable quorum site `{s.text}`: "
                            f"{s.why_unresolved} — intersection cannot "
                            "be proven, resolve or baseline it"))
        out.extend(_pair_violations(
            [s for s in sites if s.resolved], relpath, "PXQ503",
            "sim kernel"))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    preds = (load_predicates(root) if (root / QUORUM_MODULE).exists()
             else None)
    props = load_sim_props(root)
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root, preds, props))
    return out
