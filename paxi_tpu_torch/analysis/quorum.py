"""Quorum-safety rule family, sim half (PXQ502-505) — static
intersection proofs over the port's sim kernels (the JAX package's
``analysis/quorum.py``, ``sim_sites`` onward).

A sim kernel declares its quorums as aliases of ``SimConfig``'s derived
sizes (``MAJ = cfg.majority``, ``cfg.fast_size``), as zone-grid
thresholds compared against ``*_zone_quorums(...)`` tallies, or as
rectangular-grid thresholds compared against ``*_row_quorums``/
``*_col_quorums`` tallies.  Every threshold is a small floor-linear
expression of the cluster size; this rule evaluates them symbolically
(``flow.SymEval``, exact rationals) and proves the intersection
obligations for every ``n`` in ``2..MAX_N`` (and every zone count or
grid knob up to ``MAX_Z``):

- **PXQ502** a quorum site whose threshold the analyzer cannot resolve
  symbolically (silence is a proof here, so it must be earned);
- **PXQ503** a sim-kernel quorum threshold pair (phase 1 x phase 2, or
  read x write, on one universe) can fail to intersect; the message
  carries the counterexample size;
- **PXQ504** a rectangular-grid (rowcol) read x write pair can fail to
  intersect: the per-line fullness is derived from the tally helper's
  own body and must demand complete lines;
- **PXQ505** a kernel that commits on the in-network vote
  (``apply_fast_commits``/``fast_commit_mask``) without a
  ``recovery_fold`` register read on the phase-1 win path.

Not ported: the host-form checks (PXQ501, the host ``Quorum.grid_row``/
``grid_col`` pair, the ``SwitchVote``/``SwitchSnap`` handler form).
They read the host replicas and ``core/quorum.py``'s predicates, which
the port does not have.  :class:`Resolver` is shared with
``crossflow.py``.
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
    "paxi_tpu_torch/protocols/*/sim.py",
    "paxi_tpu_torch/protocols/*/sim_pg.py",
)

SIM_TYPES = "paxi_tpu_torch/sim/types.py"

MAX_N = 48     # cluster sizes the "for all n" proof enumerates
MAX_Z = 8      # zone counts / grid knobs likewise

PHASE1 = frozenset({"p1"})
PHASE2 = frozenset({"p2"})
ANY_PHASE = frozenset({"p1", "p2", "read", "write"})

_AMBIG = object()


# ---------------------------------------------------------------------------
# SimConfig thresholds
# ---------------------------------------------------------------------------


def _single_return(fn: ast.AST) -> Optional[ast.expr]:
    rets = [s for s in ast.walk(fn) if isinstance(s, ast.Return)]
    return rets[0].value if len(rets) == 1 else None


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
    # rowcol: (rows, cols) -> complete lines required
    zones_fn: Optional[Callable[[int, int], Optional[int]]] = None
    # rowcol: (rows, cols) -> cells per counted line, derived
    # from the ``*_row_quorums``/``*_col_quorums`` helper body — the
    # fullness the intersection proof hinges on
    fill_fn: Optional[Callable[[int, int], Optional[int]]] = None
    resolved: bool = True
    why_unresolved: str = ""


_P1_HINTS = ("p1", "phase1", "prepare", "become_leader", "elect",
             "recover", "seq1")
_P2_HINTS = ("p2", "accept", "commit")


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
    obligations are at least one line on each side and derived fullness
    (the tallies must count only full lines).  Returns (rows, cols, why)
    for the first geometry that breaks one."""
    w, r = (a, b) if "write" in a.phases else (b, a)
    for gr in range(1, MAX_Z + 1):
        for gc in range(1, MAX_Z + 1):
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


def check_switchnet(tree: ast.Module, relpath: str) -> List[Violation]:
    """The in-network vote register x recovery quorum intersection
    (module docstring, PXQ505): presence of the fast path obliges
    presence of the register read on the recovery path."""
    called: Set[str] = set()
    lines: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = (astutil.dotted_name(node.func) or "").split(".")[-1]
        called.add(name)
        lines.setdefault(name, node.lineno)
    fast = sorted(called & _SWITCH_FAST)
    if not fast or _SWITCH_RECOVER in called:
        return []
    return [Violation(
        rule=RULE, code="PXQ505", path=relpath,
        line=lines[fast[0]], col=0,
        message=(
            f"in-network fast-path commit (`{fast[0]}`) without "
            f"a `{_SWITCH_RECOVER}` register read on the "
            "phase-1 win path — the {switch} write quorum "
            "intersects no recovery quorum, so a vote-only "
            "commit is lost across leader failover"))]


def _is_sim_module(tree: ast.Module) -> bool:
    """Sim kernels all export a top-level ``mailbox_spec`` — steadier
    than filename matching (fixtures)."""
    return any(isinstance(n, astutil.FuncNode)
               and n.name == "mailbox_spec" for n in tree.body)




def check_file(path: Path, root: Path,
               props: Dict[str, Callable[[int],
                                         Optional[int]]]) -> List[Violation]:
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    if not _is_sim_module(tree):
        return []                 # host-form checks: not ported
    resolver = Resolver(tree)
    out: List[Violation] = list(check_switchnet(tree, relpath))
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
    props = load_sim_props(root)
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root, props))
    return out
