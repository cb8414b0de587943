"""Cross-module flow rule family (PXF8xx) over the port's kernels (the
JAX package's ``analysis/crossflow.py``, reading PyTorch's update forms).

The shared consensus cores — ``sim/ballot_ring.py`` and its fixed-cell
twin ``sim/cell_ring.py`` — write epoch planes under masks their callers
hand them, so the ballot-guard and quorum obligations are proven
*through* the module boundary on the whole-program
:class:`~paxi_tpu_torch.analysis.project.ProjectIndex`:

- **epoch-write domination** (PXF801): every write to an epoch-state
  plane (``ballot``/``abal``/``vbal``/``log_bal``/``active``) in a sim
  kernel or a shared helper must be one of

  - *guarded*: the ``torch.where`` mask (or the or-ed growth term for
    boolean planes) passes through a comparison that mentions a ballot
    register — directly, through local dataflow (tallies accumulated
    under ``m["bal"] == st["ballot"]`` count, because the threshold
    compare on such a tally IS the ballot guard), or through a
    **function parameter chased to every call site**, across file
    boundaries (``depose(st, mask, ...)`` is proven once per caller;
    ``merge_acker_logs``'s ``p1_win`` is proven per *kernel*, through
    the tuple returned by ``tally_p1b``);
  - *monotone by construction*: the new value is a ``max``/``maximum``/
    ``amax`` over the current plane (the election ``(max(ballot)//stride+1)*
    stride + id`` idiom included);
  - *state-derived*: the new value's value-positions carry only
    current epoch state or constants (window shifts, snapshot
    adoption by reference, NOOP/zero resets, owning a slot under my
    already-promised ballot) — no foreign ballot enters;
  - *shrinking* (boolean planes): ``active & ~x`` only demotes.

- **shared-plane interference** (PXF802): a kernel writing a plane the
  imported helper module owns (its ``KEYS`` tuple) is flagged unless
  the kernel write's guard is *disjoint* from every helper write's
  guard for that plane (a complementary atom — ``x`` vs ``~x`` — after
  substituting helper parameters with the kernel's call-site
  arguments).  Two modules masking one carry field with overlapping
  guards is the lane-major analog of an unsynchronized shared write.

- **cross-module quorum flow** (PXF803/804): a threshold parameter
  compared against a tally inside a helper (``popcount(acks) >=
  majority``) is derived at each kernel call site (SymEval through the
  kernel's aliases and SimConfig's own property bodies) and every
  phase-1 x phase-2 pair a kernel feeds the helper must intersect for
  all n — the PXQ proof, re-run through the boundary.  Unresolvable
  sites are PXF804, never silence.

Update forms: ``torch.where(mask, new, old)`` (the JAX package's
``jnp.where``), ``old.masked_fill(mask, v)``, the ``index_put``/
``scatter`` family (their index/mask arguments select, the rest are
values written) and an in-place ``plane[idx] = v`` on a clone, which is
read as ``torch.where(idx, v, plane)``.

Like every paxi-lint family this is purely static; ``coverage(root)``
is the per-kernel proof summary the tests hold equal, kernel by kernel,
to the JAX package's over its own kernels.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation
from paxi_tpu_torch.analysis.project import CallSite, ModInfo, \
    ProjectIndex, _iter_defs, shared_index
from paxi_tpu_torch.analysis.quorum import Resolver

RULE = "cross-module-flow"

TARGETS = (
    "paxi_tpu_torch/protocols/*/sim.py",
    "paxi_tpu_torch/protocols/*/sim_pg.py",
    "paxi_tpu_torch/sim/ballot_ring.py",
    # the fixed-cell twin of the ballot-ring core: same epoch-plane
    # writes, same guard-domination obligation, proven through ITS
    # consumers' call sites (paxos/sdpaxos/wankeeper)
    "paxi_tpu_torch/sim/cell_ring.py",
)

SIM_TYPES = "paxi_tpu_torch/sim/types.py"

# planes whose writes owe domination (W) and ballot registers whose
# mention makes a comparison a ballot guard (C)
EPOCH_PLANES = frozenset({"ballot", "abal", "vbal", "log_bal", "active"})
BALLOT_REGS = frozenset({"ballot", "abal", "vbal", "log_bal", "rec_bal"})

# receivers treated as the state-plane dict in sim code
STATE_DICTS = frozenset({"st", "state", "new", "old"})

# functions that never run in the transition path
SKIP_FUNCS = frozenset({"init_state", "mailbox_spec"})

# quorum-ish parameter names for the PXF803 threshold derivation
QUORUM_PARAM_HINTS = ("major", "quorum", "fast_")

MAX_DEPTH = 5       # cross-function proof hops
MAX_N = 48          # cluster sizes the intersection proof enumerates

_MODULE_ROOTS = frozenset({"torch", "np", "functools"})

# in-plane update methods (``plane.masked_fill(mask, v)``,
# ``plane.scatter(dim, idx, src)``, ...): the index of the first
# argument that is a VALUE written into the plane; the arguments before
# it select which entries move
_UPDATES = {"masked_fill": 1, "masked_fill_": 1, "masked_scatter": 1,
            "masked_scatter_": 1, "index_put": 1, "index_put_": 1,
            "scatter": 2, "scatter_": 2, "scatter_add": 2,
            "scatter_add_": 2, "scatter_reduce": 2, "scatter_reduce_": 2,
            "index_fill": 2, "index_fill_": 2, "index_copy": 2,
            "index_copy_": 2}

# reductions whose result cannot go below their operands' maximum
_MAX_TAILS = ("max", "maximum", "amax")


# ---------------------------------------------------------------------------
# per-function dataflow context
# ---------------------------------------------------------------------------


@dataclass
class CallElem:
    """RHS of a tuple-unpacking assignment from a call:
    ``st, p1_win, amask = br.tally_p1b(...)`` binds ``p1_win`` to
    element 1 of the callee's returned tuple."""

    call: ast.Call
    index: int


@dataclass
class Ctx:
    rel: str
    info: ModInfo
    fn: ast.AST


class Engine:
    """Shared machinery: assignment maps, ballot-derivation fixpoints,
    guard proofs with cross-module call-site chasing."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._assigns: Dict[Tuple[str, int], Dict[str, list]] = {}
        self._derived: Dict[Tuple[str, int, FrozenSet[str]],
                            Set[str]] = {}
        self._local_callers: Dict[str, Dict[str, List[CallSite]]] = {}

    # -- scaffolding ------------------------------------------------------
    def ctx(self, rel: str, fn: ast.AST) -> Optional[Ctx]:
        info = self.index.module(rel)
        return Ctx(rel, info, fn) if info is not None else None

    def _params(self, fn: ast.AST) -> List[str]:
        a = fn.args
        return [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]

    def assignments(self, ctx: Ctx) -> Dict[str, list]:
        """name -> [expr | CallElem] over the function body and its
        enclosing functions (inner shadows are unioned — the chase
        over-approximates, which errs toward accepting real guards)."""
        key = (ctx.rel, id(ctx.fn))
        hit = self._assigns.get(key)
        if hit is not None:
            return hit
        out: Dict[str, list] = {}
        chain = [*ctx.info.enclosing.get(id(ctx.fn), []), ctx.fn]
        for fn in chain:
            self._collect_assigns(fn, out)
        self._assigns[key] = out
        return out

    def _collect_assigns(self, fn: ast.AST, out: Dict[str, list]) -> None:
        skip: Set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, astutil.FuncNode) and node is not fn:
                for sub in ast.walk(node):
                    skip.add(id(sub))
        for node in ast.walk(fn):
            if id(node) in skip:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._bind_target(t, node.value, out)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                out.setdefault(node.target.id, []).append(
                    ast.BinOp(left=ast.Name(id=node.target.id,
                                            ctx=ast.Load()),
                              op=node.op, right=node.value))
            elif isinstance(node, ast.For) and \
                    isinstance(node.target, ast.Name):
                out.setdefault(node.target.id, []).append(node.iter)

    def _bind_target(self, target: ast.expr, value: ast.expr,
                     out: Dict[str, list]) -> None:
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind_target(t, v, out)
            elif isinstance(value, ast.Call):
                for i, t in enumerate(target.elts):
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, []).append(
                            CallElem(value, i))

    # -- ballot derivation fixpoints -------------------------------------
    def _plane_sub(self, node: ast.AST,
                   keys: FrozenSet[str]) -> Optional[str]:
        """``st["ballot"]`` -> "ballot" when the key is in ``keys``."""
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in STATE_DICTS:
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in keys:
                return sl.value
        return None

    def _derived_locals(self, ctx: Ctx,
                        keys: FrozenSet[str]) -> Set[str]:
        """Names transitively derived from any plane in ``keys`` — a
        fixpoint over the function's assignments."""
        cache_key = (ctx.rel, id(ctx.fn), keys)
        hit = self._derived.get(cache_key)
        if hit is not None:
            return hit
        assigns = self.assignments(ctx)
        derived: Set[str] = set()

        def mentions(expr) -> bool:
            if isinstance(expr, CallElem):
                return False          # cross-module: guard chase's job
            for n in ast.walk(expr):
                if self._plane_sub(n, keys) is not None:
                    return True
                if isinstance(n, ast.Name) and n.id in derived:
                    return True
            return False

        changed = True
        while changed:
            changed = False
            for name, exprs in assigns.items():
                if name in derived:
                    continue
                if any(mentions(e) for e in exprs):
                    derived.add(name)
                    changed = True
        self._derived[cache_key] = derived
        return derived

    def cplane_locals(self, ctx: Ctx) -> Set[str]:
        """Names transitively derived from a ballot register — the
        mention set the guard search matches comparisons against."""
        return self._derived_locals(ctx, BALLOT_REGS)

    def key_locals(self, ctx: Ctx, plane: str) -> Set[str]:
        """Names transitively derived from one specific plane."""
        return self._derived_locals(ctx, frozenset({plane}))

    def mentions_ballot(self, expr: ast.AST, ctx: Ctx) -> bool:
        derived = self.cplane_locals(ctx)
        for n in ast.walk(expr):
            if self._plane_sub(n, BALLOT_REGS) is not None:
                return True
            if isinstance(n, ast.Name) and n.id in derived:
                return True
        return False

    def mentions_key(self, expr: ast.AST, ctx: Ctx, plane: str) -> bool:
        derived = self.key_locals(ctx, plane)
        for n in ast.walk(expr):
            if self._plane_sub(n, frozenset({plane})) is not None:
                return True
            if isinstance(n, ast.Name) and n.id in derived:
                return True
        return False

    # -- callers ----------------------------------------------------------
    def local_callers(self, rel: str, name: str) -> List[CallSite]:
        mod_map = self._local_callers.get(rel)
        if mod_map is None:
            mod_map = {}
            info = self.index.module(rel)
            if info is not None:
                for qual, fn in _iter_defs(info):
                    for node in ast.walk(fn):
                        if isinstance(node, ast.Call) and \
                                isinstance(node.func, ast.Name):
                            mod_map.setdefault(node.func.id, []).append(
                                CallSite(rel, fn, qual, node, rel,
                                         node.func.id))
            self._local_callers[rel] = mod_map
        return mod_map.get(name, [])

    def callers(self, rel: str, name: str) -> List[CallSite]:
        out = list(self.index.callers_of(rel, name))
        out.extend(c for c in self.local_callers(rel, name)
                   if c.caller_fn is not self.index.function_def(rel,
                                                                 name))
        return out

    # -- guard proof ------------------------------------------------------
    def find_ballot_cmp(self, expr: ast.AST, ctx: Ctx, depth: int,
                        visited: Set[Tuple[str, int]],
                        chain: List[str]) -> Tuple[bool, Set[str]]:
        """(found, params-of-ctx.fn touched).  Walks the expression's
        dataflow closure looking for a comparison mentioning a ballot
        register; expands local assignments, returned-tuple elements
        and resolvable callees across module boundaries."""
        if depth > MAX_DEPTH:
            self._exhausted = True
            return False, set()
        params: Set[str] = set()
        fn_params = set(self._params(ctx.fn))
        for enc in ctx.info.enclosing.get(id(ctx.fn), []):
            fn_params |= set(self._params(enc))
        assigns = self.assignments(ctx)
        names: List[str] = []
        for n in ast.walk(expr):
            if isinstance(n, ast.Compare):
                for side in [n.left, *n.comparators]:
                    if self.mentions_ballot(side, ctx):
                        return True, params
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                names.append(n.id)
            elif isinstance(n, ast.Call):
                tgt = self._resolve(ctx, n)
                if tgt is not None:
                    ok = self._prove_callee_returns(n, tgt, depth,
                                                   visited, chain, ctx)
                    if ok:
                        return True, params
        for name in names:
            key = (f"{ctx.rel}:{id(ctx.fn)}:{name}", 0)
            if key in visited:
                continue
            visited.add(key)
            if name in assigns:
                for rhs in assigns[name]:
                    if isinstance(rhs, CallElem):
                        if self._prove_call_elem(rhs, ctx, depth,
                                                 visited, chain):
                            return True, params
                    else:
                        ok, _ = self.find_ballot_cmp(rhs, ctx, depth,
                                                     visited, chain)
                        if ok:
                            return True, params
            elif name in fn_params:
                params.add(name)
        return False, params

    def _resolve(self, ctx: Ctx,
                 call: ast.Call) -> Optional[Tuple[str, str]]:
        tgt = self.index.resolve_call(ctx.rel, call)
        if tgt is not None:
            return tgt
        if isinstance(call.func, ast.Name) and \
                call.func.id in ctx.info.functions:
            return ctx.rel, call.func.id
        return None

    def _callee_ctx(self, tgt: Tuple[str, str]) -> Optional[Ctx]:
        fn = self.index.function_def(*tgt)
        if fn is None:
            return None
        return self.ctx(tgt[0], fn)

    def _returns_of(self, fn: ast.AST) -> List[ast.expr]:
        out = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Return) and n.value is not None:
                out.append(n.value)
        return out

    def _map_params_back(self, call: ast.Call, callee: Ctx,
                         touched: Set[str], caller: Ctx, depth: int,
                         visited: Set, chain: List[str]) -> bool:
        """A callee proof stalled on its own parameters: substitute the
        call's arguments and continue in the caller's context."""
        params = self._params(callee.fn)
        argmap: Dict[str, ast.expr] = {}
        for p, a in zip(params, call.args):
            argmap[p] = a
        for kw in call.keywords:
            if kw.arg:
                argmap[kw.arg] = kw.value
        for p in touched:
            a = argmap.get(p)
            if a is None:
                continue
            ok, _ = self.find_ballot_cmp(a, caller, depth + 1, visited,
                                         chain)
            if ok:
                return True
        return False

    def _prove_callee_returns(self, call: ast.Call, tgt: Tuple[str, str],
                              depth: int, visited: Set,
                              chain: List[str], caller: Ctx) -> bool:
        key = (f"ret:{tgt[0]}:{tgt[1]}", id(call))
        if key in visited:
            return False
        visited.add(key)
        callee = self._callee_ctx(tgt)
        if callee is None:
            return False
        for ret in self._returns_of(callee.fn):
            ok, touched = self.find_ballot_cmp(ret, callee, depth + 1,
                                               visited, chain)
            if ok:
                chain.append(f"{tgt[0]}:{tgt[1]}")
                return True
            if touched and self._map_params_back(call, callee, touched,
                                                 caller, depth, visited,
                                                 chain):
                chain.append(f"{tgt[0]}:{tgt[1]}(args)")
                return True
        return False

    def _prove_call_elem(self, elem: CallElem, ctx: Ctx, depth: int,
                         visited: Set, chain: List[str]) -> bool:
        """``st, p1_win, _ = br.tally_p1b(...)``: prove through element
        ``elem.index`` of the callee's returned tuple."""
        tgt = self._resolve(ctx, elem.call)
        if tgt is None:
            return False
        callee = self._callee_ctx(tgt)
        if callee is None:
            return False
        for ret in self._returns_of(callee.fn):
            if not isinstance(ret, (ast.Tuple, ast.List)) or \
                    elem.index >= len(ret.elts):
                continue
            el = ret.elts[elem.index]
            ok, touched = self.find_ballot_cmp(el, callee, depth + 1,
                                               visited, chain)
            if ok:
                chain.append(f"{tgt[0]}:{tgt[1]}[{elem.index}]")
                return True
            if touched and self._map_params_back(elem.call, callee,
                                                 touched, ctx, depth,
                                                 visited, chain):
                chain.append(f"{tgt[0]}:{tgt[1]}[{elem.index}](args)")
                return True
        return False

    def prove_guard(self, expr: ast.AST, ctx: Ctx,
                    depth: int = 0) -> Tuple[str, str]:
        """("guarded"|"call-site"|"unresolved"|"unproven", detail)."""
        if depth == 0:
            self._exhausted = False
        chain: List[str] = []
        found, params = self.find_ballot_cmp(expr, ctx, depth, set(),
                                             chain)
        if found:
            via = " via " + " -> ".join(chain) if chain else ""
            return "guarded", f"ballot comparison{via}"
        if not params:
            # a proof that hit the depth cap mid-chain was cut off,
            # not refuted: PXF804 ("resolve or baseline"), never a
            # definite PXF801
            if self._exhausted:
                return "unresolved", (
                    f"proof depth exceeded ({MAX_DEPTH} hops)")
            return "unproven", "no ballot comparison in the guard's " \
                               "dataflow closure"
        fname = getattr(ctx.fn, "name", "<fn>")
        sites = self.callers(ctx.rel, fname)
        if not sites:
            return "unresolved", (
                f"guard depends on parameter(s) "
                f"{', '.join(sorted(params))} of `{fname}` and no call "
                "site is in the index")
        plist = self._params(ctx.fn)
        proven_at: List[str] = []
        for site in sites:
            argmap: Dict[str, ast.expr] = dict(zip(plist,
                                                   site.call.args))
            for kw in site.call.keywords:
                if kw.arg:
                    argmap[kw.arg] = kw.value
            cctx = self.ctx(site.caller_rel, site.caller_fn)
            ok = False
            for p in sorted(params):
                a = argmap.get(p)
                if a is None or cctx is None:
                    continue
                verdict, _ = self.prove_guard(a, cctx, depth + 1)
                if verdict in ("guarded", "call-site"):
                    ok = True
                    break
            if not ok:
                return "unproven", (
                    f"call site {site.caller_rel}:"
                    f"{site.call.lineno} ({site.caller_qual}) passes "
                    f"no ballot-guarded argument for "
                    f"{', '.join(sorted(params))}")
            proven_at.append(f"{site.caller_rel}:{site.call.lineno}")
        return "call-site", "proven at " + ", ".join(proven_at)

    # -- value shape checks ----------------------------------------------
    def state_pure(self, expr: ast.AST, ctx: Ctx,
                   visited: Optional[Set[str]] = None) -> bool:
        """True when every *value position* of ``expr`` carries only
        current epoch state or constants (selector/mask/shift-amount
        positions are ignored: they pick WHICH entries move, not what
        ballot value lands)."""
        if visited is None:
            visited = set()
        if isinstance(expr, ast.Constant):
            return True
        if self._plane_sub(expr, frozenset(
                EPOCH_PLANES | BALLOT_REGS)) is not None:
            return True
        if isinstance(expr, ast.Subscript):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id in STATE_DICTS:
                return False          # a non-plane state key: unknown
            return self.state_pure(expr.value, ctx, visited)
        if isinstance(expr, ast.Name):
            if expr.id in EPOCH_PLANES or expr.id in BALLOT_REGS:
                # a plane-named local IS current epoch state: every
                # assignment to it is its own verified write site, so
                # downstream value uses need no further chase
                return True
            key = f"{ctx.rel}:{id(ctx.fn)}:{expr.id}"
            if key in visited:
                return True           # cycle: judged by the other uses
            visited.add(key)
            assigns = self.assignments(ctx)
            if expr.id in assigns:
                return all(not isinstance(r, CallElem)
                           and self.state_pure(r, ctx, visited)
                           for r in assigns[expr.id])
            entry = ctx.info.imports.get(expr.id)
            if entry is not None and entry.kind == "symbol":
                const = self._module_const(entry.relpath, entry.symbol)
                return const is not None
            const = self._module_const(ctx.rel, expr.id)
            return const is not None
        if isinstance(expr, ast.Attribute):
            return self.state_pure(expr.value, ctx, visited)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return all(self.state_pure(e, ctx, visited)
                       for e in expr.elts)
        if isinstance(expr, ast.UnaryOp):
            return self.state_pure(expr.operand, ctx, visited)
        if isinstance(expr, (ast.BinOp, ast.BoolOp, ast.Compare)):
            kids = ([expr.left, expr.right]
                    if isinstance(expr, ast.BinOp)
                    else expr.values if isinstance(expr, ast.BoolOp)
                    else [expr.left, *expr.comparators])
            return all(self.state_pure(k, ctx, visited) for k in kids)
        if isinstance(expr, ast.IfExp):
            return self.state_pure(expr.body, ctx, visited) and \
                self.state_pure(expr.orelse, ctx, visited)
        if isinstance(expr, ast.Call):
            tail = (astutil.dotted_name(expr.func) or "").split(".")[-1]
            # receiver of a method chain (x.to(...),
            # plane.masked_fill(m, v)); a module attr (torch.where) has
            # none
            recv = None
            if isinstance(expr.func, ast.Attribute) and not (
                    isinstance(expr.func.value, ast.Name)
                    and (expr.func.value.id in _MODULE_ROOTS
                         or expr.func.value.id in ctx.info.imports)):
                recv = expr.func.value
            if tail == "where" and len(expr.args) >= 3:
                return self.state_pure(expr.args[1], ctx, visited) and \
                    self.state_pure(expr.args[2], ctx, visited)
            if tail in ("maximum", "minimum", "max", "min", "amax",
                        "amin"):
                return (recv is None
                        or self.state_pure(recv, ctx, visited)) and \
                    all(self.state_pure(a, ctx, visited)
                        for a in expr.args)
            if tail in ("full", "full_like"):
                # fill family: the VALUE is args[1] (args[0] is the
                # shape/template) — the one call shape where the
                # first-arg heuristic below would launder a foreign
                # ballot into the plane
                return len(expr.args) >= 2 and \
                    self.state_pure(expr.args[1], ctx, visited)
            meth = (expr.func.attr if isinstance(expr.func, ast.Attribute)
                    else "")
            if recv is not None and meth in _UPDATES:
                # plane.masked_fill(mask, v): mask selects, v is a value
                return self.state_pure(recv, ctx, visited) and \
                    all(self.state_pure(a, ctx, visited)
                        for a in expr.args[_UPDATES[meth]:])
            if recv is not None:
                # other method chains carry their receiver's value
                return self.state_pure(recv, ctx, visited)
            # helper calls (shift/take/pick/one-hot contractions): the
            # first argument is the value plane, the rest are selectors
            if expr.args:
                return self.state_pure(expr.args[0], ctx, visited)
            return True               # zeros()/arange(): constant-ish
        return False

    def _module_const(self, rel: str, name: str) -> Optional[ast.expr]:
        info = self.index.module(rel)
        if info is None:
            return None
        for node in info.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name and \
                            isinstance(node.value, (ast.Constant,
                                                    ast.UnaryOp)):
                        return node.value
        return None

    def monotone(self, expr: ast.AST, ctx: Ctx, plane: str,
                 _depth: int = 0) -> bool:
        """``max``/``maximum`` over the current plane somewhere in the
        value's dataflow closure — the new value cannot go backwards."""
        if _depth > 3:
            return False
        names: List[str] = []
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                tail = (astutil.dotted_name(n.func) or "").split(".")[-1]
                if tail in _MAX_TAILS and any(
                        self.mentions_key(a, ctx, plane)
                        for a in n.args):
                    return True
            elif isinstance(n, ast.Name):
                names.append(n.id)
        assigns = self.assignments(ctx)
        for name in names:
            for rhs in assigns.get(name, []):
                if not isinstance(rhs, CallElem) and \
                        self.monotone(rhs, ctx, plane, _depth + 1):
                    return True
        return False


# ---------------------------------------------------------------------------
# write-site enumeration and classification
# ---------------------------------------------------------------------------


@dataclass
class WriteSite:
    rel: str
    fn: ast.AST
    plane: str
    node: ast.AST                 # the value expression written
    line: int
    col: int
    verdict: str = ""             # guarded/call-site/monotone/...
    detail: str = ""


def _is_identity(value: ast.expr, plane: str) -> bool:
    if isinstance(value, ast.Name) and value.id == plane:
        return True
    if isinstance(value, ast.Subscript) and \
            isinstance(value.value, ast.Name) and \
            value.value.id in STATE_DICTS and \
            isinstance(value.slice, ast.Constant) and \
            value.slice.value == plane:
        return True
    return False


def _is_state_dict_literal(node: ast.Dict) -> bool:
    """``{**st, ...}``-shaped (spreads a state dict) or a state
    assembly with >= 2 identity plane pairs (``ballot=ballot`` style
    spelled as a literal)."""
    for k, v in zip(node.keys, node.values):
        if k is None and isinstance(v, ast.Name) and \
                v.id in STATE_DICTS:
            return True
    ident = sum(1 for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant) and v is not None
                and _is_identity(v, k.value))
    return ident >= 2


def _is_state_dict_call(node: ast.Call) -> bool:
    """``dict(st, ...)`` or a keyword assembly with >= 2 identity
    plane pairs (``dict(ballot=ballot, active=active, ...)``)."""
    if node.args and isinstance(node.args[0], ast.Name) and \
            node.args[0].id in STATE_DICTS:
        return True
    ident = sum(1 for kw in node.keywords
                if kw.arg is not None and _is_identity(kw.value, kw.arg))
    return ident >= 2


def _where_parts(value: ast.expr) -> Optional[Tuple[ast.expr, ast.expr,
                                                    ast.expr]]:
    """(mask, new, old) of a masked update: ``torch.where(mask, new,
    old)`` or ``old.masked_fill(mask, new)``."""
    if not isinstance(value, ast.Call):
        return None
    tail = (astutil.dotted_name(value.func) or "").split(".")[-1]
    if tail == "where" and len(value.args) >= 3:
        return value.args[0], value.args[1], value.args[2]
    # the method form on any receiver (``st["ballot"].masked_fill``)
    if isinstance(value.func, ast.Attribute) and \
            value.func.attr in ("masked_fill", "masked_fill_") and \
            len(value.args) == 2:
        return value.args[0], value.args[1], value.func.value
    return None


def _plane_of_target(target: ast.expr,
                     planes: FrozenSet[str]) -> Optional[str]:
    """The epoch plane an in-place store ``target`` writes into: a
    plane-named local (``ballot[idx] = v``) or a state-dict entry
    (``st["ballot"][idx] = v``)."""
    if not isinstance(target, ast.Subscript):
        return None
    base = target.value
    if isinstance(base, ast.Name) and base.id in planes:
        return base.id
    if isinstance(base, ast.Subscript) and \
            isinstance(base.value, ast.Name) and \
            base.value.id in STATE_DICTS and \
            isinstance(base.slice, ast.Constant) and \
            base.slice.value in planes:
        return base.slice.value
    return None


def _store_as_where(target: ast.Subscript, value: ast.expr) -> ast.expr:
    """``plane[idx] = v`` read as the masked update it is:
    ``torch.where(idx, v, plane)``."""
    call = ast.Call(func=ast.Attribute(value=ast.Name(id="torch",
                                                      ctx=ast.Load()),
                                       attr="where", ctx=ast.Load()),
                    args=[target.slice, value, target.value], keywords=[])
    return ast.copy_location(call, value)


def _spread_writes(eng: Engine, rel: str, fn: ast.AST, call: ast.Call,
                   planes: FrozenSet[str]) -> List[WriteSite]:
    """``{**st, **_shift_logs(st, adv)}``: the planes a helper's returned
    dict literal carries are written where the caller spreads them (one
    site a plane at the spread), each value judged in the helper's own
    context."""
    tgt = eng._resolve(eng.ctx(rel, fn), call)
    callee = eng._callee_ctx(tgt) if tgt is not None else None
    if callee is None:
        return []
    out: List[WriteSite] = []
    for ret in eng._returns_of(callee.fn):
        if not isinstance(ret, ast.Dict):
            continue
        for k, v in zip(ret.keys, ret.values):
            if isinstance(k, ast.Constant) and k.value in planes and \
                    not _is_identity(v, k.value):
                out.append(WriteSite(callee.rel, callee.fn, k.value, v,
                                     call.lineno, call.col_offset))
    return out


def write_sites(eng: Engine, rel: str,
                planes: FrozenSet[str]) -> List[WriteSite]:
    """Every write to a plane in ``planes`` in the module: dict-literal
    values (``{**st, "ballot": X}``), ``dict(st, ballot=X)`` keywords,
    assignments to plane-named locals (the lane-major kernels' idiom),
    in-place stores into a plane (``ballot[idx] = v``) and the planes a
    helper's dict spreads into a state dict (``**_shift_logs(st, adv)``),
    identity pass-throughs and init reads excluded."""
    info = eng.index.module(rel)
    if info is None:
        return []
    out: List[WriteSite] = []
    for qual, fn in _iter_defs(info):
        if fn.name in SKIP_FUNCS:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                if not _is_state_dict_literal(node):
                    continue          # outbox/message dicts reuse the
                    # plane names as FIELD names; only state dicts
                    # (a ``**st`` spread or identity plane pairs) are
                    # write surfaces
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and \
                            k.value in planes and v is not None and \
                            not _is_identity(v, k.value):
                        out.append(WriteSite(rel, fn, k.value, v,
                                             v.lineno, v.col_offset))
                    elif k is None and isinstance(v, ast.Call):
                        out.extend(_spread_writes(eng, rel, fn, v, planes))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "dict":
                if not _is_state_dict_call(node):
                    continue
                for kw in node.keywords:
                    if kw.arg in planes and \
                            not _is_identity(kw.value, kw.arg):
                        out.append(WriteSite(rel, fn, kw.arg, kw.value,
                                             kw.value.lineno,
                                             kw.value.col_offset))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in planes and \
                            not _is_identity(node.value, t.id):
                        out.append(WriteSite(rel, fn, t.id, node.value,
                                             node.lineno,
                                             node.col_offset))
                    plane = _plane_of_target(t, planes)
                    if plane is not None:
                        out.append(WriteSite(
                            rel, fn, plane, _store_as_where(t, node.value),
                            node.lineno, node.col_offset))
    return out


def classify(eng: Engine, site: WriteSite) -> WriteSite:
    """Attach the domination verdict to one write site."""
    ctx = eng.ctx(site.rel, site.fn)
    v = site.node
    plane = site.plane

    parts = _where_parts(v)
    if parts is not None and eng.mentions_key(parts[2], ctx, plane):
        cond, newv, _old = parts
        if eng.state_pure(newv, ctx):
            site.verdict, site.detail = "state-derived", \
                "new value carries only current epoch state/constants"
            return site
        if eng.monotone(newv, ctx, plane):
            site.verdict, site.detail = "monotone", \
                "new value is a max over the current plane"
            return site
        verdict, detail = eng.prove_guard(cond, ctx)
        site.verdict, site.detail = verdict, detail
        return site

    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.BitAnd):
        # boolean shrink: ``active & ~x`` only demotes
        if eng.mentions_key(v.left, ctx, plane) or \
                eng.mentions_key(v.right, ctx, plane):
            site.verdict, site.detail = "shrinking", \
                "conjunction with the current plane only clears bits"
            return site
    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.BitOr):
        own = eng.mentions_key(v.left, ctx, plane)
        grow = v.right if own else v.left
        keep = v.left if own else v.right
        if eng.mentions_key(keep, ctx, plane):
            verdict, detail = eng.prove_guard(grow, ctx)
            site.verdict, site.detail = verdict, detail
            return site

    if eng.state_pure(v, ctx):
        site.verdict, site.detail = "state-derived", \
            "value carries only current epoch state/constants"
        return site
    if eng.monotone(v, ctx, plane):
        site.verdict, site.detail = "monotone", \
            "value is a max over the current plane"
        return site
    verdict, detail = eng.prove_guard(v, ctx)
    if verdict in ("guarded", "call-site"):
        # the whole value's dataflow passes a ballot comparison
        site.verdict, site.detail = verdict, detail
        return site
    site.verdict, site.detail = "unproven", detail
    return site


# ---------------------------------------------------------------------------
# PXF802: shared-plane interference
# ---------------------------------------------------------------------------


def _owned_planes(eng: Engine, rel: str) -> FrozenSet[str]:
    """The planes a helper module declares ownership of via a
    module-level ``KEYS = (...)`` tuple."""
    info = eng.index.module(rel)
    if info is None:
        return frozenset()
    keys = None
    for node in info.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "KEYS" and \
                        isinstance(node.value, (ast.Tuple, ast.List)):
                    keys = node.value
    if keys is None:
        return frozenset()
    return frozenset(e.value for e in keys.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))


def _guard_atoms(expr: ast.expr) -> Set[Tuple[str, bool]]:
    """Decompose a mask expression into (atom text, polarity) over
    ``&`` conjunction and ``~`` negation — the disjointness currency.
    The atom set represents a CONJUNCTION of literals, so ``~`` may
    only distribute over a single atom: ``~(a & b)`` is the
    disjunction ``~a | ~b``, and distributing would claim the strictly
    stronger ``~a & ~b`` — a complementary atom would then "prove"
    disjointness for masks that genuinely overlap.  Compound
    negations stay opaque (sound: fewer disjointness proofs)."""
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        sub = _guard_atoms(expr.operand)
        if len(sub) == 1:
            ((t, p),) = sub
            return {(t, not p)}
        return {(ast.unparse(expr), True)}
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.BitAnd):
        return _guard_atoms(expr.left) | _guard_atoms(expr.right)
    return {(ast.unparse(expr), True)}


def _helper_write_guards(eng: Engine, helper_rel: str, plane: str,
                         kernel_rel: str) -> List[Set[Tuple[str, bool]]]:
    """Guard atom sets of the helper's writes to ``plane``, with
    parameters substituted by the kernel's call-site arguments."""
    out: List[Set[Tuple[str, bool]]] = []
    for site in write_sites(eng, helper_rel, frozenset({plane})):
        parts = _where_parts(site.node)
        if parts is None:
            continue
        atoms = _guard_atoms(parts[0])
        params = eng._params(site.fn)
        resolved: Set[Tuple[str, bool]] = set()
        for text, pol in atoms:
            if text in params:
                for cs in eng.callers(helper_rel, site.fn.name):
                    if cs.caller_rel != kernel_rel:
                        continue
                    argmap = dict(zip(params, cs.call.args))
                    for kw in cs.call.keywords:
                        if kw.arg:
                            argmap[kw.arg] = kw.value
                    a = argmap.get(text)
                    if a is None:
                        continue
                    sub = _guard_atoms(a)
                    if pol:
                        resolved |= sub
                    elif len(sub) == 1:
                        # same rule as _guard_atoms: ~ distributes
                        # over a single substituted atom only
                        ((t2, p2),) = sub
                        resolved.add((t2, not p2))
                    else:
                        resolved.add((f"~({ast.unparse(a)})", True))
            else:
                resolved.add((text, pol))
        out.append(resolved)
    return out


def _disjoint(a: Set[Tuple[str, bool]],
              b: Set[Tuple[str, bool]]) -> bool:
    return any((t, not p) in b for t, p in a)


# ---------------------------------------------------------------------------
# PXF803/804: cross-module quorum flow
# ---------------------------------------------------------------------------

_P1_HINTS = ("p1", "phase1", "prepare", "elect", "recover", "read")
_P2_HINTS = ("p2", "accept", "commit", "write")


@dataclass
class ThresholdParam:
    """One helper parameter compared as a quorum threshold."""

    fn_name: str
    param: str
    index: int
    strict: bool                  # `>` vs `>=`
    phase: str                    # "p1" | "p2" | ""


def threshold_params(eng: Engine, rel: str) -> List[ThresholdParam]:
    cache = eng.__dict__.setdefault("_thresholds", {})
    if rel not in cache:
        cache[rel] = _threshold_params(eng, rel)
    return cache[rel]


def _threshold_params(eng: Engine, rel: str) -> List[ThresholdParam]:
    info = eng.index.module(rel)
    if info is None:
        return []
    out: List[ThresholdParam] = []
    for name, fns in info.functions.items():
        for fn in fns:
            params = eng._params(fn)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Compare)
                        and len(node.ops) == 1):
                    continue
                op = node.ops[0]
                # both orientations: ``tally > param`` and the
                # flipped ``param <= tally`` (Lt/LtE, param left)
                if isinstance(op, (ast.Gt, ast.GtE)):
                    cand = node.comparators[0]
                    strict = isinstance(op, ast.Gt)
                elif isinstance(op, (ast.Lt, ast.LtE)):
                    cand = node.left
                    strict = isinstance(op, ast.Lt)
                else:
                    continue
                rhs = cand
                if not (isinstance(rhs, ast.Name)
                        and rhs.id in params):
                    continue
                if not any(h in rhs.id for h in QUORUM_PARAM_HINTS):
                    continue
                lname = name.lower()
                phase = ("p1" if any(h in lname for h in _P1_HINTS)
                         else "p2" if any(h in lname for h in _P2_HINTS)
                         else "")
                out.append(ThresholdParam(
                    fn_name=name, param=rhs.id,
                    index=params.index(rhs.id),
                    strict=strict, phase=phase))
    return out


def _sim_prop_exprs(root: Path) -> Dict[str, ast.expr]:
    path = root / SIM_TYPES
    if not path.is_file():
        return {}
    tree, _ = astutil.parse_file(path)
    out: Dict[str, ast.expr] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name == "SimConfig"):
            continue
        for item in node.body:
            if isinstance(item, astutil.FuncNode) and \
                    "property" in astutil.decorator_names(item):
                rets = [s for s in ast.walk(item)
                        if isinstance(s, ast.Return)]
                if len(rets) == 1 and rets[0].value is not None:
                    out[item.name] = rets[0].value
    return out


def _threshold_fn(arg: ast.expr, resolver: Resolver,
                  props: Dict[str, ast.expr], strict: bool):
    def size(n: int) -> Optional[int]:
        def resolve(key: str) -> Optional[ast.expr]:
            hit = resolver(key)
            if hit is not None:
                return hit
            tail = key.split(".")[-1]
            if key.split(".")[0] in ("cfg", "self") and tail in props:
                return props[tail]
            return None

        env = {"self.n_replicas": Fraction(n),
               "cfg.n_replicas": Fraction(n), "n": Fraction(n)}
        v = flow.SymEval(env, resolve=resolve).eval(arg)
        if v is None:
            return None
        if strict:
            return int(v.__floor__()) + 1
        return int(-((-v).__floor__()))
    return size


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _analyzed_files(root: Path,
                    files: Optional[Sequence[Path]]) -> List[Path]:
    if files is not None:
        return list(files)
    return list(astutil.iter_py(root, TARGETS))


_ENGINES: Dict[int, Engine] = {}


def _engine_for(index: ProjectIndex) -> Engine:
    """One Engine per shared index: its assignment/fixpoint caches key
    off the index's parsed trees, so they stay valid exactly as long
    as the index itself."""
    eng = _ENGINES.get(id(index))
    if eng is None:
        eng = _ENGINES[id(index)] = Engine(index)
    return eng


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = _analyzed_files(root, files)
    index = shared_index(root, extra_files=paths)
    eng = _engine_for(index)
    rels = [astutil.rel(Path(p).resolve(), root) for p in paths]
    out: List[Violation] = []
    props = _sim_prop_exprs(root)

    for rel in rels:
        info = index.module(rel)
        if info is None:
            continue
        # ---- PXF801/PXF804: epoch-write domination ----
        for site in write_sites(eng, rel, EPOCH_PLANES):
            classify(eng, site)
            if site.verdict == "unproven":
                out.append(Violation(
                    rule=RULE, code="PXF801", path=rel,
                    line=site.line, col=site.col,
                    message=(
                        f"epoch-plane write `{site.plane}` in "
                        f"`{site.fn.name}` has no dominating ballot "
                        f"comparison ({site.detail}) — a lower-ballot "
                        "message can overwrite promised state")))
            elif site.verdict == "unresolved":
                out.append(Violation(
                    rule=RULE, code="PXF804", path=rel,
                    line=site.line, col=site.col,
                    message=(
                        f"epoch-plane write `{site.plane}` in "
                        f"`{site.fn.name}` cannot be proven or refuted "
                        f"({site.detail}) — resolve or baseline it")))

        # ---- PXF802: shared-plane interference ----
        helper_rels = {e.relpath for e in info.imports.values()
                       if e.kind == "module"}
        for helper_rel in sorted(helper_rels):
            owned = _owned_planes(eng, helper_rel)
            if not owned or helper_rel == rel:
                continue
            for site in write_sites(eng, rel, owned):
                parts = _where_parts(site.node)
                mine = (_guard_atoms(parts[0]) if parts is not None
                        else set())
                theirs = _helper_write_guards(eng, helper_rel,
                                              site.plane, rel)
                if not theirs:
                    continue
                if all(_disjoint(mine, t) for t in theirs):
                    continue
                out.append(Violation(
                    rule=RULE, code="PXF802", path=rel,
                    line=site.line, col=site.col,
                    message=(
                        f"`{site.plane}` is owned by {helper_rel} "
                        f"(KEYS) but written directly in "
                        f"`{site.fn.name}` with a guard not disjoint "
                        "from the helper's writes — two modules "
                        "masking one carry plane can interleave "
                        "updates")))

        # ---- PXF803/PXF804: cross-module quorum flow ----
        by_phase: Dict[str, List[Tuple[ast.Call, str, object]]] = {}
        resolver = Resolver(info.tree)
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.Call):
                continue
            tgt = index.resolve_call(rel, node)
            if tgt is None or tgt[0] == rel:
                continue
            for tp in threshold_params(eng, tgt[0]):
                if tp.fn_name != tgt[1]:
                    continue
                # the callee signature includes no `self`; count args
                arg: Optional[ast.expr] = None
                if tp.index < len(node.args):
                    arg = node.args[tp.index]
                for kw in node.keywords:
                    if kw.arg == tp.param:
                        arg = kw.value
                if arg is None:
                    continue
                fn = _threshold_fn(arg, resolver, props, tp.strict)
                if fn(5) is None and fn(29) is None:
                    out.append(Violation(
                        rule=RULE, code="PXF804", path=rel,
                        line=node.lineno, col=node.col_offset,
                        message=(
                            f"threshold `{ast.unparse(arg)}` passed to "
                            f"`{tp.fn_name}({tp.param}=...)` does not "
                            "evaluate symbolically — the cross-module "
                            "quorum proof cannot run; resolve or "
                            "baseline it")))
                    continue
                by_phase.setdefault(tp.phase, []).append(
                    (node, ast.unparse(arg), fn))
        for a_call, a_text, a_fn in by_phase.get("p1", []):
            for b_call, b_text, b_fn in by_phase.get("p2", []):
                bad = None
                for n in range(2, MAX_N + 1):
                    sa, sb = a_fn(n), b_fn(n)
                    if sa is None or sb is None:
                        continue
                    if 0 < sa <= n and 0 < sb <= n and sa + sb <= n:
                        bad = (n, sa, sb)
                        break
                if bad is not None:
                    n, sa, sb = bad
                    out.append(Violation(
                        rule=RULE, code="PXF803", path=rel,
                        line=a_call.lineno, col=a_call.col_offset,
                        message=(
                            f"cross-module quorum thresholds "
                            f"`{a_text}` (line {a_call.lineno}, p1) "
                            f"and `{b_text}` (line {b_call.lineno}, "
                            f"p2) can fail to intersect: at n={n} the "
                            f"sizes are {sa}+{sb} <= {n}")))
    return out


def coverage(root: Path) -> Dict[str, Dict[str, object]]:
    """Per-module proof summary: how many epoch-plane writes each sim
    kernel (and each shared core) carries and how each was proven —
    the artifact the tests hold equal to the JAX package's, kernel by
    kernel, so no ballot-ring consumer can silently fall out of the
    proof."""
    paths = _analyzed_files(root, None)
    index = shared_index(root, extra_files=paths)
    eng = _engine_for(index)
    out: Dict[str, Dict[str, object]] = {}
    helper_writes: Dict[str, List[WriteSite]] = {}
    for p in paths:
        rel = astutil.rel(Path(p).resolve(), root)
        sites = [classify(eng, s)
                 for s in write_sites(eng, rel, EPOCH_PLANES)]
        entry = {
            "writes": len(sites),
            "proven": sum(1 for s in sites
                          if s.verdict not in ("unproven",
                                               "unresolved")),
            "via": sorted({s.verdict for s in sites}),
            "call_site_proofs": [
                s.detail for s in sites if s.verdict == "call-site"],
        }
        out[rel] = entry
        helper_writes[rel] = sites
    # attribute helper writes to the kernels whose call sites carry the
    # proof obligations (the "covers all consumers" half)
    for rel, sites in helper_writes.items():
        consumers: Set[str] = set()
        info = index.module(rel)
        if info is None:
            continue
        for _qual, fn in _iter_defs(info):
            for cs in index.callers_of(rel, fn.name):
                consumers.add(cs.caller_rel)
        out[rel]["consumers"] = sorted(consumers)
    return out
