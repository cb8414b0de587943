"""Lease / read-staleness rule family (PXR16x).

A layered read tier (leaseholder local reads, follower reads, a router
read cache) leans on ONE invariant the write-path proofs never covered:
a replica may answer a read from local state *without consulting the
log* only while a leader lease vouches that no rival quorum can have
committed writes the local state misses.  This family proves that
invariant over the serving stack — the same precondition move PXE15x
made for the migration double-write window.

The proof surface, per module:

- **read serving** — a statement that replies to a client from
  ``db.get`` local state (a ``.reply(...)`` / ``_response(...)``
  carrying a ``<x>.db.get(...)`` value, alias-chased through the
  ``db_get = self.db.get`` hot-path bind).  In a *lease-bearing*
  class (one that owns a ``_lease_until`` deadline) every such
  statement must be dominated by a ``_lease_ok()``-shaped guard
  (:func:`flow.dominating_guards` atoms, early-return polarity
  included).  Modules with NO lease state cannot serve lease reads;
  their local-state answers (the blockchain host's documented
  eventually-consistent read, the HTTP ``/local`` raw probe) are
  *declared non-linearized* and show up in :func:`coverage` as
  ``nonlinearized_reads`` — pinned by tests, so a future read cache
  cannot dodge the proof by simply not declaring a lease.
- **lease-deadline writes** — every store to ``_lease_until`` outside
  ``__init__`` is either the revocation (``= 0``, shrinking is always
  safe) or the monotone renewal ``max(_lease_until, round_start +
  lease_s)`` whose ``round_start`` is a helper parameter; every call
  site of such a helper must pass a recorded quorum-round start
  (``_p1_start``, ``entry.timestamp``), never a clock read — a lease
  renewed from "now" outlives the quorum round that justified it.
- **election fencing** — a function that flips ``active = True`` in a
  lease-bearing class must stamp the takeover fence
  (``_fence_until = now + lease_s``) and the module must consult it
  (a comparison against ``_fence_until``) before proposing, so a
  fresh leader cannot commit writes while a deposed leader's lease
  may still be serving reads.
- **recovery fencing** — a ``recover`` method in a class carrying
  ``lease_s`` (the 2PC coordinator, shard/txn.py) must await a sleep
  of exactly that bound (alias-chased) — the same envelope that
  fences ``cfg.leader_reads``.
- **resolved clocks** — any function touching the lease machinery
  (lease/fence/round-start attrs, ``_lease_ok``, renewal helpers,
  the recovery fence) must read time through the resolved clock
  (``spans.now()``: fabric clock under replay), never ``time.time``
  and friends — the PXD14x obligation extended onto the protocol
  lease surface its TARGETS never covered.

Checks:

- **PXR161** unleased local read: read served from local state in a
  lease-bearing class without a dominating ``_lease_ok()`` guard;
- **PXR162** non-monotone or clock-derived lease renewal: a
  ``_lease_until`` store that is not ``max(old, start + lease_s)``,
  or a renewal-helper call whose round-start argument is a clock
  read;
- **PXR163** unfenced election: no takeover-fence stamp on the
  election path, a fence bound not derived from ``lease_s``, or a
  fence that is stamped but never consulted;
- **PXR164** unfenced recovery: a lease-carrying ``recover`` without
  an awaited ``sleep(lease_s)`` (alias-chased);
- **PXR165** wall-clock lease arithmetic: a raw wall-clock call
  inside the lease machinery (lease expiry would then depend on host
  wall time during a virtual-clock replay).

:func:`coverage` reports the per-module proof surface so tests pin
every lease check, renewal, fence and declared-non-linearized read
the rule examined — the coming follower-read/read-cache code must
extend the proof, not dodge it.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation

RULE = "lease-flow"

TARGETS = (
    "paxi_tpu_torch/protocols/*/host.py",
    "paxi_tpu_torch/host/*.py",
    "paxi_tpu_torch/shard/*.py",
)

# the lease state vocabulary (protocols/paxos/host.py)
_LEASE_ATTRS = ("_lease_until",)
_FENCE_ATTRS = ("_fence_until",)
_ROUND_ATTRS = ("_p1_start",)
_LEASE_CHECKS = ("_lease_ok",)
_RECOVER_BOUND = "lease_s"

_WALL_CLOCKS = ("time.time", "time.monotonic", "time.perf_counter")


def _is_clock_call(call: ast.Call) -> bool:
    name = astutil.dotted_name(call.func) or ""
    tail = name.split(".")[-1]
    return (name in _WALL_CLOCKS or name.endswith(".time")
            or name == "time"
            or tail in ("monotonic", "perf_counter", "time_ns",
                        "monotonic_ns"))


def _clock_calls(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _is_clock_call(n):
            yield n


def _call_tail(call: ast.Call) -> str:
    return (astutil.dotted_name(call.func) or "").split(".")[-1]


def _stmts(body: Sequence[ast.stmt]):
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            yield from _stmts(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            yield from _stmts(h.body)


def _own_exprs(stmt: ast.stmt):
    """The statement's OWN expressions (epochfence discipline):
    compound statements yield only their header; their bodies are
    separate statements with their own guard sets."""
    if isinstance(stmt, (ast.If, ast.While)):
        yield stmt.test
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield stmt.iter
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield item.context_expr
    elif not isinstance(stmt, ast.Try):
        yield stmt


def _fn_params(fn) -> List[str]:
    args = (list(fn.args.posonlyargs) + list(fn.args.args)
            + list(fn.args.kwonlyargs))
    return [a.arg for a in args]


def _new_stats() -> Dict[str, int]:
    return {"local_read_serves": 0, "lease_guarded_reads": 0,
            "nonlinearized_reads": 0, "lease_checks": 0,
            "renewals": 0, "monotone_renewals": 0, "revocations": 0,
            "renewal_calls": 0, "elections": 0, "fences": 0,
            "fence_checks": 0, "recovery_fences": 0, "lease_fns": 0}


class _Module:
    """One parsed module's lease facts."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        self.model = flow.ModuleModel(tree)
        # classes that OWN a lease deadline — the lease contract scope
        self.lease_classes: Set[str] = {
            name for name, ci in self.model.classes.items()
            if any(a in ci.attrs for a in _LEASE_ATTRS)}
        # classes carrying the recovery bound (the 2PC coordinator)
        self.bound_classes: Set[str] = {
            name for name, ci in self.model.classes.items()
            if _RECOVER_BOUND in ci.attrs}

    def functions(self):
        """(class-name-or-None, FunctionDef) for every def."""
        for name, ci in self.model.classes.items():
            for fi in ci.methods.values():
                yield name, fi.node
        for fi in self.model.functions.values():
            yield None, fi.node

    def renewal_helpers(self) -> Dict[str, int]:
        """fn name -> round-start arg position, for every function
        containing a monotone lease renewal parameterized on one of
        its own arguments."""
        out: Dict[str, int] = {}
        for _cls, fn in self.functions():
            params = _fn_params(fn)
            for stmt in _stmts(fn.body):
                if not isinstance(stmt, ast.Assign):
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr in _LEASE_ATTRS:
                        start = _monotone_start(stmt.value)
                        if isinstance(start, ast.Name) \
                                and start.id in params:
                            pos = params.index(start.id)
                            if params and params[0] == "self":
                                pos -= 1
                            out[fn.name] = max(pos, 0)
        return out


def _monotone_start(value: ast.expr) -> Optional[ast.expr]:
    """The round-start operand of a ``max(_lease_until, start +
    lease_s)``-shaped renewal, else None."""
    if not (isinstance(value, ast.Call)
            and _call_tail(value) == "max"
            and len(value.args) == 2 and not value.keywords):
        return None
    old = [a for a in value.args
           if isinstance(a, ast.Attribute) and a.attr in _LEASE_ATTRS]
    add = [a for a in value.args
           if isinstance(a, ast.BinOp) and isinstance(a.op, ast.Add)]
    if len(old) != 1 or len(add) != 1:
        return None
    left, right = add[0].left, add[0].right
    for bound, start in ((left, right), (right, left)):
        name = astutil.dotted_name(bound) or ""
        if name.endswith("." + _RECOVER_BOUND) or name == _RECOVER_BOUND:
            return start
    return None


class _FileCheck:
    def __init__(self, mod: _Module, helpers: Dict[str, int],
                 out: List[Violation], stats: Dict[str, int]):
        self.mod = mod
        self.helpers = helpers
        self.out = out
        self.stats = stats

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        self.out.append(Violation(
            rule=RULE, code=code, path=self.mod.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    # -- per-function fact helpers ----------------------------------------
    @staticmethod
    def _db_get_aliases(fn) -> Set[str]:
        out: Set[str] = set()
        for stmt in _stmts(fn.body):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Attribute) \
                    and (astutil.dotted_name(stmt.value) or ""
                         ).endswith(".db.get"):
                out.update(t.id for t in stmt.targets
                           if isinstance(t, ast.Name))
        return out

    @staticmethod
    def _serves_local_read(expr: ast.AST, aliases: Set[str]) -> bool:
        """Does this expression both read local db state and emit a
        client-facing answer (reply / _response)?"""
        has_get = has_answer = False
        for n in ast.walk(expr):
            if not isinstance(n, ast.Call):
                continue
            name = astutil.dotted_name(n.func) or ""
            if name.endswith(".db.get") or \
                    (isinstance(n.func, ast.Name)
                     and n.func.id in aliases):
                has_get = True
            if name.split(".")[-1] in ("reply", "_response"):
                has_answer = True
        return has_get and has_answer

    @staticmethod
    def _lease_guarded(guards: flow.GuardSet) -> bool:
        for test, polarity in guards:
            if polarity and isinstance(test, ast.Call) \
                    and _call_tail(test) in _LEASE_CHECKS:
                return True
        return False

    def _is_lease_fn(self, cls: Optional[str], fn) -> bool:
        """Does ``fn`` touch the lease machinery at all?  (The PXR165
        resolved-clock obligation's scope.)"""
        if fn.name in self.helpers:
            return True
        if fn.name == "recover" and cls in self.mod.bound_classes:
            return True
        watched = set(_LEASE_ATTRS) | set(_FENCE_ATTRS) \
            | set(_ROUND_ATTRS)
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and node.attr in watched:
                return True
            if isinstance(node, ast.Call) \
                    and _call_tail(node) in (set(_LEASE_CHECKS)
                                             | set(self.helpers)):
                return True
        return False

    # -- the checks -------------------------------------------------------
    def run(self) -> None:
        fence_stores: List[Tuple[ast.stmt, ast.Attribute]] = []
        fence_checks = 0
        for cls, fn in self.mod.functions():
            in_lease_class = cls in self.mod.lease_classes
            guards = flow.dominating_guards(fn)
            aliases = self._db_get_aliases(fn)
            elected = False
            fn_fence: List[Tuple[ast.stmt, ast.Attribute]] = []
            for stmt in _stmts(fn.body):
                for top in _own_exprs(stmt):
                    # lease-check call sites
                    for n in ast.walk(top):
                        if isinstance(n, ast.Call) \
                                and _call_tail(n) in _LEASE_CHECKS:
                            self.stats["lease_checks"] += 1
                        if isinstance(n, ast.Compare) and any(
                                isinstance(s, ast.Attribute)
                                and s.attr in _FENCE_ATTRS
                                for s in ast.walk(n)):
                            fence_checks += 1
                    # PXR161: local-state read serving
                    if self._serves_local_read(top, aliases):
                        self.stats["local_read_serves"] += 1
                        if not in_lease_class:
                            self.stats["nonlinearized_reads"] += 1
                        elif self._lease_guarded(
                                guards.get(id(stmt), frozenset())):
                            self.stats["lease_guarded_reads"] += 1
                        else:
                            self._flag(
                                "PXR161", stmt,
                                "read served from local state without "
                                "a dominating _lease_ok() guard: a "
                                "deposed leader would answer from a "
                                "snapshot a rival quorum has already "
                                "overwritten — gate on the lease or "
                                "order the read through the log")
                # PXR162: lease-deadline stores
                if isinstance(stmt, ast.Assign):
                    self._check_lease_store(fn, stmt)
                    for t in stmt.targets:
                        if isinstance(t, ast.Attribute) \
                                and t.attr in _FENCE_ATTRS \
                                and fn.name != "__init__":
                            fn_fence.append((stmt, t))
                        if isinstance(t, ast.Attribute) \
                                and t.attr == "active" \
                                and isinstance(stmt.value, ast.Constant) \
                                and stmt.value.value is True:
                            elected = True
                if isinstance(stmt, ast.AugAssign) \
                        and isinstance(stmt.target, ast.Attribute) \
                        and stmt.target.attr in _LEASE_ATTRS:
                    self.stats["renewals"] += 1
                    self._flag(
                        "PXR162", stmt,
                        "lease deadline mutated in place: the only "
                        "sound shapes are the monotone "
                        "max(_lease_until, round_start + lease_s) "
                        "renewal and the shrink-to-zero revocation")
                # PXR162: renewal-helper call sites
                for top in _own_exprs(stmt):
                    self._check_renewal_calls(top)
            fence_stores.extend(fn_fence)
            # PXR163: election fencing
            if elected and in_lease_class:
                self.stats["elections"] += 1
                if not fn_fence:
                    self._flag(
                        "PXR163", fn,
                        f"election path `{fn.name}` flips active=True "
                        f"without stamping the takeover fence "
                        f"(_fence_until = now + lease_s): first "
                        f"proposals could commit while a deposed "
                        f"leader's lease is still serving reads")
                for fstmt, ftarget in fn_fence:
                    value = getattr(fstmt, "value", None)
                    if self._lease_bound_sum(value):
                        self.stats["fences"] += 1
                    else:
                        self._flag(
                            "PXR163", ftarget,
                            "takeover fence bound is not lease_s-"
                            "derived (want <now> + lease_s): a "
                            "shorter fence under-waits the deposed "
                            "leader's live lease")
            # PXR164: recovery fencing
            if fn.name == "recover" and cls in self.mod.bound_classes:
                if self._recover_fenced(fn):
                    self.stats["recovery_fences"] += 1
                else:
                    self._flag(
                        "PXR164", fn,
                        "2PC recovery without awaiting the lease_s "
                        "fence: recovery's decide(abort) could race a "
                        "live coordinator still inside its lease "
                        "envelope — await asyncio.sleep(self.lease_s) "
                        "first")
            # PXR165: wall clocks in lease machinery
            if self._is_lease_fn(cls, fn):
                self.stats["lease_fns"] += 1
                for call in _clock_calls(fn):
                    self._flag(
                        "PXR165", call,
                        "wall-clock read inside the lease machinery: "
                        "lease expiry would depend on host wall time "
                        "during a virtual-clock replay — route "
                        "through the resolved clock (spans.now())")
        self.stats["fence_checks"] += fence_checks
        if fence_stores and fence_checks == 0:
            self._flag(
                "PXR163", fence_stores[0][1],
                "takeover fence is stamped but never consulted: no "
                "comparison against _fence_until guards the proposal "
                "path, so the fence fences nothing")

    def _check_lease_store(self, fn, stmt: ast.Assign) -> None:
        targets = [t for t in stmt.targets
                   if isinstance(t, ast.Attribute)
                   and t.attr in _LEASE_ATTRS]
        if not targets or fn.name == "__init__":
            return
        value = stmt.value
        if isinstance(value, ast.Constant) \
                and value.value in (0, 0.0):
            self.stats["revocations"] += 1
            return                      # shrinking the lease is safe
        self.stats["renewals"] += 1
        start = _monotone_start(value)
        if start is None:
            self._flag(
                "PXR162", targets[0],
                "non-monotone lease-deadline write: want "
                "max(_lease_until, round_start + lease_s) so a "
                "reordered stale renewal can never extend the lease "
                "past what its quorum round justified")
            return
        if any(True for _ in _clock_calls(start)) \
                or (isinstance(start, ast.Call)
                    and _call_tail(start) == "now"):
            self._flag(
                "PXR162", targets[0],
                "lease renewed from a clock read: the deadline must "
                "derive from a recorded quorum-round START "
                "(_p1_start / entry.timestamp), not from \"now\"")
            return
        self.stats["monotone_renewals"] += 1

    def _check_renewal_calls(self, top: ast.AST) -> None:
        for n in ast.walk(top):
            if not (isinstance(n, ast.Call)
                    and _call_tail(n) in self.helpers):
                continue
            self.stats["renewal_calls"] += 1
            pos = self.helpers[_call_tail(n)]
            arg = n.args[pos] if pos < len(n.args) else None
            if arg is None:
                continue
            bad = any(True for _ in _clock_calls(arg)) \
                or (isinstance(arg, ast.Call)
                    and _call_tail(arg) == "now")
            if bad:
                self._flag(
                    "PXR162", n,
                    "lease renewal passed a clock read as the round "
                    "start: \"now\" outlives the quorum round that "
                    "justified the lease — pass the recorded round "
                    "start (_p1_start / entry.timestamp)")

    @staticmethod
    def _lease_bound_sum(value: Optional[ast.expr]) -> bool:
        if not (isinstance(value, ast.BinOp)
                and isinstance(value.op, ast.Add)):
            return False
        for side in (value.left, value.right):
            name = astutil.dotted_name(side) or ""
            if name.endswith("." + _RECOVER_BOUND) \
                    or name == _RECOVER_BOUND:
                return True
        return False

    def _recover_fenced(self, fn) -> bool:
        aliases: Set[str] = set()
        for stmt in _stmts(fn.body):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Attribute) \
                    and stmt.value.attr == _RECOVER_BOUND:
                aliases.update(t.id for t in stmt.targets
                               if isinstance(t, ast.Name))
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Await)
                    and isinstance(node.value, ast.Call)
                    and _call_tail(node.value) == "sleep"
                    and node.value.args):
                continue
            arg = node.value.args[0]
            if isinstance(arg, ast.Attribute) \
                    and arg.attr == _RECOVER_BOUND:
                return True
            if isinstance(arg, ast.Name) and arg.id in aliases:
                return True
        return False


def _run(root: Path, files: Optional[Sequence[Path]]
         ) -> Tuple[List[Violation], Dict[str, Dict[str, int]]]:
    root = root.resolve()
    defaults = list(astutil.iter_py(root, TARGETS))
    requested = list(files) if files is not None else defaults
    # parse the full universe once: renewal helpers are a whole-
    # program fact (the switchnet subclass renews a lease its base
    # class defines), so a scoped run must see the same helper set a
    # full run would
    universe: Dict[Path, _Module] = {}
    for path in [*defaults, *requested]:
        rp = Path(path).resolve()
        if rp in universe:
            continue
        try:
            tree = ast.parse(rp.read_text())
        except (OSError, SyntaxError):
            continue
        universe[rp] = _Module(astutil.rel(rp, root), tree)
    helpers: Dict[str, int] = {}
    for mod in universe.values():
        helpers.update(mod.renewal_helpers())

    out: List[Violation] = []
    per_module: Dict[str, Dict[str, int]] = {}
    for path in requested:
        mod = universe.get(Path(path).resolve())
        if mod is None:
            continue
        stats = per_module.setdefault(mod.rel, _new_stats())
        _FileCheck(mod, helpers, out, stats).run()
    return (sorted(out, key=lambda v: (v.path, v.line, v.code)),
            per_module)


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    return _run(root, files)[0]


def coverage(root: Path,
             files: Optional[Sequence[Path]] = None
             ) -> Dict[str, Dict[str, int]]:
    """Per-module proof surface: every lease check, guarded/declared
    read, renewal, fence and recovery fence the rule examined — tests
    pin these so the read tier cannot grow out from under the proof."""
    return _run(root, files)[1]
