"""Wire-record schema rule family (PXV17x).

2PC and live migration ride the replicated log as *opaque command
values*: ``core/command.py`` packs each record behind a ``*_MAGIC``
byte prefix and the state machine (``core/db.py``) re-dispatches on
that prefix at execute time ("Paxos Made Moderately Complex"-style
message taxonomy, collapsed into the value space).  That design has a
schema contract no runtime test states end-to-end:

- the magic prefixes must be **pairwise disjoint** — a prefix that is
  a prefix of another would make ``startswith`` dispatch order-
  dependent;
- every ``pack_X`` must have a matching ``unpack_X`` whose **field
  set round-trips**: each mandatory packed key is consumed somewhere
  (unpack validation or the execute-side interpreter) and each
  consumed key is actually packed — an AST diff of the packed dict
  literal against the unpacked accessor set, so a silently dropped or
  phantom field is a lint error, not a log-corruption incident;
- the execute-side **interpreter chain is guarded**: a magic-backed
  ``unpack_X`` refuses foreign bytes itself (its own
  ``startswith(X_MAGIC)`` — the poison-command contract), and every
  use of an unpack result is dominated by a ``None``-guard (statement
  guard or the protected arm of an ``IfExp``), so the interpreter for
  a magic is reachable only behind that magic's guard;
- every **client-value ingress** surface (HTTP KV, router, txn op
  builders) either rejects ``RESERVED_PREFIXES`` or only ever
  forwards server-packed values (``pack_*``-sanctioned), and every
  magic the execute path interprets IS in ``RESERVED_PREFIXES`` — a
  client must never be able to inject a record the state machine
  will re-dispatch on every replica.  ``MOVED_MAGIC`` is the audited
  exception: the execute path *returns* it but never dispatches on
  it (response-only), which is exactly what :func:`coverage` proves.

The magic universe is derived from the analyzed source itself
(module-level ``NAME_MAGIC = b"..."`` constants), so the rule follows
the taxonomy as it grows rather than hard-coding today's four magics.

Checks:

- **PXV171** magic prefix collision: one magic constant is a byte
  prefix of another in the same module;
- **PXV172** pack/unpack schema drift: a magic-backed ``pack_X``
  without ``unpack_X``, a mandatory packed key no consumer reads, or
  a consumed key the packer never writes;
- **PXV173** unguarded interpretation: a magic-backed ``unpack_X``
  that does not ``startswith``-check its own magic, or an unpack
  result used without a dominating ``None``-guard;
- **PXV174** reserved-prefix breach: a magic the execute path
  interprets but ``RESERVED_PREFIXES`` does not list, or a client-
  value ingress function that forwards raw bytes without a
  ``RESERVED_PREFIXES`` test.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation

RULE = "wire-record"

TARGETS = (
    "paxi_tpu_torch/core/command.py",
    "paxi_tpu_torch/core/db.py",
    "paxi_tpu_torch/host/http.py",
    "paxi_tpu_torch/shard/router.py",
    "paxi_tpu_torch/shard/txn.py",
    "paxi_tpu_torch/shard/migrate.py",
)

_RESERVED_NAME = "RESERVED_PREFIXES"
_FORWARD_TAILS = ("run_transaction", "run_txn", "route_kv")


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


def _functions(tree: ast.Module):
    """(owner-class-or-None, fn) for every def, including methods."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    yield node.name, sub


def _startswith_magic(call: ast.Call) -> Optional[str]:
    """The magic NAME of a ``<x>.startswith(NAME)`` call, else None."""
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "startswith" and call.args \
            and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


def _key_accessors(fn, var: str) -> Set[str]:
    """String keys ``fn`` reads off the dict named ``var``:
    ``var["k"]``, ``var.get("k", ...)``, ``"k" in var``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == var \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            out.add(node.slice.value)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == var and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.add(node.args[0].value)
        elif isinstance(node, ast.Compare) \
                and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str) \
                and any(isinstance(c, ast.Name) and c.id == var
                        for c in node.comparators):
            out.add(node.left.value)
    return out


class _PackInfo:
    def __init__(self, fn, magic: Optional[str]):
        self.fn = fn
        self.magic = magic              # magic NAME the pack prefixes
        self.mandatory: Set[str] = set()
        self.conditional: Set[str] = set()
        self.dict_shaped = False
        self._analyze(fn)

    def _analyze(self, fn) -> None:
        doc_vars: Set[str] = set()
        for stmt in _stmts(fn.body):
            value = getattr(stmt, "value", None)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                    and isinstance(value, ast.Dict) \
                    and all(isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            for k in value.keys):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                names = {t.id for t in targets
                         if isinstance(t, ast.Name)}
                if names:
                    doc_vars |= names
                    self.dict_shaped = True
                    self.mandatory |= {k.value for k in value.keys}
        for node in ast.walk(fn):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Store) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in doc_vars \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                self.conditional.add(node.slice.value)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "update" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in doc_vars:
                self.conditional.update(
                    kw.arg for kw in node.keywords if kw.arg)
        self.conditional -= self.mandatory

    @property
    def packed(self) -> Set[str]:
        return self.mandatory | self.conditional


def _pack_magic(fn, magics: Dict[str, bytes]) -> Optional[str]:
    """The magic NAME a pack fn prefixes its payload with
    (``return NAME + ...``-shaped BinOp anywhere in the body)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add) \
                and isinstance(node.left, ast.Name) \
                and node.left.id in magics:
            return node.left.id
    return None


class _Module:
    """One parsed module's wire facts."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        # module-level *_MAGIC byte constants — the derived universe
        self.magics: Dict[str, ast.Assign] = {}
        self.magic_values: Dict[str, bytes] = {}
        self.reserved: Set[str] = set()
        self.reserved_node: Optional[ast.Assign] = None
        for stmt in tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            for t in stmt.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id.endswith("_MAGIC") \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, bytes):
                    self.magics[t.id] = stmt
                    self.magic_values[t.id] = stmt.value.value
                if t.id == _RESERVED_NAME \
                        and isinstance(stmt.value, ast.Tuple):
                    self.reserved_node = stmt
                    self.reserved = {
                        e.id for e in stmt.value.elts
                        if isinstance(e, ast.Name)}
        self.packs: Dict[str, _PackInfo] = {}
        self.unpacks: Dict[str, ast.AST] = {}
        self.fns = list(_functions(tree))
        for _cls, fn in self.fns:
            if fn.name.startswith("pack_"):
                self.packs[fn.name[5:]] = _PackInfo(
                    fn, _pack_magic(fn, self.magics))
            elif fn.name.startswith("unpack_"):
                self.unpacks[fn.name[7:]] = fn
        # does the state machine live here?  (execute-side scope)
        self.is_execute = any(fn.name == "execute"
                              for _c, fn in self.fns)

    def unpack_guard_magic(self, fn) -> Optional[str]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _startswith_magic(node)
                if name is not None:
                    return name
        return None

    def unpack_consumed(self, fn) -> Set[str]:
        """Keys the unpack itself validates/reads — accessors on the
        var assigned from ``json.loads``."""
        out: Set[str] = set()
        for stmt in _stmts(fn.body):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and _call_tail(stmt.value) == "loads":
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out |= _key_accessors(fn, t.id)
        return out


def _none_guard_name(test: ast.expr) -> Optional[Tuple[str, bool]]:
    """``(name, polarity_meaning_not_none)`` for an ``n is [not]
    None`` compare, else None."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Name) \
            and len(test.comparators) == 1 \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.IsNot):
            return test.left.id, True
        if isinstance(test.ops[0], ast.Is):
            return test.left.id, False
    return None


def _new_stats() -> Dict[str, int]:
    return {"magics": 0, "reserved": 0, "packs": 0, "unpacks": 0,
            "dict_packs": 0, "roundtrips": 0, "guarded_unpacks": 0,
            "unpack_uses": 0, "none_guarded_uses": 0,
            "interpreted_magics": 0, "response_only_magics": 0,
            "ingress_fns": 0, "guarded_ingress": 0,
            "sanctioned_ingress": 0}


class _Global:
    """Whole-program wire facts (magic universe, unpack→magic map,
    cross-module consumed-key sets)."""

    def __init__(self, mods: Dict[Path, "_Module"]):
        self.magic_home: Dict[str, _Module] = {}
        self.unpack_magic: Dict[str, str] = {}   # unpack fn -> magic
        self.magic_backed: Set[str] = set()      # unpack fn names
        for mod in mods.values():
            for name in mod.magics:
                self.magic_home.setdefault(name, mod)
            for x, fn in mod.unpacks.items():
                magic = mod.unpack_guard_magic(fn)
                if magic is None and x in mod.packs:
                    magic = mod.packs[x].magic
                if magic is not None:
                    self.unpack_magic["unpack_" + x] = magic
                    self.magic_backed.add("unpack_" + x)
        # consumed keys per magic: unpack validation ∪ execute-side
        # interpreter accessors (chased through `self._f(rec)` calls)
        self.consumed: Dict[str, Set[str]] = {}
        for mod in mods.values():
            for x, fn in mod.unpacks.items():
                magic = self.unpack_magic.get("unpack_" + x)
                if magic is not None:
                    self.consumed.setdefault(magic, set()) \
                        .update(mod.unpack_consumed(fn))
        for mod in mods.values():
            self._chase_interpreters(mod)

    def _chase_interpreters(self, mod: _Module) -> None:
        methods = {fn.name: fn for _c, fn in mod.fns}
        for _cls, fn in mod.fns:
            tracked: Dict[str, str] = {}     # var name -> magic
            for stmt in _stmts(fn.body):
                if not isinstance(stmt, ast.Assign):
                    continue
                for call in ast.walk(stmt.value):
                    if isinstance(call, ast.Call) \
                            and _call_tail(call) in self.unpack_magic:
                        magic = self.unpack_magic[_call_tail(call)]
                        tracked.update(
                            (t.id, magic) for t in stmt.targets
                            if isinstance(t, ast.Name))
            if not tracked:
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call) and node.args
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in tracked):
                    continue
                callee = methods.get(_call_tail(node))
                if callee is None:
                    continue
                params = _fn_params(callee)
                if params and params[0] == "self":
                    params = params[1:]
                if params:
                    self.consumed.setdefault(
                        tracked[node.args[0].id], set()) \
                        .update(_key_accessors(callee, params[0]))


class _FileCheck:
    def __init__(self, mod: _Module, g: _Global,
                 out: List[Violation], stats: Dict[str, int]):
        self.mod = mod
        self.g = g
        self.out = out
        self.stats = stats

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        self.out.append(Violation(
            rule=RULE, code=code, path=self.mod.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    def run(self) -> None:
        self._check_universe()
        self._check_roundtrips()
        self._check_unpack_guards()
        for _cls, fn in self.mod.fns:
            self._check_unpack_uses(fn)
            self._check_ingress(fn)
        self._check_interpreted_reserved()

    # -- PXV171 -----------------------------------------------------------
    def _check_universe(self) -> None:
        mod = self.mod
        self.stats["magics"] += len(mod.magics)
        self.stats["reserved"] += len(mod.reserved)
        order = list(mod.magic_values.items())
        for i, (a, va) in enumerate(order):
            for b, vb in order[:i]:
                if va.startswith(vb) or vb.startswith(va):
                    self._flag(
                        "PXV171", mod.magics[a],
                        f"magic prefix collision: {a} and {b} are "
                        f"prefixes of each other, so startswith "
                        f"dispatch depends on check order — every "
                        f"wire magic must be pairwise disjoint")

    # -- PXV172 -----------------------------------------------------------
    def _check_roundtrips(self) -> None:
        mod = self.mod
        self.stats["packs"] += len(mod.packs)
        self.stats["unpacks"] += len(mod.unpacks)
        for x, pack in mod.packs.items():
            if pack.magic is None:
                continue                 # unprefixed payload helper
            if x not in mod.unpacks:
                self._flag(
                    "PXV172", pack.fn,
                    f"pack_{x} prefixes {pack.magic} but no "
                    f"unpack_{x} exists: a record shape with no "
                    f"decoder is unexecutable log bytes")
                continue
            if not pack.dict_shaped:
                continue                 # list-shaped: no field schema
            self.stats["dict_packs"] += 1
            consumed = self.g.consumed.get(pack.magic, set())
            missing = sorted(pack.mandatory - consumed)
            phantom = sorted(consumed - pack.packed)
            if missing:
                self._flag(
                    "PXV172", pack.fn,
                    f"pack_{x} always writes {missing} but neither "
                    f"unpack_{x} nor any interpreter reads them — a "
                    f"field the schema carries and nobody consumes "
                    f"is schema drift")
            if phantom:
                self._flag(
                    "PXV172", pack.fn,
                    f"consumers of {pack.magic} records read "
                    f"{phantom} which pack_{x} never writes — the "
                    f"interpreter would see defaults for a field "
                    f"the coordinator believes it sent")
            if not missing and not phantom:
                self.stats["roundtrips"] += 1

    # -- PXV173(a) --------------------------------------------------------
    def _check_unpack_guards(self) -> None:
        mod = self.mod
        for x, fn in mod.unpacks.items():
            expect = mod.packs[x].magic if x in mod.packs else None
            if expect is None:
                continue                 # unprefixed payload helper
            got = mod.unpack_guard_magic(fn)
            if got == expect:
                self.stats["guarded_unpacks"] += 1
            else:
                self._flag(
                    "PXV173", fn,
                    f"unpack_{x} does not startswith-check {expect}: "
                    f"the poison-command contract (foreign bytes -> "
                    f"None, never an exception or a misparsed "
                    f"record) starts with the magic guard")

    # -- PXV173(b) --------------------------------------------------------
    def _check_unpack_uses(self, fn) -> None:
        tracked: Set[str] = set()
        for stmt in _stmts(fn.body):
            if isinstance(stmt, ast.Assign):
                if any(isinstance(c, ast.Call)
                       and _call_tail(c) in self.g.magic_backed
                       for c in ast.walk(stmt.value)):
                    tracked.update(t.id for t in stmt.targets
                                   if isinstance(t, ast.Name))
        if not tracked:
            return
        guards = flow.dominating_guards(fn)
        for stmt in _stmts(fn.body):
            for top in _own_exprs(stmt):
                hits: List[ast.Name] = []
                self._scan_uses(top, tracked, frozenset(), hits,
                                skip_assign_targets=stmt)
                for hit in hits:
                    self.stats["unpack_uses"] += 1
                    if self._none_guarded(
                            guards.get(id(stmt), frozenset()), hit.id):
                        self.stats["none_guarded_uses"] += 1
                    else:
                        self._flag(
                            "PXV173", hit,
                            f"unpack result `{hit.id}` used without "
                            f"a None-guard: unpack returns None for "
                            f"foreign/malformed bytes, so an "
                            f"unguarded use turns the poison-command "
                            f"defense into a TypeError at execute "
                            f"time on every replica")

    def _scan_uses(self, node: ast.AST, tracked: Set[str],
                   sanctioned: frozenset, hits: List[ast.Name],
                   skip_assign_targets: Optional[ast.stmt]) -> None:
        if isinstance(node, ast.Compare) \
                and _none_guard_name(node) is not None:
            return                       # the guard itself, not a use
        if isinstance(node, ast.Assign):
            # the binding site (`rec = unpack_tpc(v)`) is not a use
            self._scan_uses(node.value, tracked, sanctioned, hits,
                            skip_assign_targets)
            return
        if isinstance(node, ast.IfExp):
            self._scan_uses(node.test, tracked, sanctioned, hits,
                            skip_assign_targets)
            nc = _none_guard_name(node.test)
            body_s = orelse_s = sanctioned
            if nc is not None:
                name, not_none = nc
                if not_none:
                    body_s = sanctioned | {name}
                else:
                    orelse_s = sanctioned | {name}
            self._scan_uses(node.body, tracked, body_s, hits,
                            skip_assign_targets)
            self._scan_uses(node.orelse, tracked, orelse_s, hits,
                            skip_assign_targets)
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in tracked and node.id not in sanctioned:
                hits.append(node)
            return
        for child in ast.iter_child_nodes(node):
            self._scan_uses(child, tracked, sanctioned, hits,
                            skip_assign_targets)

    @staticmethod
    def _none_guarded(guards: flow.GuardSet, name: str) -> bool:
        for test, polarity in guards:
            nc = _none_guard_name(test)
            if nc is not None and nc[0] == name \
                    and nc[1] == polarity:
                return True
            # truthiness guard (`if rec:`) also excludes None
            if polarity and isinstance(test, ast.Name) \
                    and test.id == name:
                return True
        return False

    # -- PXV174(a) --------------------------------------------------------
    def _interpreting_sites(self):
        """(magic NAME, node) for every execute-side interpretation in
        this module — a startswith dispatch or a magic-backed unpack
        call, outside the codec's own pack_/unpack_ definitions."""
        if not self.mod.is_execute:
            return
        for _cls, fn in self.mod.fns:
            if fn.name.startswith(("pack_", "unpack_")):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _startswith_magic(node)
                if name is not None and name in self.g.magic_home:
                    yield name, node
                tail = _call_tail(node)
                if tail in self.g.unpack_magic:
                    yield self.g.unpack_magic[tail], node

    def _check_interpreted_reserved(self) -> None:
        if not self.mod.is_execute:
            return
        flagged: Set[str] = set()
        interpreted: Set[str] = set()
        for name, node in self._interpreting_sites():
            interpreted.add(name)
            home = self.g.magic_home[name]
            if name in home.reserved or name in flagged:
                continue
            flagged.add(name)
            self._flag(
                "PXV174", node,
                f"{name} is interpreted by the execute path but "
                f"missing from {home.rel}'s {_RESERVED_NAME}: a "
                f"client value carrying it would be re-dispatched "
                f"as a record on every replica — add it to the "
                f"ingress blocklist or stop interpreting it")
        self.stats["interpreted_magics"] += len(interpreted)
        # the response-only audit: magics this execute module loads
        # (returns to callers) but never dispatches on — MOVED_MAGIC's
        # contract, proven rather than assumed
        loaded = {n.id for n in ast.walk(self.mod.tree)
                  if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Load)
                  and n.id in self.g.magic_home}
        self.stats["response_only_magics"] += \
            len(loaded - interpreted - set(self.mod.magics))

    # -- PXV174(b) --------------------------------------------------------
    def _check_ingress(self, fn) -> None:
        if "body" not in _fn_params(fn):
            return
        pack_named: Set[str] = set()
        for stmt in _stmts(fn.body):
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and _call_tail(stmt.value).startswith("pack_"):
                pack_named.update(t.id for t in stmt.targets
                                  if isinstance(t, ast.Name))
        raw_forward = None
        forwards = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = _call_tail(node)
            if isinstance(node.func, ast.Name) \
                    and node.func.id == "Command":
                forwards = True
                value = (node.args[1] if len(node.args) > 1 else
                         next((kw.value for kw in node.keywords
                               if kw.arg == "value"), None))
                sanctioned = (
                    value is None
                    or (isinstance(value, ast.Call)
                        and _call_tail(value).startswith("pack_"))
                    or (isinstance(value, ast.Name)
                        and value.id in pack_named))
                if not sanctioned:
                    raw_forward = raw_forward or node
            elif tail in _FORWARD_TAILS or tail.startswith("_enqueue"):
                forwards = True
                raw_forward = raw_forward or node
        if not forwards:
            return
        self.stats["ingress_fns"] += 1
        if raw_forward is None:
            self.stats["sanctioned_ingress"] += 1
            return
        has_guard = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "startswith" and n.args
            and isinstance(n.args[0], ast.Name)
            and n.args[0].id == _RESERVED_NAME
            for n in ast.walk(fn))
        if has_guard:
            self.stats["guarded_ingress"] += 1
        else:
            self._flag(
                "PXV174", raw_forward,
                f"client bytes forwarded from `{fn.name}` without a "
                f"{_RESERVED_NAME} test: a value carrying a record "
                f"magic would be re-dispatched by the state machine "
                f"at execute time on every replica — reject it at "
                f"ingress (or pack it server-side)")


def _run(root: Path, files: Optional[Sequence[Path]]
         ) -> Tuple[List[Violation], Dict[str, Dict[str, int]]]:
    root = root.resolve()
    defaults = list(astutil.iter_py(root, TARGETS))
    requested = list(files) if files is not None else defaults
    # the magic universe, unpack->magic bindings and consumed-key sets
    # are whole-program facts (db.py's interpreter consumes keys that
    # command.py packs): parse everything once so a scoped run agrees
    # with a full run
    mods: Dict[Path, _Module] = {}
    for path in [*defaults, *requested]:
        rp = Path(path).resolve()
        if rp in mods:
            continue
        try:
            tree = ast.parse(rp.read_text())
        except (OSError, SyntaxError):
            continue
        mods[rp] = _Module(astutil.rel(rp, root), tree)
    g = _Global(mods)

    out: List[Violation] = []
    per_module: Dict[str, Dict[str, int]] = {}
    for path in requested:
        mod = mods.get(Path(path).resolve())
        if mod is None:
            continue
        stats = per_module.setdefault(mod.rel, _new_stats())
        _FileCheck(mod, g, out, stats).run()
    return (sorted(out, key=lambda v: (v.path, v.line, v.code)),
            per_module)


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    return _run(root, files)[0]


def coverage(root: Path,
             files: Optional[Sequence[Path]] = None
             ) -> Dict[str, Dict[str, int]]:
    """Per-module schema proof surface: the derived magic universe,
    pack/unpack round-trips, guarded interpreter chain, and ingress
    guard/sanction counts — pinned by tests so the wire taxonomy
    cannot grow past the proof."""
    return _run(root, files)[1]
