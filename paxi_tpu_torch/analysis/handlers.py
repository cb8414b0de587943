"""Handler-completeness rule family (PXH2xx).

The host runtime inherits paxi's plugin boundary: a replica registers
one handler per wire message class (``self.register(P2a,
self.handle_p2a)``, node.go's Register) and ``Node._recv_loop``
silently drops anything unregistered (it only bumps
``paxi_msgs_unhandled_total``).  That makes "I defined a message but
forgot to register its handler" a *runtime-silent* protocol hole —
messages vanish exactly like a 100% drop fault — and "I registered /
kept a handler nothing sends" dead code that rots.

Statically, both ends are visible in each protocol's host module:

- wire messages are the ``@register_message``-decorated dataclasses;
- the dispatch table is the set of ``*.register(Cls, handler)`` calls;
- handler methods follow the ``handle_*`` naming convention.

Checks:

- **PXH201** a ``@register_message`` class with no ``register()`` call
  in its defining module — the message is sent (or meant to be) but
  every replica will drop it on the floor
- **PXH202** a ``handle_*`` method that is neither registered nor
  referenced anywhere else in the module — a dead handler
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "handler-completeness"

TARGETS = (
    "paxi_tpu_torch/protocols/*/host.py",
    "paxi_tpu_torch/host/node.py",
)


def _wire_classes(tree: ast.Module) -> List[Tuple[str, int, int]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            decs = astutil.decorator_names(node)
            if any(d.split(".")[-1] == "register_message" for d in decs):
                out.append((node.name, node.lineno, node.col_offset))
    return out


def _registrations(tree: ast.Module) -> Tuple[set, set]:
    """(registered class names, handler names used in register calls)."""
    classes: set = set()
    handlers: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "register"):
            continue
        if len(node.args) >= 1 and isinstance(node.args[0], ast.Name):
            classes.add(node.args[0].id)
        if len(node.args) >= 2:
            h = node.args[1]
            if isinstance(h, ast.Attribute):
                handlers.add(h.attr)
            elif isinstance(h, ast.Name):
                handlers.add(h.id)
    return classes, handlers


def _handler_methods(tree: ast.Module) -> List[Tuple[str, int, int]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, astutil.FuncNode) and \
                        item.name.startswith("handle_"):
                    out.append((item.name, item.lineno, item.col_offset))
    return out


def _referenced_attrs(tree: ast.Module) -> set:
    """Attribute / bare names referenced anywhere (handler liveness:
    ``self.handle_request(req)`` keeps ``handle_request`` alive even
    when it is registered under a different key)."""
    names: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load):
            names.add(node.id)
    return names


def check_file(path: Path, root: Path) -> List[Violation]:
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    out: List[Violation] = []
    registered, reg_handlers = _registrations(tree)
    for cls, line, col in _wire_classes(tree):
        if cls not in registered:
            out.append(Violation(
                rule=RULE, code="PXH201", path=relpath, line=line, col=col,
                message=f"wire message `{cls}` has no register() call — "
                        "every replica will silently drop it "
                        "(Node._recv_loop counts it as unhandled and "
                        "moves on)"))
    refs = _referenced_attrs(tree)
    for name, line, col in _handler_methods(tree):
        if name not in reg_handlers and name not in refs:
            out.append(Violation(
                rule=RULE, code="PXH202", path=relpath, line=line, col=col,
                message=f"dead handler `{name}` — neither registered in "
                        "the dispatch table nor called anywhere in the "
                        "module"))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root))
    return out
