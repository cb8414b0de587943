"""Workload purity rule family (PXW12x) over the port's workload engine
(the JAX package's ``analysis/workload.py``, with PyTorch's stateful
random sources added).

The workload engine's contract (paxi_tpu_torch/workload/) is that every
draw is a *counter-based pure function* of ``(group, slot, channel,
seed)`` — that is what makes one ``Workload`` spec compile onto both
runtimes with bit-identical pinned sim command planes AND lets the
host sampler replay the same sequence per stream.  One stray
``random.random()`` (or a ``torch.rand`` or ``torch.Generator`` draw in
a plane function, or a wall-clock read) silently breaks pinned replay: runs
stop being reproducible, the lane-major vs per-group parity tests
stop meaning anything, and sim/host splits drift apart.

This family pins that contract statically over the workload package:

- **PXW121** a workload module imports a nondeterminism source
  (``random``, ``secrets``, ``uuid``, ``numpy.random``) — draws must
  come from the counter hash (``_draw_u``/``_draw_ui``).
- **PXW122** a workload module *calls* a stateful random source
  (``random.*``, ``np.random.*``, ``numpy.random.*``, ``jr.*``,
  ``jax.random.*``, ``secrets.*``, ``uuid.*``, and PyTorch's
  ``torch.rand``/``randint``/``randn``/``randperm``/``bernoulli``/
  ``multinomial``/``manual_seed``/``Generator`` with their ``_like``
  forms) — even via a module imported elsewhere.
- **PXW123** a workload module reads the wall clock (``time.*`` /
  ``datetime.*`` calls) — schedules are step/ramp indexed, never
  wall-clock indexed, or replay breaks across machines.

Purely syntactic (imports + attribute calls), so it runs in
milliseconds and never needs torch.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "workload-purity"

TARGETS = ("paxi_tpu_torch/workload/*.py",)

# import-time contraband (PXW121): modules whose mere presence in a
# workload file means draws are about to leave the counter hash
BANNED_IMPORTS = frozenset({"random", "secrets", "uuid"})
BANNED_IMPORT_FROMS = frozenset({"random", "secrets", "uuid",
                                 "numpy.random"})

# call-time contraband roots (PXW122): attribute-call base paths that
# name a stateful random source regardless of how they were imported
RANDOM_ROOTS = ("random", "np.random", "numpy.random", "jr",
                "jax.random", "secrets", "uuid")

# PyTorch's stateful draws (PXW122): torch.<name>(...) calls
TORCH_RANDOM = frozenset({"rand", "rand_like", "randint", "randint_like",
                          "randn", "randn_like", "randperm", "bernoulli",
                          "multinomial", "normal", "poisson",
                          "manual_seed", "seed", "Generator"})

# wall-clock roots (PXW123)
CLOCK_ROOTS = ("time", "datetime")


def _dotted(node) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _matches(base: str, roots) -> bool:
    return any(base == r or base.startswith(r + ".") for r in roots)


def _check_file(path: Path, root: Path) -> List[Violation]:
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return []
    rel = astutil.rel(path, root)
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                top = a.name.split(".")[0]
                if top in BANNED_IMPORTS or a.name == "numpy.random":
                    out.append(Violation(
                        rule=RULE, code="PXW121", path=rel,
                        line=node.lineno, col=node.col_offset,
                        message=f"workload module imports "
                                f"nondeterminism source {a.name!r} — "
                                f"draws must come from the counter "
                                f"hash (compile._draw_u)"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod in BANNED_IMPORT_FROMS:
                out.append(Violation(
                    rule=RULE, code="PXW121", path=rel,
                    line=node.lineno, col=node.col_offset,
                    message=f"workload module imports from "
                            f"nondeterminism source {mod!r} — draws "
                            f"must come from the counter hash "
                            f"(compile._draw_u)"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            base = _dotted(node.func.value)
            if not base:
                continue
            full = f"{base}.{node.func.attr}"
            if _matches(base, RANDOM_ROOTS) or (
                    base == "torch" and node.func.attr in TORCH_RANDOM):
                out.append(Violation(
                    rule=RULE, code="PXW122", path=rel,
                    line=node.lineno, col=node.col_offset,
                    message=f"workload draw path calls stateful "
                            f"random source {full}() — replay across "
                            f"lowerings breaks; derive from "
                            f"(group, slot, channel, seed) instead"))
            elif _matches(base, CLOCK_ROOTS):
                out.append(Violation(
                    rule=RULE, code="PXW123", path=rel,
                    line=node.lineno, col=node.col_offset,
                    message=f"workload module reads the wall clock "
                            f"via {full}() — schedules are step/ramp "
                            f"indexed, never wall-clock indexed"))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    out: List[Violation] = []
    for path in (files if files is not None
                 else astutil.iter_py(root, TARGETS)):
        out.extend(_check_file(Path(path), root))
    return sorted(out, key=lambda v: (v.path, v.line, v.code))
