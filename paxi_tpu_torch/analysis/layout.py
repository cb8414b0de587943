"""Fixed-cell layout rule family (PXL11x) over the port's kernels (the JAX
package's ``analysis/layout.py``, retargeted).

The five lane-major hot-path kernels (paxos, sdpaxos, wpaxos, wankeeper,
bpaxos) run on the fixed-cell mapping (``sim/cell.py``: absolute slot
``a`` at cell ``a % S`` forever), with no per-step ``ring.shift_window``
alignment gathers.  The layout is a *contract*: one re-introduced shift
import quietly reinstates the gather tax, and a kernel mixing the two
layouts corrupts its ring silently (a shift moves cells whose absolute
slots the fixed mapping expects to stay put).

This family pins the contract statically over those kernel files (the
frozen ``sim_sw.py`` twins and the still-sliding kernels — epaxos,
kpaxos, switchpaxos — are deliberately NOT targets):

- **PXL111** a fixed-cell kernel imports a sliding-window shift
  primitive (``shift_window`` / ``shift_row`` / ``shift_deps`` from
  ``sim/ring.py``), by name or as a module-attribute reference.
- **PXL112** a fixed-cell kernel imports the sliding-window consensus
  core (``sim/ballot_ring.py``) instead of its fixed-cell twin
  (``sim/cell_ring.py``; the twin re-exporting ballot_ring's
  layout-free helpers is fine — the rule fires on the kernel's own
  import).  A from-import names the symbols it takes, so a baseline
  entry can admit one layout-free helper and nothing else.

Purely syntactic (imports + attribute references), so it runs in
milliseconds and never needs torch.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "fixed-cell-layout"

# the rewritten kernels — the files the default run pins.  Fixture
# tests drive the rule over seeded modules by passing files= directly.
TARGETS = (
    "paxi_tpu_torch/protocols/paxos/sim.py",
    "paxi_tpu_torch/protocols/sdpaxos/sim.py",
    "paxi_tpu_torch/protocols/wpaxos/sim.py",
    "paxi_tpu_torch/protocols/wankeeper/sim.py",
    "paxi_tpu_torch/protocols/bpaxos/sim.py",
)

SHIFT_NAMES = frozenset({"shift_window", "shift_row", "shift_deps"})
RING_MODULE = "paxi_tpu_torch.sim.ring"
SW_CORE = "paxi_tpu_torch.sim.ballot_ring"


def _check_file(path: Path, root: Path) -> List[Violation]:
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return []
    rel = astutil.rel(path, root)
    out: List[Violation] = []
    ring_aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == RING_MODULE or mod.endswith(".ring"):
                for a in node.names:
                    if a.name in SHIFT_NAMES:
                        out.append(Violation(
                            rule=RULE, code="PXL111", path=rel,
                            line=node.lineno, col=node.col_offset,
                            message=f"fixed-cell kernel imports "
                                    f"sliding-window shift primitive "
                                    f"{a.name!r} from sim/ring.py — "
                                    f"use sim/cell.py masks instead"))
            if mod == SW_CORE or mod.endswith(".ballot_ring"):
                names = ", ".join(f"`{a.name}`" for a in node.names)
                out.append(Violation(
                    rule=RULE, code="PXL112", path=rel,
                    line=node.lineno, col=node.col_offset,
                    message=f"fixed-cell kernel imports {names} from "
                            "the sliding-window core "
                            "sim/ballot_ring.py — use sim/cell_ring.py"))
            if mod == "paxi_tpu_torch.sim" or mod.endswith(".sim") \
                    or mod == "sim":
                for a in node.names:
                    if a.name == "ring":
                        ring_aliases.add(a.asname or a.name)
                    if a.name == "ballot_ring":
                        out.append(Violation(
                            rule=RULE, code="PXL112", path=rel,
                            line=node.lineno, col=node.col_offset,
                            message="fixed-cell kernel imports the "
                                    "sliding-window core "
                                    "sim/ballot_ring.py — use "
                                    "sim/cell_ring.py"))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == RING_MODULE and a.asname:
                    # bare ``import paxi_tpu_torch.sim.ring`` needs no alias:
                    # its references spell the full dotted path, which
                    # the attribute walk below matches directly
                    ring_aliases.add(a.asname)
                if a.name == SW_CORE:
                    out.append(Violation(
                        rule=RULE, code="PXL112", path=rel,
                        line=node.lineno, col=node.col_offset,
                        message="fixed-cell kernel imports the "
                                "sliding-window core "
                                "sim/ballot_ring.py — use "
                                "sim/cell_ring.py"))
    # module-attribute spellings: ``ring.shift_window(...)`` and the
    # fully dotted ``paxi_tpu_torch.sim.ring.shift_window(...)``
    def _dotted(node) -> str:
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return ""

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in SHIFT_NAMES:
            base_path = _dotted(node.value)
            if base_path and (base_path in ring_aliases
                              or base_path == RING_MODULE
                              or base_path.endswith(".ring")):
                out.append(Violation(
                    rule=RULE, code="PXL111", path=rel,
                    line=node.lineno, col=node.col_offset,
                    message=f"fixed-cell kernel references "
                            f"sliding-window shift primitive "
                            f"{base_path}.{node.attr} — use "
                            f"sim/cell.py masks instead"))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    out: List[Violation] = []
    for path in (files if files is not None
                 else astutil.iter_py(root, TARGETS)):
        out.extend(_check_file(Path(path), root))
    return sorted(out, key=lambda v: (v.path, v.line, v.code))
