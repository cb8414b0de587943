"""Nothing under simbench/ imports JAX or the JAX package, compared by the
top-level module name as a whole, and the reference imports nothing of
the port either."""

import ast
import subprocess
import sys

import pytest

from simbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "paxi_tpu"}
FILES = sorted(p for p in cells.HERE.rglob("*.py")
               if "tests" not in p.relative_to(cells.HERE).parts)


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(cells.HERE)))
def test_no_jax_import(path):
    found = set(_imported(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imported(path)) & (FORBIDDEN | {"paxi_tpu_torch"})


def test_top_level_name_compared_whole():
    from simbench import run
    assert "paxi_tpu" in run.FORBIDDEN
    assert "paxi_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole CPU run through the harness leaves no forbidden module in
    the process."""
    code = (
        "import sys, time\n"
        "from simbench import cells\n"
        "from simbench.run import run_cell, forbidden_modules\n"
        "c = cells.find_cell('paxos5_ff')\n"
        "out = run_cell(c, 5, 0.2, False, 'cpu', time.perf_counter(),"
        " groups=4)\n"
        "assert out.result['correct'], out.result\n"
        "print('LEAKED', forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout
