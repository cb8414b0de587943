"""The port stands alone: no file of paxi_tpu_torch/ (its scenarios/ and
trace/ packages and sim/checkpoint.py included), nor chip_smoke.py,
imports jax, jaxlib or the JAX package paxi_tpu (the machine with the
card has no JAX)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "paxi_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "scripts/torch_step_profile.py",
       "scripts/torch_ab.py", "scripts/torch_op_count.py",
       "scripts/torch_invariant_terms.py"]
BANNED = ("jax", "jaxlib", "paxi_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_files_found():
    assert "paxi_tpu_torch/sim/runner.py" in FILES
    assert "paxi_tpu_torch/parallel/mesh.py" in FILES
    assert "paxi_tpu_torch/dryrun.py" in FILES
    for module in ("scenarios/spec.py", "scenarios/schedule.py",
                   "scenarios/compile.py", "trace/format.py",
                   "trace/replay.py", "trace/capture.py", "trace/shrink.py",
                   "sim/checkpoint.py", "metrics/registry.py",
                   "workload/spec.py", "workload/compile.py",
                   "workload/__init__.py", "sim/mailbox_pg.py",
                   "protocols/paxos/sim_pg.py", "__main__.py", "cli.py",
                   "profiling.py", "fuzz_soak.py", "bench_all.py",
                   "trace/host.py", "hunt/__init__.py", "hunt/cases.py",
                   "hunt/corpus.py", "hunt/classify.py", "hunt/report.py",
                   "hunt/engine.py"):
        assert "paxi_tpu_torch/" + module in FILES
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES)
def test_no_jax_platform_setting(path):
    """Port processes never steer a JAX install: there is none to steer."""
    assert "JAX_PLATFORMS" not in (ROOT / path).read_text(), path


def test_registry_modules_are_in_the_port():
    from paxi_tpu_torch.protocols import _SIM_MODULES, sim_protocol
    assert all(m.startswith("paxi_tpu_torch.")
               for m in _SIM_MODULES.values())
    assert {"sdpaxos", "wpaxos", "wpaxos_thinq1", "paxos_pg"} \
        <= set(_SIM_MODULES)
    for name in _SIM_MODULES:
        assert sim_protocol(name).name == name
