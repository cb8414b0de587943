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
       "scripts/torch_invariant_terms.py",
       "scripts/torch_closure_routes.py"]
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
                   "hunt/engine.py", "bench.py", "workload/demo.py",
                   "protocols/paxos/sim_sw.py", "protocols/sdpaxos/sim_sw.py",
                   "protocols/wankeeper/sim_sw.py",
                   "protocols/bpaxos/sim_sw.py",
                   "protocols/wpaxos/sim_sw.py", "analysis/purity.py",
                   "analysis/crossflow.py", "analysis/project.py",
                   # the host replay: core, host, obs, utils, the twins
                   "core/__init__.py", "core/ident.py", "core/ballot.py",
                   "core/command.py", "core/config.py", "core/quorum.py",
                   "core/db.py", "obs/__init__.py", "obs/span.py",
                   "obs/sample.py", "obs/collect.py", "obs/stitch.py",
                   "utils/__init__.py", "utils/log.py", "host/__init__.py",
                   "host/codec.py", "host/transport.py", "host/fabric.py",
                   "host/socket.py", "host/batch.py", "host/node.py",
                   "host/simulation.py", "host/history.py",
                   "trace/demo_host.py", "protocols/paxos/host.py",
                   "switchnet/switch.py", "protocols/switchpaxos/host.py",
                   "protocols/switchpaxos/nogap.py",
                   # serving
                   "host/http.py", "host/client.py", "host/benchmark.py",
                   "host/native.py", "obs/render.py", "bench_host.py",
                   "soak_host.py",
                   # the sharded tier, the stale-read checker, graph
                   "shard/__init__.py", "shard/shardmap.py", "shard/txn.py",
                   "shard/migrate.py", "shard/router.py", "shard/cluster.py",
                   "shard/bench.py", "bench_shard.py", "sim/lincheck.py",
                   "utils/graph.py",
                   # the lint's host families
                   "analysis/handlers.py", "analysis/concurrency.py",
                   "analysis/asyncflow.py", "analysis/ballots.py",
                   "analysis/spanrule.py", "analysis/determinism.py",
                   "analysis/epochfence.py", "analysis/leaseflow.py",
                   "analysis/wirerecord.py", "analysis/parity.py"):
        assert "paxi_tpu_torch/" + module in FILES
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [f for f in FILES
                                  if f.startswith("paxi_tpu_torch/analysis/")])
def test_lint_imports_no_torch(path):
    """The lint is static: it needs neither torch nor a card."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported(tree) if m.split(".")[0] == "torch"]
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


def test_host_registry_modules_are_in_the_port():
    from paxi_tpu.protocols import _HOST_MODULES as JHOST
    from paxi_tpu_torch.protocols import _HOST_MODULES, host_replica
    assert list(_HOST_MODULES) == list(JHOST) and len(JHOST) == 16
    for name, module in _HOST_MODULES.items():
        assert module == JHOST[name].replace("paxi_tpu.", "paxi_tpu_torch.",
                                             1)
        assert module.startswith("paxi_tpu_torch.")
        assert host_replica(name).__module__ == module


def test_host_replay_loads_no_jax():
    """The host replay and serving paths, imported alone, load neither
    JAX nor the JAX package (beyond what the interpreter had loaded at
    start), and the native checker they use is the port's own build."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paxi_tpu_torch.hunt, paxi_tpu_torch.cli\n"
        "import importlib\n"
        "from paxi_tpu_torch.protocols import _HOST_MODULES, host_replica\n"
        "assert len(_HOST_MODULES) == 16\n"
        "[host_replica(n) for n in _HOST_MODULES]\n"
        "[importlib.import_module(m) for m in _HOST_MODULES.values()]\n"
        "import paxi_tpu_torch.core.policy\n"
        "import paxi_tpu_torch.host.simulation, paxi_tpu_torch.obs\n"
        "import paxi_tpu_torch.host.http, paxi_tpu_torch.host.client\n"
        "import paxi_tpu_torch.host.benchmark, paxi_tpu_torch.host.native\n"
        "import paxi_tpu_torch.obs.render, paxi_tpu_torch.bench_host\n"
        "import paxi_tpu_torch.soak_host\n"
        "from paxi_tpu_torch.host import native\n"
        "assert native.native_available(), native.build_error\n"
        "lib = native.library_path()\n"
        "assert lib.parent.name == 'native' and lib.name != 'liblincheck.so'\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paxi_tpu'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_shard_tier_loads_no_torch():
    """The router, the cluster, the shard bench and the ``bench_shard``
    twin start as fast as a server does: imported alone they load
    neither torch nor JAX nor the JAX package (the ramp's workload phase
    and ``sim/lincheck.py`` import torch, and neither is on this path)."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paxi_tpu_torch.shard, paxi_tpu_torch.shard.router\n"
        "import paxi_tpu_torch.shard.cluster, paxi_tpu_torch.shard.bench\n"
        "import paxi_tpu_torch.shard.migrate, paxi_tpu_torch.shard.txn\n"
        "import paxi_tpu_torch.bench_shard, paxi_tpu_torch.utils.graph\n"
        "import paxi_tpu_torch.cli\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('torch', 'numpy', 'jax',\n"
        "                                    'jaxlib', 'paxi_tpu'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
