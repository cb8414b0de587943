"""``python -m paxi_tpu_torch.bench`` against the root ``bench.py``'s worker
on the CPU, at 64 groups and ``BENCH_CPU_SLOTS`` of 1,024 (20 steps).

The reference worker runs in-process under ``BENCH_STAGE=worker`` and
``BENCH_SCALING=0`` (without the second it would append to the root
``BENCH_SCALING.json``, which stays untouched).  Every field of the line
is equal but the times (``value``, ``vs_baseline``, ``wall_s``,
``compile_s``, ``warmup_s``), ``device`` and ``backend`` (the reference's
``auto``; the twin names the exchange that ran: ``plain`` on the CPU):
for the default kernel (``paxos_pg`` on the CPU), ``--kernel paxos`` and
``--kernel paxos_sw``, and over two ranks (``--mesh 2`` against the
reference's two-device virtual CPU mesh).  Also: exit code 1 on a
violation, and the sweep's curve under ``build/``.
"""

import dataclasses
import hashlib
import importlib
import json
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from paxi_tpu_torch import bench as pb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMES = ("value", "vs_baseline", "wall_s", "compile_s", "warmup_s")
SMALL = {"BENCH_CPU_GROUPS": "64", "BENCH_CPU_SLOTS": "1024"}


@pytest.fixture
def bench_env(monkeypatch):
    for k in ("BENCH_MESH", "BENCH_KERNEL", "BENCH_LABEL", "BENCH_BACKEND",
              "BENCH_FALLBACK", "BENCH_FORCE_CPU"):
        monkeypatch.delenv(k, raising=False)
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_SCALING", "0")
    return monkeypatch


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def reference_line(monkeypatch, capsys, **env) -> dict:
    """The root bench.py worker's line, in-process, under ``env``."""
    monkeypatch.setenv("BENCH_STAGE", "worker")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.syspath_prepend(str(ROOT))
    ref = importlib.import_module("bench")
    capsys.readouterr()
    assert ref.worker() == 0
    return _last_json(capsys.readouterr().out)


def port_line(capsys, argv) -> dict:
    capsys.readouterr()
    assert pb.main(argv + ["--device", "cpu"]) == 0
    return _last_json(capsys.readouterr().out)


def assert_same_line(want: dict, got: dict) -> None:
    assert sorted(want) == sorted(got)
    for k in want:
        if k in TIMES or k in ("device", "backend"):
            continue
        assert want[k] == got[k], k
    assert got["backend"] == "plain" and got["device"] == "cpu"
    assert got["invariant_violations"] == 0
    assert got["inscan_violations"] == 0


@pytest.fixture
def root_scaling():
    """The root BENCH_SCALING.json is the same after the test."""
    path = ROOT / "BENCH_SCALING.json"
    before = hashlib.sha256(path.read_bytes()).hexdigest()
    yield
    assert hashlib.sha256(path.read_bytes()).hexdigest() == before


@pytest.mark.parametrize("kernel", [None, "paxos", "paxos_sw"])
def test_cpu_line_equals_reference(bench_env, capsys, root_scaling, kernel):
    env = {"BENCH_KERNEL": kernel} if kernel else {}
    want = reference_line(bench_env, capsys, **env)
    bench_env.delenv("BENCH_KERNEL", raising=False)
    got = port_line(capsys, ["--kernel", kernel] if kernel else [])
    assert_same_line(want, got)
    assert got["kernel"] == (kernel or "paxos_pg")
    assert got["steps"] == 20 and got["groups"] == 64
    assert got["committed_slots"] == 64 * 16


def test_mesh_line_equals_reference(bench_env, capsys, root_scaling):
    want = reference_line(bench_env, capsys, BENCH_MESH="2")
    bench_env.delenv("BENCH_MESH")
    got = port_line(capsys, ["--mesh", "2"])
    assert_same_line(want, got)
    assert got["mesh"] == want["mesh"] == 2


def test_exit_code_one_on_a_violation(bench_env, capsys):
    """A kernel whose oracle reports a violation every step: the line
    counts them and the exit code is 1."""
    from paxi_tpu_torch import profiling
    real = profiling.resolve_kernel

    def resolve(name):
        proto = real(name)
        return dataclasses.replace(
            proto, invariants=lambda old, new, cfg: torch.ones(
                (), dtype=torch.int32))

    bench_env.setattr(profiling, "resolve_kernel", resolve)
    assert pb.main(["--kernel", "paxos", "--device", "cpu"]) == 1
    line = _last_json(capsys.readouterr().out)
    assert line["invariant_violations"] == line["steps"] == 20


def test_sweep_curve_lands_under_build(bench_env, capsys, tmp_path,
                                       root_scaling):
    assert pb.SCALING_PATH.is_relative_to(ROOT / "build")
    bench_env.setattr(pb, "SCALING_PATH", tmp_path / "BENCH_SCALING.json")
    bench_env.setenv("BENCH_SCALING", "1")
    bench_env.setenv("BENCH_CPU_GROUPS", "512")
    bench_env.setenv("BENCH_CPU_SLOTS", "4096")
    assert pb.main(["--kernel", "paxos", "--label", "t", "--device",
                    "cpu"]) == 0
    captured = capsys.readouterr()
    line = _last_json(captured.out)
    assert len(captured.out.strip().splitlines()) == 1
    curve = json.loads(captured.err.split("bench-scaling: ")[1]
                       .splitlines()[0])
    doc = json.loads((tmp_path / "BENCH_SCALING.json").read_text())
    assert doc["curves"] == [curve]
    assert curve["label"] == "t" and curve["backend"] == "plain"
    # the sizes below the run's, then the run itself; steps 5..36 commit
    # one slot a group each
    assert [p["groups"] for p in curve["points"]] == [256, 512]
    assert curve["points"][0] == {**curve["points"][0], "steps": 36,
                                  "committed": 32 * 256}
    assert curve["points"][1]["committed"] == line["committed_slots"] \
        == 512 * 8
    # the closed form is the reference's count at the sweep's shape
    import jax.random as jr
    from paxi_tpu.protocols import sim_protocol
    from paxi_tpu.sim import SimConfig, make_run
    _, metrics, _ = make_run(sim_protocol("paxos"),
                             SimConfig(n_replicas=5, n_slots=64))(
        jr.PRNGKey(1), 256, 36)
    assert int(metrics["committed_slots"]) == 32 * 256


def test_worker_runs_on_the_card_by_default(bench_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.main([])
