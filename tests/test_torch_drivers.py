"""The port's driver twins against the JAX package's drivers, exactly.

``paxi_tpu_torch.bench_all``: its ``_cfgs``/``_wl_cfgs`` at CPU scale
equal the reference's (imported with ``_BENCH_ALL_STAGE=run``, which
skips the reference's re-exec), and one protocol row and one workload row
at a reduced group count equal the line built from the JAX package's
``make_run`` and ``lathist`` the reference's way, apart from ``value``,
``wall_s`` and ``device``.  ``paxi_tpu_torch.fuzz_soak``: one record per
schedule kind (drop, dup, partition, perm_kill, wan3z+drop) at reduced
groups equal to the reference's record built from
``paxi_tpu.hunt.cases``, ``make_run`` and ``counters_of`` (the
reference's ``fuzz_soak.py`` cannot be imported: it asks
``paxi_tpu.hunt.cases`` for a table that is gone), apart from
``wall_s``.  Neither twin writes outside its ``--out``.
"""

import dataclasses
import importlib
import json
import os
from pathlib import Path

import pytest

pytest.importorskip("jax")

from paxi_tpu_torch import bench_all as pb  # noqa: E402
from paxi_tpu_torch import fuzz_soak as ps  # noqa: E402
from paxi_tpu_torch.hunt import cases as pc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOLATILE = ("value", "wall_s", "device")


@pytest.fixture(scope="module")
def ref_bench_all():
    mp = pytest.MonkeyPatch()
    mp.setenv("_BENCH_ALL_STAGE", "run")
    try:
        yield importlib.import_module("bench_all")
    finally:
        mp.undo()


def _rows(rows):
    return [tuple(dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                  else x for x in r) for r in rows]


def test_bench_rows_equal_reference(ref_bench_all):
    assert _rows(pb._cfgs("cpu")) == _rows(ref_bench_all._cfgs())
    assert _rows(pb._wl_cfgs("cpu")) == _rows(ref_bench_all._wl_cfgs())
    # the card's shapes are the reference's accelerator shapes (x16)
    big = {r[0]: r for r in pb._cfgs("cuda")}
    for r in pb._cfgs("cpu"):
        assert big[r[0]][4] == 16 * r[4]
    assert big["paxos_3rep"][1] == "paxos" \
        and pb._cfgs("cpu")[0][1] == "paxos_pg"


def _reduced(row, groups):
    return row[:4] + (groups,) + row[5:]


def _jax_run(proto_name, cfg, fuzz, groups, steps):
    """The reference's warm-then-timed run, through the JAX package."""
    import jax
    import jax.random as jr
    from paxi_tpu.protocols import sim_protocol
    from paxi_tpu.sim import make_run
    proto = sim_protocol(proto_name)
    compiled = make_run(proto, cfg, fuzz).lower(
        jr.PRNGKey(0), groups, steps).compile()
    jax.block_until_ready(compiled(jr.PRNGKey(1)))
    state, metrics, viols = compiled(jr.PRNGKey(0))
    return proto, state, metrics, viols


def test_protocol_row_equals_reference(ref_bench_all):
    from paxi_tpu.metrics import lathist
    ref = {r[0]: r for r in ref_bench_all._cfgs()}["paxos_3rep"]
    label, name, cfg, fuzz, _, steps, key, unit = _reduced(ref, 8)
    proto, state, metrics, viols = _jax_run(name, cfg, fuzz, 8, steps)
    n = int(metrics[key])
    want = {"metric": f"{label}_{key}_per_sec", "unit": unit,
            "vs_baseline": None, "config": label, "protocol": proto.name,
            key: n, "invariant_violations": int(viols), "groups": 8,
            "steps": steps, "mesh": 0}
    want.update(ref_bench_all.scn.latency_split(metrics))
    hist = lathist.total_hist(state)
    want["commit_latency"] = lathist.summarize(
        hist, int(metrics.get("commit_lat_sum", 0)))
    want["inscan_violations"] = int(metrics.get("inscan_violations", 0))
    row = _reduced({r[0]: r for r in pb._cfgs("cpu")}["paxos_3rep"], 8)
    got = pb.protocol_line(row, device="cpu")
    assert got["device"] == "cpu" and got["value"] > 0
    assert {k: v for k, v in got.items() if k not in VOLATILE} == want
    assert n == 8 * (steps - 4)


def test_workload_row_equals_reference(ref_bench_all):
    from paxi_tpu.metrics import lathist
    from paxi_tpu.workload import (apply_workload, class_split,
                                   named_workload)
    ref = {r[0]: r for r in ref_bench_all._wl_cfgs()}["paxos_zipf99"]
    label, name, cfg0, wl, _, steps, key, unit = _reduced(ref, 8)
    cfg = apply_workload(cfg0, named_workload(wl))
    proto, state, metrics, viols = _jax_run(name, cfg,
                                            ref_bench_all.FAULT_FREE, 8,
                                            steps)
    want = {"metric": f"{label}_{key}_per_sec", "unit": unit,
            "config": label, "protocol": proto.name, "workload": wl,
            key: int(metrics[key]), "invariant_violations": int(viols),
            "inscan_violations": int(metrics.get("inscan_violations", 0)),
            "groups": 8, "steps": steps, "mesh": 0,
            "commit_latency": lathist.summarize(
                lathist.total_hist(state),
                int(metrics.get("commit_lat_sum", 0))),
            "key_class_latency": class_split(state),
            "key_class_counts": {c: int(metrics.get(f"wl_{c}_n", 0))
                                 for c in ("hot", "warm", "cold")}}
    row = _reduced({r[0]: r for r in pb._wl_cfgs("cpu")}["paxos_zipf99"],
                   8)
    got = pb.workload_line(row, device="cpu")
    assert {k: v for k, v in got.items() if k not in VOLATILE} \
        == json.loads(json.dumps(want))


# one case a schedule kind, at a reduced group count
SOAK_KINDS = {"drop": (0, 0, 8), "dup": (0, 1, 8), "partition": (0, 2, 8),
              "perm_kill": (0, 3, 8), "wan3z+drop": (13, 0, 2)}


@pytest.mark.parametrize("kind", sorted(SOAK_KINDS))
def test_soak_record_equals_reference(kind):
    import jax.random as jr
    from paxi_tpu.hunt import cases as jc
    from paxi_tpu.metrics.simcount import counters_of
    from paxi_tpu.protocols import sim_protocol
    from paxi_tpu.sim import make_run
    ci, si, groups = SOAK_KINDS[kind]
    seed = 1
    name, cfg, scheds, _, steps, pkey = jc.CASES[ci]
    fz = scheds[si]
    assert jc.sched_name(fz) == kind
    _, metrics, viols = make_run(sim_protocol(name), cfg, fz)(
        jr.PRNGKey(seed), groups, steps)
    want = {"protocol": name, "schedule": kind, "seed": seed,
            "replicas": cfg.n_replicas, "zones": cfg.n_zones,
            "grid_q2": cfg.grid_q2, "groups": groups, "steps": steps,
            "violations": int(viols), "progress": int(metrics[pkey]),
            "counters": {k: int(v)
                         for k, v in counters_of(metrics).items()}}
    pname, pcfg, pscheds, _, psteps, ppkey = pc.CASES[ci]
    got = ps.soak_record(pname, pcfg, pscheds[si], seed, groups, psteps,
                         ppkey, device="cpu")
    assert got.pop("wall_s") >= 0
    assert got == want
    assert want["violations"] == 0


def _root_records():
    return {n: os.stat(ROOT / n).st_mtime_ns
            for n in ("FUZZ_SOAK.json", "BENCH_PROTOCOLS.json",
                      "BENCH_WORKLOAD.json")}


def test_twins_write_only_their_out(tmp_path, monkeypatch):
    before = _root_records()
    monkeypatch.chdir(tmp_path)
    chain = next(i for i, c in enumerate(pc.CASES) if c[0] == "chain")
    soak_out = tmp_path / "soak" / "FUZZ_SOAK.json"
    assert ps.main(["--cases", f"{chain}:{chain + 1}", "--device", "cpu",
                    "--out", str(soak_out),
                    "--traces-dir", str(tmp_path / "traces")]) == 0
    doc = json.loads(soak_out.read_text())
    assert doc["total_runs"] == 3 * len(pc.SEEDS)
    assert doc["total_violations"] == 0
    assert {r["schedule"] for r in doc["runs"]} == {"drop", "dup",
                                                    "partition"}
    merged = tmp_path / "soak" / "merged.json"
    assert ps.main(["--merge", str(soak_out), str(soak_out), "--out",
                    str(merged)]) == 0
    assert json.loads(merged.read_text()) == {
        "total_runs": 2 * doc["total_runs"], "total_violations": 0,
        "runs": doc["runs"] * 2}
    small = [_reduced(r, 2) for r in pb._cfgs("cpu")
             if r[0] == "chain_pipeline"]
    monkeypatch.setattr(pb, "_cfgs", lambda device=None: small)
    bench_out = tmp_path / "bench" / "b.json"
    assert pb.main(["--device", "cpu", "--out", str(bench_out)]) == 0
    (line,) = json.loads(bench_out.read_text())
    assert line["config"] == "chain_pipeline" and line["groups"] == 2
    small_wl = [_reduced(r, 2) for r in pb._wl_cfgs("cpu")
                if r[0] in ("paxos_uniform",)]
    monkeypatch.setattr(pb, "_wl_cfgs", lambda device=None: small_wl)
    wl_out = tmp_path / "wl.json"
    assert pb.main(["--workload", "--device", "cpu", "--out",
                    str(wl_out)]) == 0
    assert json.loads(wl_out.read_text())[0]["workload"] == "uniform"
    # nothing else was written: not the JAX package's root records, not
    # the traces directory, nothing beside the outputs
    assert _root_records() == before
    assert sorted(str(p.relative_to(tmp_path))
                  for p in tmp_path.rglob("*") if p.is_file()) \
        == ["bench/b.json", "soak/FUZZ_SOAK.json", "soak/merged.json",
            "wl.json"]
