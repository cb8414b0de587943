"""The port's paxi-lint (paxi_tpu_torch/analysis) against the JAX package's
(paxi_tpu/analysis): the reference fixtures translated to PyTorch give the
same codes at the same lines, the port's proofs cover its kernels as the
reference's cover the JAX kernels, the PyTorch-only rules fire on their
mutants, and the port's tree is clean with its baseline.

Fixtures are source strings written under ``tmp_path`` (at the reference
fixtures' own relative paths, so reports compare path for path); no
module under analysis is imported.
"""

import json
import textwrap
from pathlib import Path

import pytest

from paxi_tpu.analysis import crossflow as ref_crossflow
from paxi_tpu.analysis import layout as ref_layout
from paxi_tpu.analysis import measure as ref_measure
from paxi_tpu.analysis import quorum as ref_quorum
from paxi_tpu.analysis import workload as ref_workload
from paxi_tpu_torch import analysis
from paxi_tpu_torch.analysis import (crossflow, layout, measure, purity,
                                     quorum, tracemap, workload)
from paxi_tpu_torch.analysis.model import (Suppression, Violation,
                                           apply_suppressions,
                                           inline_disables, load_baseline)

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures" / "lint"
FIX_REL = "tests/fixtures/lint"


def codes(violations):
    return sorted({v.code for v in violations})


def sites(violations):
    return sorted((v.code, v.path, v.line) for v in violations)


def translate(src: str) -> str:
    """A JAX fixture as the port would spell it."""
    return (src.replace("import jax.numpy as jnp", "import torch")
            .replace("jnp.", "torch.").replace("paxi_tpu.", "paxi_tpu_torch."))


def fixture_root(tmp_path: Path) -> Path:
    """A root holding the port's SimConfig (for ``cfg.majority``-style
    thresholds) and the fixtures directory."""
    types = tmp_path / "paxi_tpu_torch" / "sim" / "types.py"
    types.parent.mkdir(parents=True)
    types.write_text((ROOT / "paxi_tpu_torch/sim/types.py").read_text())
    (tmp_path / FIX_REL).mkdir(parents=True)
    return tmp_path


def put(root: Path, rel: str, src: str) -> Path:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return path


def translated(root: Path, *names: str):
    return [put(root, f"{FIX_REL}/{n}", translate((FIX / n).read_text()))
            for n in names]


# ---- the reference fixtures, translated ----------------------------------
FAMILY_FIXTURES = [
    ("measure", ref_measure, measure, ("fixture_measure.py",)),
    ("layout", ref_layout, layout, ("fixture_layout.py",)),
    ("workload", ref_workload, workload, ("fixture_workload.py",)),
    ("crossflow", ref_crossflow, crossflow,
     ("fixture_crossflow_kernel.py", "fixture_crossflow_helper.py")),
    ("quorum", ref_quorum, quorum, ("fixture_switch_kernel.py",)),
]


@pytest.mark.parametrize("label,ref,port,names", FAMILY_FIXTURES,
                         ids=[f[0] for f in FAMILY_FIXTURES])
def test_translated_fixture_same_codes_and_lines(tmp_path, label, ref, port,
                                                 names):
    want = ref.check(ROOT, files=[FIX / n for n in names])
    root = fixture_root(tmp_path)
    got = port.check(root, files=translated(root, *names))
    assert want, f"the reference reports nothing on {names}"
    assert sites(got) == sites(want)


def test_translated_crossflow_fixture_proof_shapes(tmp_path):
    """The clean depose is proven AT the kernel call site across the file
    boundary, the election by monotonicity, the demotion as shrinking —
    the reference's verdicts on the same fixture pair."""
    root = fixture_root(tmp_path)
    files = translated(root, "fixture_crossflow_kernel.py",
                       "fixture_crossflow_helper.py")
    eng = crossflow._engine_for(crossflow.shared_index(root,
                                                       extra_files=files))
    rel = f"{FIX_REL}/fixture_crossflow_helper.py"
    got = {f"{s.fn.name}.{s.plane}": crossflow.classify(eng, s)
           for s in crossflow.write_sites(eng, rel, crossflow.EPOCH_PLANES)}
    assert got["depose_ok.ballot"].verdict == "call-site"
    assert "fixture_crossflow_kernel" in got["depose_ok.ballot"].detail
    assert got["elect_fx.ballot"].verdict == "monotone"
    assert got["depose_ok.active"].verdict == "shrinking"


# ---- kernel purity: the reference fixture by hand, and torch mutants -----
KERNEL_FIXTURE = '''\
"""fixture_kernel.py by hand: a SimProtocol-wired step, its helpers, and
a host-side function that no entry point reaches."""

import functools
import random
import time

import numpy as np
import torch

from paxi_tpu_torch.sim.types import SimProtocol


def helper(x):
    # reachable from the step through one call level:
    n = np.sum(x)                      # PXK102
    return n + hash(x)                 # PXK106


def step(state, inbox, ctx):
    x = state["x"]
    t = time.time()                    # PXK101
    if torch.any(x > 0):               # PXK104
        x = x + 1
    for v in {1, 2, 3}:                # PXK103
        x = x + v
    y = torch.zeros((4,), dtype=torch.float64)   # PXK105
    return {"x": helper(x) + y + t}, {}


def invariants(old, new, cfg):
    r = random.random()                # PXK101
    return r


def host_side(path):
    """Negative control: no entry point reaches it."""
    data = np.load(path)
    t0 = time.time()
    if torch.any(torch.from_numpy(data) > 0):
        return data.item(), t0
    return data, t0


PROTOCOL = SimProtocol(name="fx", step=step, invariants=invariants)
'''


def _seeded(src: str):
    return sorted((line.split("# ")[-1].split()[0], i)
                  for i, line in enumerate(src.splitlines(), 1)
                  if "# PXK" in line)


def test_kernel_fixture_by_hand_fires_each_code(tmp_path):
    path = put(tmp_path, "fixture_kernel.py", KERNEL_FIXTURE)
    vs = purity.check(tmp_path, files=[path])
    assert codes(vs) == ["PXK101", "PXK102", "PXK103", "PXK104",
                         "PXK105", "PXK106"]
    # every seeded line fires its code, and nothing else fires
    assert sorted({(v.code, v.line) for v in vs}) == _seeded(KERNEL_FIXTURE)
    host = KERNEL_FIXTURE.splitlines().index("def host_side(path):") + 1
    assert all(v.line < host for v in vs)


TORCH_MUTANTS = '''\
import functools

import torch

from paxi_tpu_torch.sim.types import SimProtocol


@functools.lru_cache(maxsize=8)
def _plane(n, device):
    return torch.tensor([1] * n, device=device)   # cached: built once


def _gate(x):
    return x.nonzero()                            # PXK104 nonzero


def step(state, inbox, ctx):
    x = state["x"]
    n = x.sum().item()                            # PXK104 item
    if (x > 0).any():                             # PXK104 if
        x = x + 1
    idx = torch.nonzero(x)                        # PXK104 nonzero
    p = torch.tensor(0.5, device=x.device)        # PXK107 tensor
    q = torch.from_numpy(ctx.table).to(x.device)  # PXK107 from_numpy
    ok = state["a"] and state["b"]                # PXK104 and
    c = _plane(4, x.device)
    return {"x": x + p + q + c[0] + n + idx.sum() + _gate(x) + ok}, {}


def init_state(cfg, key, n_groups, device=None):
    seed = int(torch.randint(0, 9, (1,)))          # PXK101 draw (not 104)
    return {"x": torch.zeros(n_groups, device=device) + seed}


def unwired(state):
    return state["x"].item()


PROTOCOL = SimProtocol(name="fx", step=step, init_state=init_state)
'''


def test_torch_mutants_fire_and_cached_plane_does_not(tmp_path):
    path = put(tmp_path, "fixture_torch.py", TORCH_MUTANTS)
    vs = purity.check(tmp_path, files=[path])
    want = sorted((c, i) for c, i in _seeded(TORCH_MUTANTS))
    assert sorted({(v.code, v.line) for v in vs}) == want
    msgs = " | ".join(v.message for v in vs)
    # the once-built plane, init_state's sync and unwired code stay clean
    assert "`_plane`" not in msgs and "`unwired`" not in msgs
    assert "cudaStreamSynchronize" in msgs          # says what it costs


def test_flagged_spans_cover_multiline_sites(tmp_path):
    path = put(tmp_path, "fixture_span.py", '''\
        from paxi_tpu_torch.sim.types import SimProtocol


        def step(state, inbox, ctx):
            if (state["x"]
                    > 0).any():
                return state, {}
            return state, {}


        PROTOCOL = SimProtocol(name="fx", step=step)
        ''')
    vs = purity.check(tmp_path, files=[path])
    assert [(v.code, v.line) for v in vs] == [("PXK104", 5)]
    spans = purity.flagged_spans(tmp_path, vs)
    assert spans == {"fixture_span.py": [(5, 6)]}


def test_workload_torch_draws(tmp_path):
    path = put(tmp_path, "paxi_tpu_torch/workload/fx.py", '''\
        import torch


        def plane(n):
            return torch.rand(n)


        def gen(seed):
            return torch.Generator().manual_seed(seed)


        def counter(n):
            return torch.arange(n) * 3
        ''')
    vs = workload.check(tmp_path, files=[path])
    assert [(v.code, v.line) for v in vs] == [("PXW122", 5), ("PXW122", 9)]


QUORUM_MUTANT = '''\
def mailbox_spec(cfg):
    return {"p1a": ("bal",), "p2a": ("bal",)}


def step(state, inbox, ctx):
    cfg = ctx.cfg
    Q1 = 1
    Q2 = cfg.grid_q2
    zq = _zone_quorums(state, inbox)
    win1 = zq >= Q1
    zq2 = _zone_quorums(state, inbox)
    win2 = zq2 >= Q2
    return state, {}
'''


def test_quorum_sim_kernel_thresholds_must_intersect(tmp_path):
    """PXQ503: a single-zone phase-1 quorum does not meet a grid_q2-zone
    phase 2; the wpaxos form ``Z - q2 + 1`` does."""
    root = fixture_root(tmp_path)
    bad = put(root, "paxi_tpu_torch/protocols/fx/sim.py", QUORUM_MUTANT)
    vs = quorum.check(root, files=[bad])
    assert codes(vs) == ["PXQ503"]
    assert "intersect" in vs[0].message
    good = put(root, "paxi_tpu_torch/protocols/fy/sim.py",
               QUORUM_MUTANT.replace("Q1 = 1",
                                     "Q1 = cfg.n_zones - cfg.grid_q2 + 1"))
    assert quorum.check(root, files=[good]) == []


def test_crossflow_torch_update_forms(tmp_path):
    """``masked_fill`` and an in-place store are epoch writes: a foreign
    ballot under a non-ballot mask is PXF801 in either form, and the
    same writes under a ballot comparison are proven."""
    root = fixture_root(tmp_path)
    path = put(root, "paxi_tpu_torch/protocols/fx/sim.py", '''\
        import torch


        def step(state, inbox, ctx):
            st = dict(state)
            m = inbox["p1a"]
            idle = state["timer"] <= 0
            ballot = st["ballot"].masked_fill(idle, 7)
            st = {**st, "ballot": st["ballot"].masked_fill(idle, m["bal"])}
            vbal = st["vbal"].clone()
            vbal[idle] = m["bal"]
            promote = m["bal"] > st["ballot"]
            abal = st["abal"].clone()
            abal[promote] = m["bal"]
            return {**st, "ballot": ballot, "vbal": vbal, "abal": abal}, {}
        ''')
    vs = crossflow.check(root, files=[path])
    assert sorted((v.code, v.line) for v in vs) == [("PXF801", 9),
                                                    ("PXF801", 11)]


def test_measure_quarantine_through_a_helper(tmp_path):
    """A helper that returns the m_ planes under m_ keys keeps the taint
    quarantined at one remove; one that returns it under a protocol key
    leaks (PXM101 where the kernel stores it)."""
    root = fixture_root(tmp_path)
    put(root, "paxi_tpu_torch/helper_fx.py", '''\
        def hist_planes(state, dt):
            out = {}
            for nm in ("a", "b"):
                out[f"m_hist_{nm}"] = state[f"m_hist_{nm}"] + dt
            out["gid"] = state["gid"]
            return out


        def leak(state, dt):
            out = {}
            out["ballot"] = state["ballot"] + dt
            return out
        ''')
    path = put(root, "paxi_tpu_torch/protocols/fx/sim.py", '''\
        from paxi_tpu_torch import helper_fx


        def step(state, inbox, ctx):
            dt = ctx.t - state["m_prop_t"]
            planes = helper_fx.hist_planes(state, dt)
            st = dict(state, **planes)
            bad = helper_fx.leak(state, dt)
            return dict(st, **bad), {}
        ''')
    vs = measure.check(root, files=[path])
    # the leak is stored under a protocol key and returned
    assert [(v.code, v.line) for v in vs] == [("PXM101", 9),
                                              ("PXM102", 9)]


# ---- trace-map mutants ---------------------------------------------------
def _tracemap_root(tmp_path, twin: str, twin_of: bool = False) -> Path:
    """A registry of three sim protocols (``fx_var`` a variant on fx's
    kernel, ``fy`` without a host twin) and fx's host twin ``twin``
    (behind a ``TWIN_OF`` shim with ``twin_of``)."""
    fx_host = ("paxi_tpu_torch.protocols.fx.shim" if twin_of
               else "paxi_tpu_torch.protocols.fx.host")
    put(tmp_path, "paxi_tpu_torch/protocols/__init__.py", f'''\
        _SIM_MODULES = {{
            "fx": "paxi_tpu_torch.protocols.fx.sim",
            "fx_var": "paxi_tpu_torch.protocols.fx.sim:PROTOCOL_VAR",
            "fy": "paxi_tpu_torch.protocols.fy.sim",
        }}
        _HOST_MODULES = {{
            "fx": "{fx_host}",
        }}
        ''')
    for name in ("fx", "fy"):
        put(tmp_path, f"paxi_tpu_torch/protocols/{name}/sim.py", '''\
            def mailbox_spec(cfg):
                return {"p1a": ("bal",), "p2a": ("bal", "slot")}
            ''')
    put(tmp_path, "paxi_tpu_torch/protocols/fx/host.py", twin)
    put(tmp_path, "paxi_tpu_torch/protocols/fx/shim.py", '''\
        TWIN_OF = "paxi_tpu_torch.protocols.fx.host"
        ''')
    return tmp_path


TWIN_HEAD = (
    "from paxi_tpu_torch.host.codec import register_message\n\n\n"
    "@register_message\nclass P1a:\n    pass\n\n\n"
    "@register_message\nclass P2a:\n    pass\n\n\n")


def test_tracemap_mutants(tmp_path):
    root = _tracemap_root(
        tmp_path, TWIN_HEAD + 'TRACE_MSG_MAP = {"p1a": "P1a", "p3": "P3"}\n')
    vs = tracemap.check(root)
    got = sorted((v.code, v.path, v.line) for v in vs)
    host = "paxi_tpu_torch/protocols/fx/host.py"
    assert got == [
        ("PXT301", "paxi_tpu_torch/protocols/__init__.py", 4),   # fy
        ("PXT302", host, 14),                                     # p2a
        ("PXT303", host, 14),                                     # p3
        ("PXT304", host, 14),                                     # P3
    ]
    # the variant projects through its base's map, reported once
    assert sum("`p2a`" in v.message for v in vs) == 1
    # a twin without a map projects nothing
    bare = _tracemap_root(tmp_path, TWIN_HEAD)
    assert [v.code for v in tracemap.check(bare)] == ["PXT301"] * 3
    clean_twin = TWIN_HEAD + \
        'TRACE_MSG_MAP = {"p1a": "P1a", "p2a": "P2a"}\n'
    for twin_of in (False, True):
        clean = _tracemap_root(tmp_path, clean_twin, twin_of=twin_of)
        assert [v.code for v in tracemap.check(clean)] == ["PXT301"]


def test_tracemap_registry_is_the_ports():
    import importlib

    from paxi_tpu.analysis import tracemap as ref_tracemap
    from paxi_tpu_torch.protocols import _HOST_MODULES, _SIM_MODULES
    from paxi_tpu_torch.trace.host import host_algorithm, trace_msg_map
    names = {p for p, _, _ in tracemap.registry(ROOT)}
    assert names == set(_SIM_MODULES)
    maps = tracemap.trace_maps(ROOT)
    assert sorted(maps) == sorted(_HOST_MODULES)
    for name, (m, _) in maps.items():
        assert m == trace_msg_map(name), name
        base = importlib.import_module(_HOST_MODULES[name])
        assert m == base.TRACE_MSG_MAP, name
    for proto, mod, _ in tracemap.registry(ROOT):
        assert tracemap.base_protocol(proto, mod, maps) == \
            host_algorithm(proto)
    # each map read from the same twin file as the JAX package's rule
    # reads its twin's
    ref = {p: str(h.relative_to(ROOT)) for p, _, h
           in ref_tracemap.analyzed_pairs(ROOT)}
    files = tracemap.twin_modules(ROOT)
    for proto, path in ref.items():
        base = host_algorithm(proto)
        assert str(files[base].relative_to(ROOT)) == \
            path.replace("paxi_tpu/", "paxi_tpu_torch/", 1), proto


# ---- proof parity with the JAX package -----------------------------------
@pytest.fixture(scope="module")
def coverages():
    return crossflow.coverage(ROOT), ref_crossflow.coverage(ROOT)


def _to_port(rel: str) -> str:
    return rel.replace("paxi_tpu/", "paxi_tpu_torch/", 1)


def test_crossflow_coverage_equals_reference(coverages):
    """Every kernel, both consensus cores included: the same number of
    epoch-plane writes, each proven, by the same kinds of proof."""
    port, ref = coverages
    assert set(port) == {_to_port(k) for k in ref}
    for rel, want in ref.items():
        got = port[_to_port(rel)]
        assert (got["writes"], got["proven"], got["via"]) == \
            (want["writes"], want["proven"], want["via"]), rel
        assert got["proven"] == got["writes"], rel
    for rel in ("paxi_tpu_torch/sim/ballot_ring.py",
                "paxi_tpu_torch/sim/cell_ring.py"):
        assert "call-site" in port[rel]["via"], rel
    proofs = " ".join(port["paxi_tpu_torch/sim/cell_ring.py"]
                      ["call_site_proofs"])
    for kernel in ("paxos/sim.py", "sdpaxos/sim.py", "wankeeper/sim.py"):
        assert kernel in proofs, kernel


def test_crossflow_consumers_cover_the_reference(coverages):
    """Every module the reference counts as a consumer of a kernel or
    core is one here.  The port's extra consumers reach the module only
    through helpers that carry no proof obligation (no epoch-plane write,
    no ballot register read): ballot_ring's torch helpers ``popcount``/
    ``argmax_i32``/``ridx``, and the sliding-window twins' reuse of their
    fixed-cell kernel's setup and command codecs."""
    port, ref = coverages
    index = crossflow.shared_index(
        ROOT, extra_files=list(crossflow.astutil.iter_py(ROOT,
                                                         crossflow.TARGETS)))
    eng = crossflow._engine_for(index)
    for rel, want in ref.items():
        prel = _to_port(rel)
        got = set(port[prel]["consumers"])
        assert {_to_port(c) for c in want["consumers"]} <= got, rel
        extra = got - {_to_port(c) for c in want["consumers"]}
        if not extra:
            continue
        writers = {s.fn.name for s in crossflow.write_sites(
            eng, prel, crossflow.EPOCH_PLANES)}
        info = index.module(prel)
        for name, fns in info.functions.items():
            callers = {cs.caller_rel for cs in index.callers_of(prel, name)}
            if not callers & extra:
                continue
            ctx = eng.ctx(prel, fns[0])
            assert name not in writers, (prel, name)
            assert not eng.mentions_ballot(fns[0], ctx), (prel, name)


def _sim_sites(mod, prefix):
    props = mod.load_sim_props(ROOT)
    out = {}
    for path in mod.astutil.iter_py(ROOT, [f"{prefix}/protocols/*/sim.py",
                                           f"{prefix}/protocols/*/sim_pg.py"]):
        tree, _ = mod.astutil.parse_file(path)
        if not mod._is_sim_module(tree):
            continue
        rows = []
        for s in mod.sim_sites(tree, props, mod.Resolver(tree)):
            if s.kind == "count":
                val = [s.size_fn(n) for n in range(2, 16)]
            elif s.kind == "grid":
                val = [s.zones_fn(z, q) for z in range(1, 6)
                       for q in range(1, z + 1)]
            else:
                val = [(s.zones_fn(r, c), s.fill_fn(r, c))
                       for r in range(1, 5) for c in range(1, 5)]
            rows.append((s.kind, s.text, sorted(s.phases), s.universe,
                         s.resolved, val))
        out[path.relative_to(ROOT / prefix).as_posix()] = sorted(rows,
                                                                key=str)
    return out


def test_quorum_sim_sites_equal_reference():
    port = _sim_sites(quorum, "paxi_tpu_torch")
    ref = _sim_sites(ref_quorum, "paxi_tpu")
    assert port == ref
    assert sum(len(v) for v in port.values()) >= 15


# ---- the port's tree -----------------------------------------------------
@pytest.fixture(scope="module")
def cli_reports(tmp_path_factory):
    """``python -m paxi_tpu_torch lint`` on the tree, twice: with the
    baseline (``--strict-unused``, a SARIF copy beside) and without."""
    import contextlib
    import io

    from paxi_tpu_torch.cli import main
    sarif = tmp_path_factory.mktemp("lint") / "r.sarif"
    out = {}
    for key, argv in (("baseline", ["lint", "--strict-unused", "--json",
                                    "--sarif", str(sarif)]),
                      ("raw", ["lint", "--no-baseline", "--json"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        out[key] = (rc, json.loads(buf.getvalue()))
    out["sarif"] = json.loads(sarif.read_text())
    return out


@pytest.mark.parametrize("family", sorted(analysis.RULES))
def test_family_clean_on_port_tree(cli_reports, family):
    rc, report = cli_reports["baseline"]
    assert report["checked_files"] > 40 and family in report["timings"]
    kept = [v for v in report["violations"] if v["rule"] == family]
    assert kept == [], kept


def test_whole_lint_exits_zero_and_baseline_tight(cli_reports):
    rc, report = cli_reports["baseline"]
    assert rc == 0 and report["ok"] and report["unused_baseline"] == []
    # --no-baseline lists every baselined finding, and only those
    raw_rc, raw = cli_reports["raw"]
    assert raw_rc == 1

    def key(v):
        return (v["code"], v["path"], v["line"], v["col"])
    assert sorted(map(key, raw["violations"])) == \
        sorted(map(key, report["suppressed"]))
    for entry in load_baseline(analysis.DEFAULT_BASELINE):
        assert len(entry.reason) > 40, entry
    results = cli_reports["sarif"]["runs"][0]["results"]
    assert results and {r["level"] for r in results} == {"note"}
    assert all(r["suppressions"][0]["justification"] for r in results)


def test_purity_surface_is_the_step_path():
    """The runner's per-step code, every registered kernel's step and the
    kernel-library modules are in the surface; once-built planes, setup
    and host-side reporting are not."""
    surface = purity.Surface(ROOT, list(purity.astutil.iter_py(
        ROOT, purity.TARGETS)))
    names = {(rel, fn.name) for (rel, _), fn in surface.defs.items()}
    for want in (("paxi_tpu_torch/sim/runner.py", "_group_step"),
                 ("paxi_tpu_torch/sim/runner.py", "pg_step"),
                 ("paxi_tpu_torch/ops/exchange.py", "wheel_deliver"),
                 ("paxi_tpu_torch/random.py", "bernoulli"),
                 ("paxi_tpu_torch/protocols/epaxos/sim.py", "step"),
                 ("paxi_tpu_torch/protocols/paxos/sim_sw.py", "step"),
                 ("paxi_tpu_torch/scenarios/schedule.py", "forced_crash"),
                 ("paxi_tpu_torch/workload/compile.py", "key_plane")):
        assert want in names, want
    for never in (("paxi_tpu_torch/sim/mailbox.py", "_delay_plane"),
                  ("paxi_tpu_torch/sim/runner.py", "simulate"),
                  ("paxi_tpu_torch/sim/runner.py", "init_carry"),
                  ("paxi_tpu_torch/metrics/lathist.py", "summarize"),
                  ("paxi_tpu_torch/ops/exchange.py",
                   "make_remote_lane_shift")):
        assert never not in names, never
    runner_loops = surface.loops["paxi_tpu_torch/sim/runner.py"]
    assert [fn.name for fn, _ in runner_loops] == ["run_steps"]


# ---- the model and the CLI -----------------------------------------------
def test_baseline_parse_match_and_reason(tmp_path):
    f = tmp_path / "b.toml"
    f.write_text('[[suppress]]\ncode = "PXK104"\npath = "a.py"\n'
                 'match = "item"  # trailing comment\nreason = "why"\n')
    (s,) = load_baseline(f)
    v = Violation("kernel-purity", "PXK104", "a.py", 3, 0, "`.item()` x")
    kept, dropped = apply_suppressions([v], [s], {})
    assert kept == [] and dropped == [(v, "baseline: why")] and s.used
    f.write_text('[[suppress]]\ncode = "PXK104"\npath = "a.py"\n')
    with pytest.raises(ValueError, match="reason"):
        load_baseline(f)
    assert inline_disables("x = 1  # paxi-lint: disable=PXK104,PXK107\n"
                           "y = 2  # paxi-lint: disable=all\n") == \
        {1: {"PXK104", "PXK107"}, 2: {"all"}}
    assert Suppression("PXK", "a.py").matches(v)


def test_rule_prefixes_and_timings():
    assert analysis.resolve_rules(["PXK,PXF"]) == ["kernel-purity",
                                                   "cross-module-flow"]
    assert analysis.resolve_rules(["pxq", "quorum-safety"]) == \
        ["quorum-safety"]
    with pytest.raises(KeyError):
        analysis.resolve_rules(["PXH"])
    report = analysis.run_lint(rules=["PXL,PXW"])
    assert set(report.timings) == {"fixed-cell-layout", "workload-purity"}
    assert json.loads(report.to_json())["ok"] is True


def test_cli_lint_json_on_fixture(tmp_path, capsys):
    from paxi_tpu_torch.cli import main
    path = put(tmp_path, "fixture_workload.py",
               translate((FIX / "fixture_workload.py").read_text()))
    rc = main(["lint", str(path), "-rule", "workload-purity", "-json",
               "-no_baseline"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and not out["ok"]
    assert {v["code"] for v in out["violations"]} == {"PXW121", "PXW122",
                                                       "PXW123"}
    assert set(out) == {"ok", "violations", "suppressed", "unused_baseline",
                        "checked_files", "timings"}


def test_cli_lint_unknown_rule_rejected(capsys):
    from paxi_tpu_torch.cli import main
    assert main(["lint", "-rule", "no-such-rule"]) == 2
    assert "unknown rule" in capsys.readouterr().err


def test_cli_lint_graph(capsys):
    from paxi_tpu_torch.cli import main
    assert main(["lint", "--graph"]) == 0
    dot = capsys.readouterr().out
    assert dot.startswith("digraph") and "fillcolor" in dot
    assert '"paxi_tpu_torch.sim.ballot_ring:merge_acker_logs"' in dot
    assert "paxi_tpu_torch.protocols.paxos.sim:step" in dot
