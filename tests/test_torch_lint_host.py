"""The port's host lint families (paxi_tpu_torch/analysis: PXH, PXC, PXB,
PXA, PXO, PXD, PXE, PXR, PXV, PXS and PXQ's host forms) against the JAX
package's (paxi_tpu/analysis):

- each reference host fixture, translated, gives the port's family the
  same findings (code, path, line, column, message) as the reference
  family gives on the original;
- on the two trees, with no baseline, the port's host findings equal the
  reference's keyed by code, path (package renamed) and enclosing
  function, apart from ``TREE_PORT_ONLY`` and ``TREE_REF_ONLY``, each
  with its reason;
- the coverage pins of epoch-fence, lease-flow and wire-record, the
  derived ``*_MAGIC`` universe, the sim-host-parity pairs and the host
  quorum sites equal the reference's on its tree;
- with the baseline, the port's tree keeps no finding and suppresses
  ``SUPPRESSED_BY_PREFIX``, the counts ``chip_smoke.py``'s lint phase is
  held to on the card's machine.

One tree run per package (module-scoped fixtures); no module under
analysis is imported.
"""

import ast
import shutil
from collections import Counter
from pathlib import Path

import pytest

pytest.importorskip("jax")

from paxi_tpu import analysis as ref_analysis  # noqa: E402
from paxi_tpu.analysis import asyncflow as ref_asyncflow  # noqa: E402
from paxi_tpu.analysis import ballots as ref_ballots  # noqa: E402
from paxi_tpu.analysis import concurrency as ref_concurrency  # noqa: E402
from paxi_tpu.analysis import determinism as ref_determinism  # noqa: E402
from paxi_tpu.analysis import epochfence as ref_epochfence  # noqa: E402
from paxi_tpu.analysis import handlers as ref_handlers  # noqa: E402
from paxi_tpu.analysis import leaseflow as ref_leaseflow  # noqa: E402
from paxi_tpu.analysis import parity as ref_parity  # noqa: E402
from paxi_tpu.analysis import quorum as ref_quorum  # noqa: E402
from paxi_tpu.analysis import spanrule as ref_spanrule  # noqa: E402
from paxi_tpu.analysis import tracemap as ref_tracemap  # noqa: E402
from paxi_tpu.analysis import wirerecord as ref_wirerecord  # noqa: E402
from paxi_tpu_torch import analysis  # noqa: E402
from paxi_tpu_torch.analysis import (asyncflow, ballots,  # noqa: E402
                                     concurrency, determinism, epochfence,
                                     handlers, leaseflow, parity, quorum,
                                     spanrule, tracemap, wirerecord)
from paxi_tpu_torch.analysis.model import (apply_suppressions,  # noqa: E402
                                           inline_disables, load_baseline)
from test_torch_lint import translate  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures" / "lint"
FIX_REL = "tests/fixtures/lint"

HOST_FAMILIES = [ref_handlers.RULE, ref_concurrency.RULE, ref_quorum.RULE,
                 ref_ballots.RULE, ref_parity.RULE, ref_asyncflow.RULE,
                 ref_spanrule.RULE, ref_determinism.RULE,
                 ref_epochfence.RULE, ref_leaseflow.RULE,
                 ref_wirerecord.RULE]

# the port's baselined findings by code prefix on its own tree; the lint
# phase of chip_smoke.py holds the card machine's run to the same counts
SUPPRESSED_BY_PREFIX = {"PXB": 4, "PXD": 15, "PXK": 6, "PXL": 4, "PXT": 2}

# host findings (no baseline) of one tree only, keyed as ``tree_keys``
# keys them (the reference's spelling of the path), each with its reason
TREE_PORT_ONLY = {
    ("PXD143", "paxi_tpu/host/native.py", "_build"):
        "the port builds its lincheck library itself and reads CXX for "
        "the compiler; the JAX package runs make -C native",
}
TREE_REF_ONLY = {
    ("PXD143", "paxi_tpu/shard/cluster.py", "ShardedCluster.start"):
        "the JAX package forwards os.environ into its group subprocesses "
        "(JAX_PLATFORMS pinning); the port's cluster.py forwards nothing",
}


def qualname_at(path: Path, line: int) -> str:
    """The qualified name of the innermost function holding ``line``
    (``Class.method``, ``fn.inner``), or ``<module>``."""
    best = "<module>"

    def walk(node, prefix):
        nonlocal best
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                if child.lineno <= line <= child.end_lineno:
                    name = prefix + child.name
                    if not isinstance(child, ast.ClassDef):
                        best = name
                    walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(ast.parse(path.read_text()), "")
    return best


def tree_keys(violations) -> Counter:
    return Counter((v.code, v.path.replace("paxi_tpu_torch/", "paxi_tpu/", 1),
                    qualname_at(ROOT / v.path, v.line))
                   for v in violations)


def full(violations):
    return sorted((v.code, v.path, v.line, v.col, v.message)
                  for v in violations)


def to_port(rel: str) -> str:
    return rel.replace("paxi_tpu/", "paxi_tpu_torch/", 1)


# ---- the two trees, one run each -----------------------------------------
@pytest.fixture(scope="module")
def trees():
    """The reference's host families on its tree, and the port's whole
    lint on its tree, both with no baseline; the port's baseline applied
    by hand to the same findings."""
    ref = ref_analysis.run_lint(rules=HOST_FAMILIES, baseline_path=None)
    port = analysis.run_lint(baseline_path=None)
    baseline = load_baseline(analysis.DEFAULT_BASELINE)
    inline = {p: inline_disables((ROOT / p).read_text())
              for p in {v.path for v in port.violations}}
    kept, dropped = apply_suppressions(port.violations, baseline, inline)
    host = set(HOST_FAMILIES)
    return {"ref": ref.violations,
            "port": [v for v in port.violations if v.rule in host],
            "timings": port.timings, "kept": kept,
            "suppressed": [v for v, _ in dropped],
            "unused": [s for s in baseline if not s.used]}


def test_host_findings_equal_reference_on_tree(trees):
    port, ref = tree_keys(trees["port"]), tree_keys(trees["ref"])
    assert port - ref == Counter(list(TREE_PORT_ONLY))
    assert ref - port == Counter(list(TREE_REF_ONLY))
    assert sum(ref.values()) == 19     # 4 PXB603, 15 PXD141/PXD143
    assert {c for c, _, _ in ref} == {"PXB603", "PXD141", "PXD143"}


def test_port_tree_suppressed_counts_pinned(trees):
    assert trees["kept"] == [] and trees["unused"] == []
    got = Counter(v.code[:3] for v in trees["suppressed"])
    assert dict(got) == SUPPRESSED_BY_PREFIX
    smoke = ast.parse((ROOT / "chip_smoke.py").read_text())
    (pin,) = [ast.literal_eval(node.value) for node in smoke.body
              if isinstance(node, ast.Assign)
              and [ast.unparse(t) for t in node.targets]
              == ["LINT_SUPPRESSED"]]
    assert pin == SUPPRESSED_BY_PREFIX
    assert set(trees["timings"]) == set(analysis.RULES)


def test_rules_and_prefixes_are_the_references():
    assert list(analysis.RULES) == list(ref_analysis.RULES)
    assert list(analysis.CODE_PREFIXES) == list(ref_analysis.CODE_PREFIXES)
    assert analysis.CODE_PREFIXES == ref_analysis.CODE_PREFIXES
    for name in HOST_FAMILIES:
        ref = ref_analysis.RULES[name]
        if hasattr(ref, "TARGETS"):
            assert list(analysis.RULES[name].TARGETS) == \
                [to_port(t) for t in ref.TARGETS], name


def test_concurrency_reads_the_ports_own_files():
    """Files with no counterpart in the reference are in PXC's target
    set: the concurrent nvcc builds, the g++ build and the rank
    launcher."""
    files = {p.relative_to(ROOT).as_posix() for p in
             concurrency.astutil.iter_py(ROOT, concurrency.TARGETS)}
    for rel in ("paxi_tpu_torch/ops/_build.py",
                "paxi_tpu_torch/host/native.py",
                "paxi_tpu_torch/parallel/launch.py"):
        assert rel in files, rel


# ---- the reference fixtures, translated ----------------------------------
@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """A root holding the port's modules that the fixtures import or the
    families read beside them (``core/`` with the quorum predicates and
    the wire types, ``host/`` with ``Node`` and ``register_message``,
    ``switchnet/``, ``sim/types.py``) and the fixtures directory."""
    root = tmp_path_factory.mktemp("host_lint")
    pkg = root / "paxi_tpu_torch"
    for sub in ("core", "host", "switchnet"):
        shutil.copytree(ROOT / "paxi_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "sim").mkdir()
    for rel in ("__init__.py", "sim/types.py"):
        shutil.copy(ROOT / "paxi_tpu_torch" / rel, pkg / rel)
    (root / FIX_REL).mkdir(parents=True)
    for path in FIX.glob("*.py"):
        (root / FIX_REL / path.name).write_text(translate(path.read_text()))
    return root


FAMILY_FIXTURES = [
    ("handlers", ref_handlers, handlers, ("fixture_host.py",)),
    ("concurrency", ref_concurrency, concurrency, ("fixture_locked.py",)),
    ("quorum_host", ref_quorum, quorum, ("fixture_quorum.py",)),
    ("quorum_switch_host", ref_quorum, quorum, ("fixture_switch_host.py",)),
    ("ballots", ref_ballots, ballots, ("fixture_ballot.py",)),
    ("asyncflow", ref_asyncflow, asyncflow, ("fixture_async.py",)),
    ("spanrule", ref_spanrule, spanrule, ("fixture_spanhost.py",)),
    ("determinism", ref_determinism, determinism,
     ("fixture_determinism.py",)),
    ("epochfence", ref_epochfence, epochfence, ("fixture_epoch.py",)),
    ("leaseflow", ref_leaseflow, leaseflow, ("fixture_lease.py",)),
    ("wirerecord", ref_wirerecord, wirerecord, ("fixture_wire.py",)),
]


@pytest.mark.parametrize("label,ref,port,names", FAMILY_FIXTURES,
                         ids=[f[0] for f in FAMILY_FIXTURES])
def test_translated_host_fixture_same_findings(fixture_root, label, ref,
                                               port, names):
    want = ref.check(ROOT, files=[FIX / n for n in names])
    got = port.check(fixture_root,
                     files=[fixture_root / FIX_REL / n for n in names])
    assert want, f"the reference reports nothing on {names}"
    assert full(got) == full(want)


PAIR_FIXTURES = [
    ("tracemap_badmap", ref_tracemap, tracemap, "fixture_sim.py",
     "fixture_host_badmap.py"),
    ("tracemap_nomap", ref_tracemap, tracemap, "fixture_sim.py",
     "fixture_host_nomap.py"),
    ("parity_drift", ref_parity, parity, "fixture_parity_sim.py",
     "fixture_parity_host.py"),
    ("parity_nomap", ref_parity, parity, "fixture_parity_sim.py",
     "fixture_parity_nomap.py"),
]


@pytest.mark.parametrize("label,ref,port,sim,host", PAIR_FIXTURES,
                         ids=[f[0] for f in PAIR_FIXTURES])
def test_translated_pair_fixture_same_findings(fixture_root, label, ref,
                                               port, sim, host):
    want = ref.check_pair("fixture", FIX / sim, FIX / host, ROOT)
    got = port.check_pair("fixture", fixture_root / FIX_REL / sim,
                          fixture_root / FIX_REL / host, fixture_root)
    assert want, f"the reference reports nothing on {sim} x {host}"
    assert full(got) == full(want)


# ---- proof surfaces against the reference's ------------------------------
@pytest.mark.parametrize("ref,port", [(ref_epochfence, epochfence),
                                      (ref_leaseflow, leaseflow),
                                      (ref_wirerecord, wirerecord)],
                         ids=["epochfence", "leaseflow", "wirerecord"])
def test_coverage_pins_equal_reference(ref, port):
    want = {to_port(k): v for k, v in ref.coverage(ROOT).items()}
    got = port.coverage(ROOT)
    assert got and got == want


def test_wirerecord_magic_universe_is_the_ports():
    from paxi_tpu_torch.core import command
    rel = "paxi_tpu_torch/core/command.py"
    mod = wirerecord._Module(rel, ast.parse((ROOT / rel).read_text()))
    names = {n for n in dir(command) if n.endswith("_MAGIC")}
    assert mod.magic_values == {n: getattr(command, n) for n in names}
    assert set(command.RESERVED_PREFIXES) == \
        {mod.magic_values[n] for n in mod.reserved}
    ref = wirerecord._Module(rel, ast.parse(
        (ROOT / "paxi_tpu/core/command.py").read_text()))
    assert (mod.magic_values, mod.reserved) == (ref.magic_values,
                                                ref.reserved)


def test_parity_covers_every_registry_pair():
    pairs = parity.analyzed_pairs(ROOT)
    want = ref_parity.analyzed_pairs(ROOT)
    assert [(p, to_port(s.relative_to(ROOT).as_posix()),
             to_port(h.relative_to(ROOT).as_posix())) for p, s, h in want] \
        == [(p, s.relative_to(ROOT).as_posix(),
             h.relative_to(ROOT).as_posix()) for p, s, h in pairs]
    # every kernel of the registry is paired with its twin
    sims = {tracemap._module_to_path(m, ROOT)
            for _, m, _ in tracemap.registry(ROOT)}
    assert {s for _, s, _ in pairs} == {s for s in sims if s.exists()}
    # and the state reader finds the reference's fields in each kernel
    for (p, s, _), (_, rs, _) in zip(pairs, want):
        assert parity.sim_state_fields(s) and \
            sorted(f for f, _ in parity.sim_state_fields(s)) == \
            sorted(f for f, _ in ref_parity.sim_state_fields(rs)), p


def _host_sites(mod, prefix):
    preds = mod.load_predicates(ROOT)
    out = {}
    for path in mod.astutil.iter_py(ROOT, [f"{prefix}/protocols/*/host.py"]):
        tree, _ = mod.astutil.parse_file(path)
        rows = []
        for s in mod.host_sites(tree, preds, mod.Resolver(tree)):
            if s.kind == "count":
                val = [s.size_fn(n) for n in range(2, 16)]
            elif s.kind == "grid":
                val = [s.zones_fn(z, q) for z in range(1, 6)
                       for q in range(1, z + 1)]
            else:
                val = [s.zones_fn(r, c) for r in range(1, 5)
                       for c in range(1, 5)]
            rows.append((s.kind, s.line, s.text, sorted(s.phases),
                         s.universe, s.resolved, val))
        out[path.relative_to(ROOT / prefix).as_posix()] = sorted(rows,
                                                                key=str)
    return out


def test_quorum_host_sites_equal_reference():
    port = _host_sites(quorum, "paxi_tpu_torch")
    assert port == _host_sites(ref_quorum, "paxi_tpu")
    kinds = Counter(row[0] for rows in port.values() for row in rows)
    assert set(kinds) == {"count", "grid", "rowcol"}
    assert sum(kinds.values()) >= 20


def test_quorum_host_forms_fire(tmp_path):
    """PXQ501's strict fractional threshold (the reference's regression:
    ``size > n/3`` passes from floor(n/3)+1) and the switch-handler form
    on the port's predicate model."""
    (tmp_path / "host.py").write_text(
        "class R:\n"
        "    def _write_done(self, op):\n"
        "        if op.quorum.size() > self.cfg.n / 3: pass\n"
        "    def _read_done(self, op):\n"
        "        if op.quorum.size() > self.cfg.n / 3: pass\n")
    preds = quorum.load_predicates(ROOT)
    assert (preds.count["majority"](5), preds.count["fast_quorum"](5)) == \
        (3, 4)
    vs = quorum.check_file(tmp_path / "host.py", tmp_path, preds,
                           quorum.load_sim_props(ROOT))
    assert [v.code for v in vs] == ["PXQ501"]
    assert "n=2" in vs[0].message and "1+1 <= 2" in vs[0].message
    assert quorum.check(ROOT, files=[
        ROOT / "paxi_tpu_torch/protocols/switchpaxos/sim.py",
        ROOT / "paxi_tpu_torch/protocols/switchpaxos/host.py"]) == []
