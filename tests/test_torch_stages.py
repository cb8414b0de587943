"""Spans inside the port's round loop (``sim/runner.py`` with an
``obs.SpanCollector``): a run with a collector gives the same state,
metrics and violations bit for bit as one without; without one the loop
reads no clock and records no event; with one every round is one
``round`` span holding its eight ``stage`` spans in order, each episode
one trace with its ``init`` and ``finish`` stages, and the export passes
the span schema and renders as a Chrome trace."""

import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paxi_tpu_torch import obs
from paxi_tpu_torch import random as tr
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig, SimConfig
from paxi_tpu_torch.sim import runner

STAGES = ("keys", "deliver", "step", "faults", "counts", "insert",
          "invariants", "flush")
G, T, SEED = 4, 6, 7
CASES = {
    "paxos": (dict(n_replicas=3, n_slots=16), dict()),
    "paxos_fuzz": (dict(n_replicas=3, n_slots=16),
                   dict(p_drop=0.2, p_dup=0.1, max_delay=2)),
    "epaxos": (dict(n_replicas=3, n_slots=8, n_keys=2), dict()),
    "paxos_pg": (dict(n_replicas=3, n_slots=16), dict(p_drop=0.1)),
}


def _proto(case):
    return sim_protocol(case.replace("_fuzz", ""))


def _run(case, spans=None):
    cfg, fz = CASES[case]
    run = runner.make_run(_proto(case), SimConfig(**cfg), FuzzConfig(**fz),
                          device="cpu", spans=spans)
    return run(tr.PRNGKey(SEED), G, T)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_results_with_and_without_a_collector(case):
    spans = obs.SpanCollector(node="sim", cap=1024)
    (s0, m0, v0), (s1, m1, v1) = _run(case), _run(case, spans)
    assert sorted(s0) == sorted(s1) and sorted(m0) == sorted(m1)
    pairs = [(s0[k], s1[k]) for k in s0] + [(m0[k], m1[k]) for k in m0]
    for x, y in pairs + [(v0, v1)]:
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert len(spans) == 2 + T * (1 + len(STAGES))


class _Ops(TorchDispatchMode):
    """Every aten operator dispatched inside it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["paxos_fuzz", "epaxos"])
def test_same_operators_with_and_without_a_collector(case):
    """The recorder dispatches no operator: the run's operators (each a
    launch on the card) are the same, in the same order."""
    seen = []
    for spans in (None, obs.SpanCollector(node="sim", cap=1024)):
        with _Ops() as mode:
            _run(case, spans)
        seen.append(mode.ops)
    assert seen[0] == seen[1] and len(seen[0]) > 100


class _Raise:
    def __init__(self, *a, **k):
        raise AssertionError("the loop read a clock or made an event")


@pytest.mark.parametrize("case", ["paxos_fuzz", "paxos_pg"])
def test_no_clock_and_no_event_without_a_collector(case, monkeypatch):
    cfg, fz = CASES[case]
    proto, cfg, fz = _proto(case), SimConfig(**cfg), FuzzConfig(**fz)
    body = runner.make_scan_body(proto, cfg, fz)
    with torch.inference_mode():
        for name in ("perf_counter", "perf_counter_ns", "time", "time_ns",
                     "monotonic", "monotonic_ns"):
            monkeypatch.setattr(time, name, _Raise)
        monkeypatch.setattr(torch.cuda, "Event", _Raise)
        carry = runner.init_carry(proto, cfg, fz, G, tr.PRNGKey(SEED), "cpu")
        viols = torch.zeros((), dtype=torch.int32)
        for t in range(3):
            carry, (viol, _) = body(carry, t)
            viols = viols + viol
        runner.finish_run(proto, cfg, carry, viols, {})
        monkeypatch.undo()
    # the same guard catches a collector's clock
    with pytest.raises(AssertionError):
        monkeypatch.setattr(time, "perf_counter", _Raise)
        obs.SpanCollector(node="sim").stage("init")
    monkeypatch.undo()


def _tree(spans):
    docs = spans.export()
    rounds = [d for d in docs if d["kind"] == "round"]
    stages = {}
    for d in docs:
        if d["kind"] == "stage":
            stages.setdefault(d["parent"], []).append(d)
    return docs, rounds, stages


@pytest.mark.parametrize("case", ["paxos", "epaxos", "paxos_pg"])
def test_rounds_hold_their_stages_in_order(case):
    spans = obs.SpanCollector(node="sim", cap=1024)
    _run(case, spans)
    _run(case, spans)
    docs, rounds, stages = _tree(spans)
    assert {d["kind"] for d in docs} == {"round", "stage"}
    assert len(rounds) == 2 * T
    traces = sorted({d["trace"] for d in docs})
    assert len(traces) == 2           # one trace an episode
    for n, trace in enumerate(traces):
        mine = [d for d in docs if d["trace"] == trace]
        top = [d["labels"]["stage"] for d in stages[""] if d in mine]
        assert top == ["init", "finish"]
        ts = [d["labels"]["t"] for d in mine if d["kind"] == "round"]
        assert ts == [str(t) for t in range(T)]
        assert all(d["labels"]["episode"] == str(n) for d in mine
                   if d["kind"] == "round")
    for r in rounds:
        kids = stages[r["sid"]]
        assert [k["labels"]["stage"] for k in kids] == list(STAGES)
        # contiguous: each boundary closes one stage and opens the next
        assert kids[0]["t0"] == r["t0"] and kids[-1]["t1"] == r["t1"]
        for a, b in zip(kids, kids[1:]):
            assert a["t1"] == b["t0"] and a["t0"] <= a["t1"]
        assert all(k["trace"] == r["trace"] for k in kids)


def test_export_validates_and_renders():
    spans = obs.SpanCollector(node="sim", cap=1024)
    _run("paxos", spans)
    spans.resolve()                   # no events on the CPU: no labels
    docs = spans.export()
    assert obs.validate_spans(docs) == []
    assert not any("device_ms" in d["labels"] for d in docs)
    doc = obs.chrome_trace(docs)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(docs)
    assert {e["name"] for e in xs} == {"round", "stage"}
    assert "round" in obs.KINDS and "stage" in obs.KINDS
    assert "trace sim-ep0" in obs.ascii_timeline(docs)


class _FakeEvent:
    """A CUDA event on the host: its time is the order of its record."""
    recorded = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        self.at = len(_FakeEvent.recorded)
        _FakeEvent.recorded.append(self)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_boundaries_record_one_event_each(monkeypatch):
    """On a CUDA device each boundary records one event, shared by the
    span it closes and the span it opens; ``resolve`` labels every span
    with the events' milliseconds."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.recorded = []
    spans = obs.SpanCollector(node="sim", cap=64)
    spans.episode("cuda:0")
    spans.stage("init")
    spans.end()
    for t in range(2):
        spans.round(t, "keys")
        for name in STAGES[1:]:
            spans.stage(name)
        spans.end()
    spans.stage("finish")
    spans.end()
    # init: 2 boundaries; a round: 8 stage starts and its end; finish: 2
    assert len(_FakeEvent.recorded) == 2 + 2 * len(STAGES) + 2 + 2
    spans.resolve()
    docs = spans.export()
    ms = {(d["kind"], d["labels"].get("stage"), d["labels"].get("t")):
          float(d["labels"]["device_ms"]) for d in docs}
    assert ms["stage", "init", None] == 1.0
    assert ms["round", None, "0"] == float(len(STAGES))
    assert all(ms["stage", s, None] == 1.0 for s in ("init", "finish"))
    assert all(float(d["labels"]["boundary_us"]) >= 0 for d in docs)
    assert obs.validate_spans(docs) == []


def test_profile_writes_the_spans_beside_the_trace(tmp_path):
    """``profile --trace-dir D`` writes the timed runs' spans as
    ``D/spans.json`` beside ``D/trace.json``."""
    import json

    from paxi_tpu_torch.profiling import run_profile
    rep = run_profile(algorithm="paxos", groups=4, steps=3, replicas=3,
                      slots=16, repeats=2, trace_dir=str(tmp_path),
                      device="cpu")
    assert rep["invariant_violations"] == 0
    assert (tmp_path / "trace.json").is_file()
    doc = json.loads((tmp_path / "spans.json").read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2 * (2 + 3 * (1 + len(STAGES)))
    assert {e["args"].get("stage") for e in xs} \
        == set(STAGES) | {"init", "finish", None}
