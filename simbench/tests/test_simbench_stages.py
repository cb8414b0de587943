"""The spans pass's reduction (``simbench/stages.py``) on a synthetic
profile: boundaries matched to their event records through a known clock
offset and beside a record no span made, launches inside and outside the
spans, runtime calls with and without a wait, copies and idle gaps, give
the expected figures a stage and the six readers' values."""

import types

import pytest

from simbench import cells, stages
from simbench.stages import Event

OFF = 5_000_000_000_000        # the profile's clock minus the host's, ns
LAT = 1_000                    # a boundary's record's end to its stamp, ns
H0 = 1_000_000_000             # the episode's first stamp on the host, ns
MS = 1_000_000


def _doc(sid, parent, kind, t0, t1, **labels):
    return {"trace": "sim-ep0", "sid": sid, "parent": parent, "kind": kind,
            "node": "sim", "t0": t0 / 1e9, "t1": t1 / 1e9,
            "labels": labels}


def _episode(jitter=None):
    """init 1 ms, one round of eight 1 ms stages from 2 ms, finish at 11
    ms; ``jitter`` adds ns to one boundary's record latency."""
    jitter = jitter or {}
    docs = [_doc("s-1", "", "stage", H0, H0 + MS, stage="init")]
    r0 = H0 + 2 * MS
    docs.append(_doc("s-2", "", "round", r0, r0 + 8 * MS, t="0",
                     episode="0"))
    for i, name in enumerate(stages.STAGES):
        docs.append(_doc(f"s-{3 + i}", "s-2", "stage", r0 + i * MS,
                         r0 + (i + 1) * MS, stage=name, device_ms="0.5",
                         boundary_us="3.0"))
    docs.append(_doc("s-11", "", "stage", H0 + 11 * MS, H0 + 12 * MS,
                     stage="finish"))
    bounds = sorted({int(round(d[k] * 1e9)) for d in docs
                     for k in ("t0", "t1")})
    ev, corr = [], [1000]

    def call(name, at, dur):
        corr[0] += 1
        ev.append(Event(name, False, at, at + dur, corr[0]))
        return corr[0]

    for h in bounds:
        at = h + OFF - LAT - jitter.get(h, 0)
        call(stages.CAPTURE_CHECK, at - 3_000, 500)
        call("cudaEventRecordWithFlags", at - 2_000, 2_000)
    # a record no span made: the window's own mark between init and round
    call(stages.CAPTURE_CHECK, H0 + OFF + 1_500_000, 500)
    call("cudaEventRecordWithFlags", H0 + OFF + 1_501_000, 2_000)
    # a launch in counts that found the queue full
    ev.append(Event(stages.QUEUE_FULL, False,
                    r0 + 4 * MS + OFF + 300_000, r0 + 4 * MS + OFF + 350_000,
                    0))

    def stage_at(name, us):
        return r0 + stages.STAGES.index(name) * MS + OFF + us * 1_000

    def launch(name, at, dur, kernel, k_at, k_dur):
        c = call(name, at, dur)
        ev.append(Event(kernel, True, k_at, k_at + k_dur, c))

    # deliver: one launch, its kernel 50 us
    launch("cudaLaunchKernel", stage_at("deliver", 100), 10_000,
           "deliver_kernel(int*)", stage_at("deliver", 200), 50_000)
    # step: a launch, then one that waits 300 us on a full queue
    launch("cudaLaunchKernel", stage_at("step", 100), 10_000,
           "elementwise_kernel", stage_at("step", 400), 100_000)
    launch("cudaLaunchKernel", stage_at("step", 200), 300_000,
           "closure_kernel<5>", stage_at("step", 600), 200_000)
    # faults: a copy to the host and the wait for it
    launch("cudaMemcpyAsync", stage_at("faults", 100), 20_000,
           "Memcpy DtoH (Device -> Pinned)", stage_at("faults", 900), 5_000)
    call("cudaStreamSynchronize", stage_at("faults", 120), 100_000)
    # insert: its kernel after the device idled through counts
    launch("cudaLaunchKernel", stage_at("insert", 100), 10_000,
           "insert_kernel(int*)", stage_at("insert", 1_000), 50_000)
    # outside every span: between the round and finish
    launch("cudaLaunchKernel", r0 + 8 * MS + OFF + 500_000, 10_000,
           "vectorized_elementwise_kernel", r0 + 8 * MS + OFF + 510_000,
           10_000)
    return ev, docs


def test_match_finds_each_boundary_beside_a_stray_record():
    host = [100, 1_000_000, 2_000_000]
    recs = [OFF + 100 - LAT, OFF + 110, OFF + 995_000,
            OFF + 1_000_000 - LAT, OFF + 2_000_000 - LAT]
    got, off = stages.match(host, recs)
    assert got == [0, 3, 4] and off == OFF - LAT
    assert stages.match([], recs) == ([], 0.0)


def test_reduce_figures_a_stage():
    ev, docs = _episode()
    r = stages.reduce(ev, docs)
    assert r.rounds == 1 and r.boundaries == 13 and r.matched == 13
    assert r.offset_ns == OFF - LAT and r.spread_us == [0.0]
    s = r.stages
    assert list(s) == list(stages.STAGES)
    assert (s["deliver"].launches, s["deliver"].runtime_calls) == (1, 1)
    assert s["deliver"].runtime_ms == pytest.approx(0.01)
    assert s["deliver"].device_ms == pytest.approx(0.05)
    assert s["step"].launches == 2
    assert s["step"].runtime_ms == pytest.approx(0.31)
    assert s["faults"].copies == 1 and s["faults"].runtime_calls == 2
    assert s["faults"].runtime_ms == pytest.approx(0.12)
    # a stage's closing boundary costs it 3 us of host time
    assert s["keys"].recorder_ms == pytest.approx(0.003)
    assert s["deliver"].dispatch_ms == pytest.approx(1 - 0.01 - 0.003)
    assert s["step"].event_ms == 0.5
    assert s["step"].host_ms == pytest.approx(1.0)
    # a gap falls to the stage that launched the operation ending it
    assert s["step"].idle_ms == pytest.approx(1.15 + 0.1)
    assert s["faults"].idle_ms == pytest.approx(1.1)
    assert s["insert"].idle_ms == pytest.approx(2.095)
    rnd = r.round
    assert rnd.launches == 5 and rnd.copies == 1 and rnd.spans == 1
    assert s["counts"].queue_full == rnd.queue_full == 1
    assert rnd.host_ms == pytest.approx(8.0)
    assert rnd.runtime_ms == pytest.approx(0.01 + 0.31 + 0.12 + 0.01)
    assert rnd.recorder_ms == pytest.approx(8 * 0.003)
    assert r.device_ops == 6          # the launch outside every span too
    assert set(r.episode) == {"init", "finish"}
    assert r.episode["init"].launches == 0
    assert r.named == {"deliver_kernel": {"deliver": 1},
                       "insert_kernel": {"insert": 1},
                       "closure_kernel": {"step": 1}}
    assert r.named_share() == 100.0
    line = r.line()
    assert set(line) == {"stages", "stages_round", "stages_episode",
                         "stages_pass"}
    assert line["stages"]["step"]["launches"] == 2


def test_spread_and_a_kernel_in_the_wrong_stage():
    ev, docs = _episode(jitter={H0 + 5 * MS: 3_000})
    r = stages.reduce(ev, docs)
    assert r.spread_us == [pytest.approx(3.0)]
    # the named kernel launched from another stage counts against the share
    ev = [e._replace(name="deliver_kernel(int*)")
          if e.name == "elementwise_kernel" else e for e in ev]
    r = stages.reduce(ev, docs)
    assert r.named["deliver_kernel"] == {"deliver": 1, "step": 1}
    assert r.named_share() == pytest.approx(75.0)


READERS = {
    "runner.dispatch_ms_per_round": 8.0 - 0.45 - 0.024,
    "runner.runtime_ms_per_round": 0.45,
    "runner.dispatch_us_per_launch": (8.0 - 0.45 - 0.024) * 1e3 / 5,
    "protocol_step.dispatch_ms_per_round": 1 - 0.31 - 0.003,
    "faults.dispatch_ms_per_round": 1 - 0.12 - 0.003,
    "runner.copies_per_round": 1.0,
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers(metric):
    ev, docs = _episode()
    r = types.SimpleNamespace(stage_reading=stages.reduce(ev, docs))
    assert cells.reader(metric).read(r) == pytest.approx(READERS[metric])
    # a program without spans (the reading made no stage reading)
    assert cells.reader(metric).read(
        types.SimpleNamespace(stage_reading=None)) is None


def test_no_copies_read_zero():
    ev, docs = _episode()
    ev = [e for e in ev if not e.name.startswith("Memcpy")]
    r = types.SimpleNamespace(stage_reading=stages.reduce(ev, docs))
    assert cells.reader("runner.copies_per_round").read(r) == 0.0


def test_of_outside_the_harness_and_an_older_runner():
    r = types.SimpleNamespace(rounds=1)
    assert stages.of(r) is None and r.stage_reading is None

    def make_scan_body(proto, cfg, fuzz):
        pass
    assert not stages.takes_spans(types.SimpleNamespace(
        make_scan_body=make_scan_body))
    from paxi_tpu_torch.sim import runner
    assert stages.takes_spans(runner)


def test_new_metrics_are_in_the_benchmark():
    spec = cells.benchmark()
    names = {m["name"]: m for m in spec["per_layer"]}
    for metric in READERS:
        m = names[metric]
        assert m["source"] == "device_trace" and m["moves"] == "cmds_per_s"
        assert m["workloads"]
