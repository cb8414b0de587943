"""The rooflines' byte counts at the cells' shapes against hand sums, and
the readers on made-up traces."""

import pytest

from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import SimConfig
from simbench import cells
from simbench.trace import TraceReading

EXCHANGE = cells.reader("exchange.roofline_pct")
CLOSURE = cells.reader("closure.roofline_pct")
G = 100_000
E = 5 * 5 * G


def _spec(protocol, **sim):
    return sim_protocol(protocol).mailbox_spec(SimConfig(**sim))


def test_exchange_bytes_paxos_by_hand():
    # five types of 1, 1, 3, 2 and 4 int32 fields: 11 fields, 5 valid
    # planes; deliver moves each message twice, insert twice plus its
    # drop, dup and delay planes (6 bytes an edge); conn and crashed once
    msgs = 5 * E + 4 * 11 * E
    want = 2 * msgs + 2 * msgs + 5 * 6 * E + E + 5 * G
    spec = _spec("paxos", n_replicas=5, n_slots=64)
    assert EXCHANGE.needed_bytes(spec, 5, G) == want == 568_000_000


def test_exchange_bytes_epaxos_by_hand():
    spec = _spec("epaxos", n_replicas=5, n_slots=16, n_keys=4)
    fields = sum(len(f) for f in spec.values())
    assert len(spec) == 11 and fields == 78
    want = 4 * (11 * E + 4 * fields * E) + 11 * 6 * E + E + 5 * G
    assert EXCHANGE.needed_bytes(spec, 5, G) == want


def test_layout_bytes_match_the_kernel_table():
    # PERF.md's kernel table: paxos d = 1 bounds 0.1321 + 0.1554 ms,
    # d = 3 0.3231 + 0.3464 ms at 3.35 TB/s
    spec = _spec("paxos", n_replicas=5, n_slots=64)
    assert EXCHANGE.layout_bytes(spec, 1, 5, G) == 963_000_000
    assert EXCHANGE.layout_bytes(spec, 3, 5, G) == 2_243_000_000
    assert EXCHANGE.needed_bytes(spec, 5, G) < \
        EXCHANGE.layout_bytes(spec, 1, 5, G)


def test_closure_bytes_by_hand():
    assert CLOSURE.needed_bytes(5 * G, 80) == 6_400_000_000


def _reading(**kw):
    shapes = {"groups": G, "replicas": 5, "n_slots": 16, "wheel": 1,
              "spec": _spec("paxos", n_replicas=5, n_slots=64)}
    return TraceReading(rounds=10, window_s=1.0, shapes=shapes, **kw)


def test_readers_on_a_made_up_trace():
    r = _reading(busy_s=0.8, device_ops=20_000,
                 kernels={"void deliver_kernel(T)": [1_000.0, 10],
                          "insert_kernel": [1_000.0, 10],
                          "closure_kernel(x)": [19_104.0, 10],
                          "other": [5.0, 1]},
                 ranges={"protocol_step": 300_000.0, "faults": 0.0})
    assert EXCHANGE.read(r) == pytest.approx(
        100 * 568e6 * 10 / 3.35e12 / 2e-3)
    assert CLOSURE.read(r) == pytest.approx(100 * 6.4e9 / 3.35e12 / 1.9104e-3)
    assert cells.reader("device.idle_pct").read(r) == pytest.approx(20.0)
    assert cells.reader("runner.launches_per_round").read(r) == 2_000
    assert cells.reader("protocol_step.ms_per_round").read(r) == 30.0
    # nothing to read: no value, never 0 for a share
    assert cells.reader("faults.ms_per_round").read(r) is None
    empty = _reading()
    for name in ("exchange.roofline_pct", "closure.roofline_pct",
                 "device.idle_pct", "runner.launches_per_round",
                 "invariants.ms_per_round"):
        assert cells.reader(name).read(empty) is None
