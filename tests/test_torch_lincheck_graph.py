"""Two small modules of the port against the JAX package's, on the CPU.

- ``paxi_tpu_torch.sim.lincheck.stale_read_anomalies`` (torch tensor
  code, here on the CPU) against ``paxi_tpu.sim.lincheck``'s numpy
  checker: the cases of ``tests/test_history.py``, hand-made stale,
  future, unsourced and initial-value reads, ties in the read-write match
  (a read matching several writes takes the first, as numpy's argmax
  does), numpy inputs and torch inputs, integer and float clocks, and
  seeded random batches, one of them chunked along the batch axis by
  ``max_elems``.  Equality is exact, dtype included (int32).
- ``paxi_tpu_torch.utils.graph`` (``Graph`` SCC/BFS, ``PriorityQueue``)
  against ``paxi_tpu.utils.graph`` on the cases of ``tests/test_graph.py``
  and seeded random graphs and queues.
"""

import random

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from paxi_tpu.sim.lincheck import stale_read_anomalies as ref_lincheck  # noqa: E402,E501
from paxi_tpu.utils import graph as ref_graph  # noqa: E402
from paxi_tpu_torch.sim.lincheck import stale_read_anomalies  # noqa: E402
from paxi_tpu_torch.utils import graph as port_graph  # noqa: E402


def _arrays(rows):
    """rows: (key, is_read, val, start, end) of one group."""
    n = len(rows)
    key = np.array([[r[0] for r in rows]], np.int32)
    is_read = np.array([[r[1] for r in rows]], bool)
    val = np.array([[r[2] for r in rows]], np.int32)
    start = np.array([[r[3] for r in rows]], np.float64)
    end = np.array([[r[4] for r in rows]], np.float64)
    return np.ones((1, n), bool), key, is_read, val, start, end


def _check(planes, **kw):
    want = ref_lincheck(*planes, **kw)
    got = stale_read_anomalies(*planes, device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert got.device.type == "cpu" and want.dtype == np.int32
    assert got.numpy().tolist() == want.tolist()
    return got.numpy().tolist()


HISTORY_CASES = {
    # tests/test_history.py's vectorized cases
    "sequential_ok": ([(0, False, 7, 0, 1), (0, True, 7, 2, 3),
                       (0, False, 8, 4, 5), (0, True, 8, 6, 7)], [0]),
    "stale": ([(0, False, 7, 0, 1), (0, False, 8, 2, 3),
               (0, True, 7, 4, 5)], [1]),
    "future": ([(0, True, 7, 0, 1), (0, False, 7, 2, 3)], [1]),
    "initial_after_write": ([(0, False, 7, 0, 1), (0, True, 0, 2, 3)], [1]),
    "initial_before_write": ([(0, False, 7, 2, 3), (0, True, 0, 0, 1)], [0]),
    # more of the same register condition
    "unsourced": ([(0, False, 7, 0, 1), (0, True, 9, 2, 3)], [1]),
    "overlapping_ok": ([(0, False, 7, 0, 10), (0, True, 7, 1, 2)], [0]),
    "other_key_no_stale": ([(0, False, 7, 0, 1), (1, False, 8, 2, 3),
                            (0, True, 7, 4, 5)], [0]),
    # a read matching two writes is sourced by the first in op order
    "tie_earlier_write_first": ([(0, False, 7, 0, 1), (0, False, 7, 5, 6),
                                 (0, True, 7, 2, 3)], [0]),
    "tie_later_write_first": ([(0, False, 7, 5, 6), (0, False, 7, 0, 1),
                               (0, True, 7, 2, 3)], [1]),
    "all_reads": ([(0, True, 0, 0, 1), (1, True, 0, 0, 1),
                   (0, True, 3, 2, 3)], [1]),
}


@pytest.mark.parametrize("case", sorted(HISTORY_CASES))
def test_history_cases_equal_reference(case):
    rows, want = HISTORY_CASES[case]
    assert _check(_arrays(rows)) == want


def test_batch_and_padding_equal_reference():
    valid = np.array([[True, True, False], [True, True, True]])
    key = np.zeros((2, 3), np.int32)
    is_read = np.array([[False, True, False], [False, False, True]])
    val = np.array([[5, 5, 9], [5, 6, 5]], np.int32)
    start = np.array([[0, 2, 9], [0, 2, 4]], np.float64)
    end = np.array([[1, 3, 9], [1, 3, 5]], np.float64)
    planes = (valid, key, is_read, val, start, end)
    assert _check(planes) == [0, 1]
    # torch inputs give the same counts
    got = stale_read_anomalies(*(torch.as_tensor(p) for p in planes),
                               device="cpu")
    assert got.tolist() == [0, 1]


def _random_planes(seed, B, N, n_keys, n_vals, clock):
    rng = np.random.default_rng(seed)
    valid = rng.random((B, N)) < 0.9
    key = rng.integers(0, n_keys, (B, N)).astype(np.int32)
    is_read = rng.random((B, N)) < 0.5
    val = rng.integers(0, n_vals, (B, N)).astype(np.int32)
    start = rng.integers(0, 40, (B, N))
    end = start + rng.integers(0, 6, (B, N))
    if clock == "float":
        start = start.astype(np.float64) + rng.random((B, N))
        end = end.astype(np.float64) + 1.5
    else:
        start, end = start.astype(np.int32), end.astype(np.int32)
    return valid, key, is_read, val, start, end


RANDOM = {
    "int_clock_ties": (0, 64, 16, 2, 3, "int"),
    "float_clock": (1, 64, 16, 3, 6, "float"),
    "one_key_many_vals": (2, 32, 24, 1, 12, "int"),
    "wide": (3, 8, 64, 4, 5, "float"),
    "one_op": (4, 16, 1, 1, 2, "int"),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_batches_equal_reference(case):
    counts = _check(_random_planes(*RANDOM[case]))
    assert len(counts) == RANDOM[case][1]


def test_chunked_batch_equals_reference():
    """A batch larger than one chunk (max_elems / N^2 groups a chunk)."""
    planes = _random_planes(5, 300, 16, 3, 4, "int")
    want = _check(planes)
    assert _check(planes, max_elems=16 * 16 * 7) == want
    assert sum(want) > 0


# ---- utils/graph -----------------------------------------------------------
def _graph_story(mod, edges, extra_nodes=(), removed=()):
    g = mod.Graph()
    for u in extra_nodes:
        g.add_node(u)
    for u, v in edges:
        g.add_edge(u, v)
    for u in removed:
        g.remove(u)
    nodes = g.nodes()
    return (nodes, len(g), [sorted(g.neighbors(u), key=repr) for u in nodes],
            [g.bfs(u) for u in nodes], g.scc(), [u in g for u in range(-1, 9)])


GRAPH_CASES = {
    "bfs": ([(1, 2), (1, 3), (2, 4)], (), ()),
    "scc_reverse_topological": ([(1, 2), (2, 1), (2, 3), (3, 4), (4, 5),
                                 (5, 4)], (), ()),
    "self_loop_and_isolated": ([("b", "b")], ("a",), ()),
    "remove": ([(1, 2), (2, 3)], (), (2,)),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_cases_equal_reference(case):
    args = GRAPH_CASES[case]
    assert _graph_story(port_graph, *args) == _graph_story(ref_graph, *args)


@pytest.mark.parametrize("seed", range(3))
def test_random_graphs_equal_reference(seed):
    rnd = random.Random(seed)
    n = rnd.randint(5, 40)
    edges = [(rnd.randrange(n), rnd.randrange(n))
             for _ in range(rnd.randint(0, 3 * n))]
    removed = rnd.sample(range(n), rnd.randint(0, 3))
    got = _graph_story(port_graph, edges, range(n), removed)
    assert got == _graph_story(ref_graph, edges, range(n), removed)
    assert sorted(u for c in got[4] for u in c) == sorted(got[0])


def _queue_story(mod, ops):
    q, out = mod.PriorityQueue(), []
    for op, prio, item in ops:
        if op == "push":
            q.push(prio, item)
            continue
        try:
            out.append(q.pop() if op == "pop" else q.peek())
        except IndexError as e:
            out.append(("IndexError", str(e)))
        out.append((len(q), bool(q)))
    return out


@pytest.mark.parametrize("seed", range(2))
def test_priority_queue_equals_reference(seed):
    rnd = random.Random(seed)
    ops = [(rnd.choice(("push", "push", "pop", "peek")), rnd.randint(0, 4),
            f"i{k}") for k in range(60)] + [("pop", 0, "")] * 40
    got = _queue_story(port_graph, ops)
    assert got == _queue_story(ref_graph, ops)
    assert ("IndexError", "pop from empty PriorityQueue") in got
