"""The exchange kernels' launch layout (paxi_tpu_torch/ops/exchange.py) on
the CPU, and the whole-step exchange at the epaxos and 9-replica wpaxos
mailboxes.

- The pure-Python table: units, each type's first block, the launches a
  step's types are cut into, the vector-or-scalar decision for a
  transposed, a sliced and a broadcast plane and for a ragged G.
- The tables ``deliver_plan``/``insert_plan`` build from CPU tensors, run
  through a model of ``csrc/exchange.cu`` that reads and writes memory
  through the table's own pointers and strides (and asserts that every
  vector access is aligned): equal to the plain versions, with outboxes of
  ``ring.dst_major`` views, stride-0 broadcast fields and misaligned
  slices, at G = 13 (the scalar path) and 16.
- The CPU path of ``ops.wheel_deliver``/``wheel_insert`` against JAX's
  Pallas pair in interpret mode and the dense ``paxi_tpu/sim/mailbox.py``
  pair: epaxos (11 types) at wheel depth 1 and 3 and wpaxos at 9 replicas
  at depth 6, the outboxes as views.
"""

import ctypes

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.ops import exchange as jx  # noqa: E402
from paxi_tpu.sim import mailbox as jmb  # noqa: E402
from paxi_tpu.sim.types import FuzzConfig as JFuzz  # noqa: E402

from _torch_parity import assert_tree_equal, to_torch  # noqa: E402
from paxi_tpu_torch.ops import exchange as px  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import mailbox as pmb  # noqa: E402
from paxi_tpu_torch.sim.types import SimConfig  # noqa: E402

WPAXOS9 = dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
               steal_threshold=3, locality=0.8)
# (protocol, config, wheel depth): the main paths' whole-step shapes, small G
CASES = {"paxos_d3": ("paxos", dict(n_replicas=5), 3),
         "epaxos_d1": ("epaxos", dict(n_replicas=5, n_slots=16, n_keys=4), 1),
         "epaxos_d3": ("epaxos", dict(n_replicas=5, n_slots=16, n_keys=4), 3),
         "wpaxos9_d6": ("wpaxos", WPAXOS9, 6)}
# how each outbox field lies, by its index: as it is, transposed
# (ring.dst_major of a contiguous plane), broadcast over dst (stride 0),
# and sliced out of a wider plane one group in (misaligned)
FIELD_VIEWS = ("contiguous", "dst_major", "broadcast", "sliced")


def _spec(case):
    name, cfg, d = CASES[case]
    cfg = SimConfig(**cfg)
    return sim_protocol(name).mailbox_spec(cfg), cfg.n_replicas, d


def _inputs(spec, r, g, d, seed):
    """Numpy wheel, outbox, fault state and fault planes; a field whose
    view is ``broadcast`` holds values constant over dst."""
    rng = np.random.default_rng(seed)

    def box(shape, lead):
        out = {"valid": rng.random(lead + shape) < 0.5}
        for i, f in enumerate(spec_fields):
            x = rng.integers(-1000, 1000, lead + shape).astype(np.int32)
            if not lead and FIELD_VIEWS[i % 4] == "broadcast":
                x[:] = x[:, :1, :]
            out[f] = x
        return out

    wheel, outbox = {}, {}
    for name, spec_fields in spec.items():
        wheel[name] = box((r, r, g), (d,))
        outbox[name] = box((r, r, g), ())
    fs = {"conn": rng.random((r, r, g)) < 0.8,
          "crashed": rng.random((r, g)) < 0.2}
    faults = {name: {"drop": rng.random((r, r, g)) < 0.2,
                     "delay": rng.integers(1, d + 1, (r, r, g))
                     .astype(np.int32),
                     "dup": rng.random((r, r, g)) < 0.3}
              for name in spec}
    return wheel, outbox, fs, faults


def _view(x: np.ndarray, how: str) -> torch.Tensor:
    """The plane ``x`` as a tensor that lies ``how``, equal in value."""
    if how == "dst_major":
        return torch.from_numpy(
            np.ascontiguousarray(x.transpose(1, 0, 2))).transpose(0, 1)
    if how == "broadcast":
        return torch.from_numpy(x[:, :1, :].copy()).expand(x.shape)
    if how == "sliced":
        wide = np.zeros(x.shape[:-1] + (x.shape[-1] + 1,), x.dtype)
        wide[..., 1:] = x
        return torch.from_numpy(wide)[..., 1:]
    return torch.from_numpy(x.copy())


def _port_outbox(outbox, spec):
    out = {}
    for j, (name, box) in enumerate(outbox.items()):
        out[name] = {"valid": _view(box["valid"],
                                    ("dst_major", "sliced")[j % 2])}
        for i, f in enumerate(spec[name]):
            out[name][f] = _view(box[f], FIELD_VIEWS[i % 4])
    return out


def _port_wheel(wheel, spec):
    return {name: pmb.WheelBox(spec[name],
                               pmb.stack_box(to_torch(box), spec[name]))
            for name, box in wheel.items()}


def _port_inputs(case, g, seed):
    spec, r, d = _spec(case)
    wheel, outbox, fs, faults = _inputs(spec, r, g, d, seed)
    return (spec, r, d, (wheel, outbox, fs, faults),
            (_port_wheel(wheel, spec), _port_outbox(outbox, spec),
             to_torch(fs), to_torch(faults)))


# ---- the pure-Python table ------------------------------------------------

def test_units_blocks_and_ragged_groups():
    # 3 replicas, G = 13: rows of 4 runs (4 + 4 + 4 + 1 groups)
    assert px.insert_units(3, 13) == 9 * 4
    assert px.insert_units(5, 100_000) == 25 * 25_000
    # a deliver plane of E = 117 elements: 30 runs, the last of 1
    assert px.deliver_units(6, 117) == 6 * 30
    # every type starts a block: 36 units take a whole block of 256
    assert px.block_table([36, 36, 300]) == (0, 1, 2, 4)
    assert px.block_table([256, 257, 0, 1]) == (0, 1, 3, 3, 4)
    assert px.block_table([]) == (0,)


def test_launch_groups():
    spec, _, _ = _spec("epaxos_d1")
    planes = [1 + len(f) for f in spec.values()]
    assert sum(planes) == 89
    assert px.launch_groups(planes) == [list(range(11))]     # one launch
    assert px.launch_groups([2] * 17) == [list(range(16)), [16]]
    assert px.launch_groups([100, 20, 20]) == [[0, 1], [2]]
    assert px.launch_groups([]) == []
    with pytest.raises(ValueError):
        px.launch_groups([px.MAX_PLANES + 1])


def test_vector_decision():
    base = torch.zeros((5, 5, 16), dtype=torch.int32)
    assert px.plane_vector(base)
    assert px.plane_vector(base.transpose(0, 1))              # dst_major
    assert px.plane_vector(base[:, :1].expand(5, 5, 16))      # stride 0
    assert px.plane_vector(base[1:3])                         # whole rows
    wide = torch.zeros((5, 5, 17), dtype=torch.int32)
    assert not px.plane_vector(wide[..., 1:])                 # sliced
    assert not px.plane_vector(torch.zeros((5, 5, 13), dtype=torch.int32))
    flat = torch.zeros(5 * 5 * 16 + 1, dtype=torch.int32)
    assert not px.plane_vector(flat[1:].view(5, 5, 16))       # odd offset
    # bool planes move 4 lanes as one 4-byte word
    b = torch.zeros((5, 5, 16), dtype=torch.bool)
    assert px.plane_vector(b.transpose(0, 1))
    assert not px.plane_vector(torch.zeros((5, 5, 18),
                                           dtype=torch.bool)[..., 2:])
    assert px.vector_ok(64, 4, (16, 80), 16)
    assert not px.vector_ok(68, 4, (16, 80), 16)
    assert px.vector_ok(68, 1, (16, 80), 16)
    assert not px.vector_ok(64, 4, (18, 80), 16)


def test_plan_words():
    spec, r, d, _, (wheel, outbox, fs, faults) = _port_inputs("epaxos_d3",
                                                              16, 0)
    plans, outputs = px.deliver_plan(wheel)
    inbox, rolled = outputs()
    assert len(plans) == 1 and plans[0].n == 11
    words = list(plans[0].words)
    assert len(words) == 9 * 11 + 1
    units = [px.deliver_units(1 + len(spec[n]), r * r * 16) for n in spec]
    block0 = px.block_table(units)
    for i, name in enumerate(spec):
        seg = words[9 * i:9 * i + 9]
        assert seg[0] == wheel[name].planes.data_ptr()
        assert seg[1] == inbox[name]["valid"].data_ptr()
        assert seg[3] == rolled[name].planes.data_ptr()
        assert seg[4:8] == [r * r * 16, d, 1 + len(spec[name]), 1]
        assert seg[8] == block0[i]
    assert words[-1] == block0[-1]

    plans, outputs = px.insert_plan(wheel, outbox, fs, faults)
    new = outputs()
    assert len(plans) == 1 and plans[0].n == 11
    words = list(plans[0].words)
    assert words[:4] == [fs["conn"].data_ptr(), fs["crashed"].data_ptr(),
                         r, 16]
    names = sorted(outbox)
    segs = words[4:4 + 9 * 11]
    planes = words[4 + 9 * 11 + 1:]
    assert len(planes) == 4 * 89
    at = 0
    for i, name in enumerate(names):
        seg = segs[9 * i:9 * i + 9]
        assert seg[:2] == [wheel[name].planes.data_ptr(),
                           new[name].planes.data_ptr()]
        assert seg[5:8] == [d, 1 + len(spec[name]), 1]
        assert seg[8] == i * -(-px.insert_units(r, 16) // px.BLOCK_UNITS)
        sends = [outbox[name]["valid"]] + [outbox[name][f]
                                          for f in spec[name]]
        for x in sends:
            p = planes[4 * at:4 * at + 4]
            assert p == [x.data_ptr(), x.stride(0), x.stride(1),
                         int(px.plane_vector(x))]
            at += 1
    # the transposed, broadcast and sliced views, as they lie
    pa = outbox["pa"]
    assert pa["inst"].stride() == (r * 16, 16, 1)
    assert pa["seq"].stride() == (16, r * 16, 1)
    assert pa["d0"].stride() == (16, 0, 1)
    assert pa["d1"].stride() == (r * 17, 17, 1)
    assert [px.plane_vector(pa[f]) for f in ("inst", "seq", "d0", "d1")] \
        == [True, True, True, False]


def test_plan_rejects_bad_planes():
    _, _, _, _, (wheel, outbox, fs, faults) = _port_inputs("paxos_d3", 16, 1)
    box = dict(outbox["p2a"])
    box["bal"] = torch.zeros((16, 5, 5), dtype=torch.int32).permute(1, 2, 0)
    with pytest.raises(ValueError, match="group stride"):
        px.insert_plan(wheel, dict(outbox, p2a=box), fs, faults)
    box["bal"] = outbox["p2a"]["bal"].to(torch.int64)
    with pytest.raises(TypeError):
        px.insert_plan(wheel, dict(outbox, p2a=box), fs, faults)
    bad = dict(faults, p2a=dict(faults["p2a"],
                                delay=faults["p2a"]["delay"].transpose(0, 1)))
    with pytest.raises(ValueError, match="contiguous"):
        px.insert_plan(wheel, outbox, fs, bad)
    w = wheel["p2a"]
    with pytest.raises(TypeError):
        px.deliver_plan({"p2a": pmb.WheelBox(w.fields,
                                             w.planes.to(torch.int64))})


# ---- a model of csrc/exchange.cu over the plans' tables --------------------

def _mem(addr: int, dtype, n: int, vec: bool) -> np.ndarray:
    """``n`` elements of ``dtype`` at host address ``addr``, writable; a
    vector access must be a whole aligned 4-lane word."""
    ct = {np.int32: ctypes.c_int32, np.uint8: ctypes.c_uint8}[dtype]
    if vec:
        assert n == 4 and addr % (4 * ctypes.sizeof(ct)) == 0, (addr, n)
    return np.ctypeslib.as_array((ct * n).from_address(addr))


def _segment_of(block0, n, blk):
    return max(i for i in range(n) if block0[i] <= blk)


def _model_deliver(plan):
    w = list(plan.words)
    segs = [w[9 * i:9 * i + 9] for i in range(plan.n)]
    for blk in range(w[9 * plan.n]):
        si = _segment_of([s[8] for s in segs], plan.n, blk)
        wheel, valid, fields, rolled, E, d, F, vec, b0 = segs[si]
        U = -(-E // 4)
        slot = F * E
        for t in range(px.BLOCK_UNITS):
            k = (blk - b0) * px.BLOCK_UNITS + t
            if k >= F * U:
                break
            p, e = k // U, (k % U) * 4
            n = min(4, E - e)
            at = p * E + e
            for s in range(d):
                v = _mem(wheel + 4 * (s * slot + at), np.int32, n, vec)
                if s > 0:
                    _mem(rolled + 4 * ((s - 1) * slot + at), np.int32, n,
                         vec)[:] = v
                elif p > 0:
                    _mem(fields + 4 * ((p - 1) * E + e), np.int32, n,
                         vec)[:] = v
                else:
                    _mem(valid + e, np.uint8, n, vec)[:] = v != 0
            _mem(rolled + 4 * ((d - 1) * slot + at), np.int32, n, vec)[:] = 0


def _model_insert(plan):
    w = list(plan.words)
    conn, crashed, R, G = w[:4]
    segs = [w[4 + 9 * i:13 + 9 * i] for i in range(plan.n)]
    grid = w[4 + 9 * plan.n]
    pw = w[5 + 9 * plan.n:]
    planes = [pw[4 * i:4 * i + 4] for i in range(len(pw) // 4)]
    plane0 = np.cumsum([0] + [s[6] for s in segs]).tolist()
    G4 = -(-G // 4)
    E = R * R * G
    for blk in range(grid):
        si = _segment_of([s[8] for s in segs], plan.n, blk)
        wheel, out, drop, delay, dup, d, F, vec, b0 = segs[si]
        slot = F * E
        for t in range(px.BLOCK_UNITS):
            k = (blk - b0) * px.BLOCK_UNITS + t
            if k >= R * R * G4:
                break
            row, g = k // G4, (k % G4) * 4
            src, dst = divmod(row, R)
            n = min(4, G - g)
            e = row * G + g

            def send(i, dtype, size):
                ptr, ss, sd, pvec = planes[plane0[si] + i]
                return _mem(ptr + size * (src * ss + dst * sd + g), dtype,
                            n, vec and pvec)

            eff = ((send(0, np.uint8, 1) != 0)
                   & (_mem(conn + e, np.uint8, n, vec) != 0)
                   & (_mem(drop + e, np.uint8, n, vec) == 0)
                   & (_mem(crashed + src * G + g, np.uint8, n, vec) == 0)
                   & (_mem(crashed + dst * G + g, np.uint8, n, vec) == 0)
                   & (src != dst))
            dl = _mem(delay + 4 * e, np.int32, n, vec).astype(np.int64)
            du = _mem(dup + e, np.uint8, n, vec) != 0
            for f in range(F):
                o = send(f, np.int32, 4) if f else None
                for s in range(d):
                    put = eff & ((dl == s + 1)
                                 | (du & (np.minimum(dl + 1, d) == s + 1)))
                    at = s * slot + f * E + e
                    old = _mem(wheel + 4 * at, np.int32, n, vec)
                    new = ((old != 0) | put).astype(np.int32) if f == 0 \
                        else np.where(put, o, old)
                    _mem(out + 4 * at, np.int32, n, vec)[:] = new


@pytest.mark.parametrize("g", [13, 16])
@pytest.mark.parametrize("case", ["epaxos_d3", "wpaxos9_d6", "paxos_d3"])
def test_model_of_the_tables_equals_plain(case, g):
    """The tables drive a model of the kernels to the plain versions'
    outputs: every pointer, stride, unit and block is where the kernels
    look for it, and every vector access is aligned."""
    *_, (wheel, outbox, fs, faults) = _port_inputs(case, g, 2)
    plans, outputs = px.deliver_plan(wheel)
    for p in plans:
        _model_deliver(p)
    inbox, rolled = outputs()
    want_inbox, want_rolled = pmb.wheel_deliver(wheel)
    assert_tree_equal(want_inbox, inbox, "inbox")
    assert_tree_equal({k: b.planes for k, b in want_rolled.items()},
                      {k: b.planes for k, b in rolled.items()}, "rolled")
    plans, outputs = px.insert_plan(wheel, outbox, fs, faults)
    for p in plans:
        _model_insert(p)
    new = outputs()
    want = pmb.wheel_insert(wheel, outbox, fs, faults)
    assert_tree_equal({k: b.planes for k, b in want.items()},
                      {k: b.planes for k, b in new.items()}, "wheel")


# ---- the CPU path against JAX's pair ---------------------------------------

def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("case", ["epaxos_d1", "epaxos_d3", "wpaxos9_d6"])
def test_whole_step_matches_pallas_and_dense(case):
    spec, r, d, (wheel, outbox, fs, faults), port = _port_inputs(case, 8, 3)
    pw, pob, pfs, pfaults = port
    inbox, rolled = px.wheel_deliver(pw)
    got = (inbox, {n: pmb.unstack_box(b.planes, b.fields)
                   for n, b in rolled.items()})
    assert_tree_equal(jx.wheel_deliver(_jax(wheel)), got, "pallas deliver")
    assert_tree_equal(jmb.wheel_deliver(_jax(wheel)), got, "dense deliver")
    new = px.wheel_insert(pw, pob, pfs, pfaults)
    got = {n: pmb.unstack_box(b.planes, b.fields) for n, b in new.items()}
    args = (_jax(wheel), _jax(outbox), _jax(fs), JFuzz(max_delay=d),
            _jax(faults))
    assert_tree_equal(jx.wheel_insert(*args), got, "pallas insert")
    assert_tree_equal(jmb.wheel_insert(*args), got, "dense insert")


# ---- a real step's outbox of each protocol ported in slices 8 and 9 --------

SLICE8 = {
    "wankeeper": dict(n_replicas=6, n_zones=2, n_objects=4, n_slots=16,
                      locality=0.8),
    "wankeeper_nofloor": dict(n_replicas=6, n_zones=2, n_objects=2,
                              n_slots=16, locality=0.1),
    "bpaxos": dict(n_replicas=7, n_slots=16),
    "bpaxos_noread": dict(n_replicas=7, n_slots=16),
    "chain": dict(n_replicas=3, n_slots=32),
    "kpaxos": dict(n_replicas=3, n_slots=32),
    "abd": dict(n_replicas=5, n_keys=16),
    "dynamo": dict(n_replicas=5, n_keys=8, n_slots=40),
    "blockchain": dict(n_replicas=5, n_slots=32, steal_threshold=4),
    # slice 9: six types, the p2a/p3 stamps and gapreq's ``n`` expanded
    # over dst, nogap's all-zero gapreq; seqchurn's down windows
    "switchpaxos": dict(n_replicas=5, n_slots=32, sw_down_start=2,
                        sw_down_period=6, sw_down_for=2),
    "switchpaxos_nogap": dict(n_replicas=5, n_slots=32),
}


@pytest.mark.parametrize("g", [13, 16])
@pytest.mark.parametrize("name", SLICE8)
def test_real_outbox_goes_through_the_tables(name, g):
    """Step 6 of a run under drops and a two-slot wheel, as the runner
    hands it to the exchange (``mailbox.full_edges`` after the fault
    draws): every outbox plane is taken where it lies (the insert plan
    raises on a group stride other than 1), and the model of the kernels
    over the plans equals ``mailbox.wheel_deliver``/``wheel_insert``."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig, runner
    from paxi_tpu_torch.sim.types import StepCtx
    proto, cfg = sim_protocol(name), SimConfig(**SLICE8[name])
    fuzz = FuzzConfig(p_drop=0.2, max_delay=2)
    body = runner.make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = runner.init_carry(proto, cfg, fuzz, g, tr.PRNGKey(1), "cpu")
        for t in range(6):
            carry, _ = body(carry, t)
        state, wheel, fs, rng = carry
        _, k_step, _, k_ins = tr.split(rng, 4)
        inbox, rolled = pmb.wheel_deliver(wheel)
        _, outbox = proto.step(state, inbox, StepCtx(k_step, 6, cfg))
        faults = pmb.draw_edge_faults(k_ins, outbox, fuzz)
        outbox, faults = pmb.full_edges(outbox, faults, g)
    for box in outbox.values():
        for x in box.values():
            assert x.shape[-1] == g and x.stride()[-1] == 1
    plans, outputs = px.deliver_plan(wheel)
    for p in plans:
        _model_deliver(p)
    got_inbox, _ = outputs()
    assert_tree_equal(inbox, got_inbox, "inbox")
    plans, outputs = px.insert_plan(rolled, outbox, fs, faults)
    assert len(plans) == 1
    for p in plans:
        _model_insert(p)
    want = pmb.wheel_insert(rolled, outbox, fs, faults)
    assert_tree_equal({k: b.planes for k, b in want.items()},
                      {k: b.planes for k, b in outputs().items()}, "wheel")
