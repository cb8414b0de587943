"""The lane-major message-exchange kernels and the ring shift between
ranks (CUDA for Hopper).

``wheel_deliver`` and ``wheel_insert`` replace the JAX package's Pallas
pair in ``paxi_tpu/ops/exchange.py`` and have the signatures of the plain
exchange in ``sim/mailbox.py``.  On the card each half of a step is one
kernel launch over every message type (``csrc/exchange.cu``): a segment
table gives each type's wheel block, outputs and, for the insert, its
fault planes and the outbox planes where they lie (their own pointers and
src/dst strides); the insert forms the effective-send mask itself.

``make_remote_lane_shift(mesh)`` replaces the reference's function of the
same name: ``shift(x)`` moves every rank's whole shard to its right-hand
neighbour, and ``shift.many(xs)`` every plane of a state at once: one copy
launch at world 1, and over ranks a copy kernel a side that stores
straight into the neighbour's memory through CUDA IPC
(``csrc/lane_shift.cu``).  No run path calls it,
as in the reference; it is the staged group-migration primitive.

Dispatch is by the tensors' device and nothing else: on CPU tensors each
runs its plain version (``mailbox.wheel_deliver`` / ``wheel_insert`` /
``lane_shift_plain``); on CUDA tensors it launches the kernel or raises.
Each wrapper counts its kernel launches in a plain integer attribute
(``wheel_deliver.launches``, ``wheel_insert.launches``,
``make_remote_lane_shift.launches``) so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from paxi_tpu_torch.collectives import all_gather
from paxi_tpu_torch.ops import _build
from paxi_tpu_torch.sim import mailbox as mb

_LIB = "exchange"
MAX_TYPES = 16           # message types a launch takes (csrc kMaxSegments)
MAX_PLANES = 128         # outbox planes an insert launch takes (kMaxPlanes)
BLOCK_UNITS = 256        # units a block (csrc kThreads)
LANES = 4                # groups (deliver: elements) a unit moves
OUT_ALIGN = 256          # byte offset of each output in a launch's buffer
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built and
    loaded on the first launch)."""
    lib = _build.load(_LIB)
    args = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
    for fn in ("paxi_exchange_deliver", "paxi_exchange_insert"):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# ---- the launch layout (pure Python) ------------------------------------

def deliver_units(n_planes: int, edge: int) -> int:
    """A deliver segment's units: each plane of ``edge`` elements in runs
    of ``LANES`` (the last one short when ``edge % LANES``)."""
    return n_planes * -(-edge // LANES)


def insert_units(n: int, groups: int) -> int:
    """An insert segment's units: each ``(src, dst)`` row of ``groups``
    cells in runs of ``LANES`` consecutive groups."""
    return n * n * -(-groups // LANES)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // OUT_ALIGN) * OUT_ALIGN


def block_table(units: Sequence[int]) -> Tuple[int, ...]:
    """Each segment's first block when every segment starts a new block
    of ``BLOCK_UNITS`` units; the last entry is the grid."""
    out, at = [0], 0
    for u in units:
        at += -(-u // BLOCK_UNITS)
        out.append(at)
    return tuple(out)


def launch_groups(n_planes: Sequence[int]) -> List[List[int]]:
    """The segments (message types, in order) cut into launches of at
    most ``MAX_TYPES`` types and ``MAX_PLANES`` planes each."""
    groups, planes = [[]], 0
    for i, p in enumerate(n_planes):
        if p > MAX_PLANES:
            raise ValueError(f"a message type of {p} planes exceeds the "
                             f"{MAX_PLANES} a launch takes")
        if len(groups[-1]) == MAX_TYPES or planes + p > MAX_PLANES:
            groups.append([])
            planes = 0
        groups[-1].append(i)
        planes += p
    return [g for g in groups if g]


def vector_ok(ptr: int, itemsize: int, strides: Sequence[int],
              groups: int) -> bool:
    """Whether every 4-group unit of a ``(..., G)`` plane at ``ptr`` with
    the leading ``strides`` (elements) is one aligned word of ``LANES *
    itemsize`` bytes (the kernel's vector path); else the scalar path."""
    return (groups % LANES == 0 and ptr % (LANES * itemsize) == 0
            and all(s % LANES == 0 for s in strides))


def plane_vector(x: torch.Tensor) -> bool:
    """``vector_ok`` of an outbox plane ``(src, dst, G)`` as it lies."""
    return vector_ok(x.data_ptr(), x.element_size(), x.stride()[:-1],
                     x.shape[-1])


# ---- argument checks ------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device,
           contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    """The address of a contiguous plane, checked (``_check`` raises)."""
    if (t.dtype is not dtype or t.device != device or t.shape != shape
            or not t.is_contiguous()):
        _check(t, name, dtype, shape, device)
    return t.data_ptr()


def _send(x: torch.Tensor, name: str, dtype, shape, device) -> List[int]:
    """An outbox plane's table words ``[ptr, src stride, dst stride,
    vector]``: it is read where it lies, at any src/dst strides below 2**31
    and the group axis of stride 1."""
    st = x.stride()
    if x.dtype is not dtype or x.device != device or x.shape != shape:
        _check(x, name, dtype, shape, device, contiguous=False)
    if st[2] != 1 and shape[2] > 1:
        raise ValueError(f"{name} has group stride {st[2]}: the exchange "
                         "kernel reads groups at stride 1")
    if max(st) > _INT32_MAX:
        raise ValueError(f"{name} has a stride of 2**31 or more")
    ptr = x.data_ptr()
    return [ptr, st[0], st[1],
            int(vector_ok(ptr, x.element_size(), st[:2], shape[2]))]


def _check_wheel(w: torch.Tensor, name: str, device) -> None:
    if w.dim() != 5 or w.shape[0] < 1:
        raise ValueError(f"wheel block {name} must be (d, F, R, R, G), got "
                         f"{tuple(w.shape)}")
    if (w.dtype is not torch.int32 or w.device != device
            or not w.is_contiguous()):
        _check(w, f"wheel {name}", torch.int32, w.shape, device)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# ---- the launches -----------------------------------------------------------

class Plan(NamedTuple):
    """One prepared kernel launch: the C entry point, the number of
    message types, the table words and the stream."""
    fn: str
    n: int
    words: ctypes.Array
    stream: int


def launch(plans: Sequence[Plan]) -> None:
    """Launch prepared kernels; each launch adds one to its wrapper's
    count (``wheel_deliver.launches`` / ``wheel_insert.launches``)."""
    lib = _lib()
    for p in plans:
        half = wheel_deliver if p.fn == "paxi_exchange_deliver" \
            else wheel_insert
        _raise_on(getattr(lib, p.fn)(p.n, p.words, p.stream), half.__name__)
        half.launches += 1


def _plan(fn: str, n: int, words: List[int], device) -> Plan:
    """A launch's plan on the current stream of ``device`` (a plan of CPU
    tensors, stream 0, only shows the layout: ``launch`` never gets one)."""
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else 0)
    return Plan(fn, n, (ctypes.c_int64 * len(words))(*words), stream)


def deliver_plan(wheel: mb.Wheel):
    """``wheel_deliver`` on the card, prepared: ``(plans, outputs)``.
    ``launch(plans)`` writes the step's outputs into two fresh
    allocations: every type's inbox ``valid`` in one bool block ``(n, R,
    R, G)``, and one int32 buffer holding every type's inbox fields as
    one block ``(sum(F - 1), R, R, G)``, then each rolled wheel at an
    ``OUT_ALIGN``-byte offset.  ``outputs()`` returns them as ``(inbox,
    rolled)``, views made after the launch while the kernel runs."""
    name0, box0 = next(iter(wheel.items()))
    device = box0.planes.device
    _check_wheel(box0.planes, name0, device)
    edge = box0.planes.shape[2:]
    R, _, G = edge
    E = R * R * G
    n_fields = sum(len(box.fields) for box in wheel.values())
    segs, views = [], []
    at_f, at = 0, _aligned(n_fields * E * 4) // 4   # fields, rolled wheels
    for j, (name, box) in enumerate(wheel.items()):
        w = box.planes
        _check_wheel(w, name, device)
        d, F = w.shape[:2]
        if w.shape[2:] != edge or F != 1 + len(box.fields):
            raise ValueError(f"wheel block {name} has shape "
                             f"{tuple(w.shape)} for {len(box.fields)} "
                             f"fields on {tuple(edge)} edges")
        if deliver_units(F, E) > _INT32_MAX:
            raise ValueError(f"wheel block {name} is too large a launch")
        ptr = w.data_ptr()
        segs.append([ptr, j * E, at_f, at, d, F,
                     int(vector_ok(ptr, 4, (), E)), deliver_units(F, E)])
        views.append((name, box.fields, at, w.shape, w.stride()))
        at_f += (F - 1) * E
        at += _aligned(d * F * E * 4) // 4
    buf8 = torch.empty((len(segs), R, R, G), dtype=torch.bool, device=device)
    buf32 = torch.empty(max(at, 1), dtype=torch.int32, device=device)
    b8, b32 = buf8.data_ptr(), buf32.data_ptr()
    plans = []
    for group in launch_groups([0] * len(segs)):
        block0 = block_table([segs[i][-1] for i in group])
        words = []
        for j, i in enumerate(group):
            ptr, o_valid, o_fields, o_rolled, d, F, vec, _ = segs[i]
            words += [ptr, b8 + o_valid, b32 + 4 * o_fields,
                      b32 + 4 * o_rolled, E, d, F,
                      int(vec and b8 % 4 == 0 and b32 % 16 == 0), block0[j]]
        plans.append(_plan("paxi_exchange_deliver", len(group),
                           words + [block0[-1]], device))

    def outputs():
        valid = buf8.unbind(0)
        fields = iter(buf32[:n_fields * E].view(n_fields, R, R, G)
                      .unbind(0))
        inbox, rolled = {}, {}
        for (name, names, off, shape, stride), v in zip(views, valid):
            inbox[name] = {"valid": v, **{f: next(fields) for f in names}}
            rolled[name] = mb.WheelBox(names,
                                       buf32.as_strided(shape, stride, off))
        return inbox, rolled

    return plans, outputs


def insert_plan(wheel: mb.Wheel, outbox, fs, faults):
    """``wheel_insert`` on the card, prepared: ``(plans, outputs)``.
    ``launch(plans)`` writes every type's new wheel into one fresh int32
    allocation; ``outputs()`` returns the new wheel, views made after the
    launch."""
    device = wheel[min(outbox.keys())].planes.device
    conn = fs["conn"]
    R, G = conn.shape[0], conn.shape[-1]
    edge = torch.Size((R, R, G))
    words0 = [_ptr(conn, "conn", torch.bool, edge, device),
              _ptr(fs["crashed"], "crashed", torch.bool, torch.Size((R, G)),
                   device), R, G]
    shared_vec = all(vector_ok(p, 1, (), G) for p in words0[:2])
    segs, planes, views, at = [], [], [], 0
    for name in sorted(outbox.keys()):
        box, wbox, f = outbox[name], wheel[name], faults[name]
        w = wbox.planes
        _check_wheel(w, name, device)
        d, F = w.shape[:2]
        if w.shape[2:] != edge or F != 1 + len(wbox.fields):
            raise ValueError(f"wheel block {name} has shape "
                             f"{tuple(w.shape)} for {len(wbox.fields)} "
                             f"fields on {tuple(edge)} edges")
        seg = [w.data_ptr(), at,
               _ptr(f["drop"], f"{name} drop", torch.bool, edge, device),
               _ptr(f["delay"], f"{name} delay", torch.int32, edge, device),
               _ptr(f["dup"], f"{name} dup", torch.bool, edge, device)]
        vec = shared_vec and all(vector_ok(seg[i], n, (), G) for i, n in
                                 ((0, 4), (2, 1), (3, 4), (4, 1)))
        segs.append(seg + [d, F, int(vec)])
        planes.append([_send(box["valid"], f"{name} valid", torch.bool,
                             edge, device)]
                      + [_send(box[k], f"{name} {k}", torch.int32, edge,
                               device) for k in wbox.fields])
        views.append((name, wbox.fields, at, w.shape, w.stride()))
        at += _aligned(w.numel() * 4) // 4
    if insert_units(R, G) > _INT32_MAX:
        raise ValueError(f"a mailbox of {R} x {R} x {G} edges is too large "
                         "a launch")
    buf = torch.empty(max(at, 1), dtype=torch.int32, device=device)
    base = buf.data_ptr()
    plans = []
    for group in launch_groups([len(p) for p in planes]):
        block0 = block_table([insert_units(R, G)] * len(group))
        words = list(words0)
        for j, i in enumerate(group):
            seg = list(segs[i])
            seg[1] = base + 4 * seg[1]
            seg[7] = int(seg[7] and base % 16 == 0)
            words += seg + [block0[j]]
        words.append(block0[-1])
        for i in group:
            for p in planes[i]:
                words += p
        plans.append(_plan("paxi_exchange_insert", len(group), words,
                           device))

    def outputs():
        return {name: mb.WheelBox(fields, buf.as_strided(shape, stride, off))
                for name, fields, off, shape, stride in views}

    return plans, outputs


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no exchange kernel for device {x.device}")
    return x.device.type


def wheel_deliver(wheel: mb.Wheel):
    """Pop slot 0 as this step's inbox; rotate the wheel forward (one
    kernel launch for every message type on the card, ``MAX_TYPES`` a
    launch)."""
    if not wheel or _device_of(next(iter(wheel.values())).planes) == "cpu":
        return mb.wheel_deliver(wheel)
    plans, outputs = deliver_plan(wheel)
    launch(plans)
    return outputs()


def wheel_insert(wheel: mb.Wheel, outbox, fs, faults) -> mb.Wheel:
    """Push this step's outbox into the wheel under the fault schedule
    (one kernel launch for every message type on the card, ``MAX_TYPES``
    types and ``MAX_PLANES`` outbox planes a launch)."""
    if not outbox or _device_of(wheel[min(outbox.keys())].planes) == "cpu":
        return mb.wheel_insert(wheel, outbox, fs, faults)
    plans, outputs = insert_plan(wheel, outbox, fs, faults)
    launch(plans)
    return outputs()


wheel_deliver.launches = 0
wheel_insert.launches = 0


# --------------------------------------------------------------------------
# the ring shift between ranks (make_remote_lane_shift)
# --------------------------------------------------------------------------

_SHIFT_LIB = "lane_shift"
_FLAG_BYTES = 256              # the five flag words, padded
SEGMENT_ALIGN = 256            # a plane's offset in the receive buffer
UNIT_BYTES = 16                # the kernel's copy unit
MAX_SEGMENTS = 64              # planes a launch takes (csrc kMaxSegments)
SHIFT_TIMEOUT_S = 60.0         # a wait longer than this is a broken ring


@functools.lru_cache(maxsize=None)
def _shift_lib() -> ctypes.CDLL:
    lib = _build.load(_SHIFT_LIB)
    p, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint32)
    pp = ctypes.POINTER(ctypes.c_void_p)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    for fn, args in (
            ("paxi_shift_alloc", [i32, i64, pp]),
            ("paxi_shift_free", [i32, p]),
            ("paxi_shift_handle", [i32, p, p]),
            ("paxi_shift_open", [i32, p, pp]),
            ("paxi_shift_close", [i32, p]),
            ("paxi_shift_host_word", [i32, pp, pp]),
            ("paxi_shift_free_host_word", [p]),
            ("paxi_lane_copy", [i32, i32, pp, pp, pi64, pi64, p]),
            ("paxi_lane_shift", [i32, i32, pp, pp, pi64, pi64, pi64, p, p,
                                 p, i64, u32, p, ctypes.c_uint64, p])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i32
    return lib


def _cuda_ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def lane_shift_plain(x: torch.Tensor, mesh) -> torch.Tensor:
    """The plain version: every rank's ``x`` gathered, then the left
    neighbour's (rank ``(r - 1) % world``) — the reference's stand-in, a
    roll over the gathered axis."""
    return all_gather(x.contiguous(), mesh)[(mesh.rank - 1) % mesh.world] \
        .clone()


def channel_key(xs) -> tuple:
    """A call's channel: the ``(shape, dtype)`` of every plane, in order."""
    return tuple((tuple(x.shape), x.dtype) for x in xs)


class ShiftLayout(NamedTuple):
    """Where a call's planes go: their bytes, their offsets in the receive
    buffer (each aligned to ``SEGMENT_ALIGN``), the flag words' offset after
    them, and each plane's first 16-byte copy unit in the numbering across
    the planes (``unit0[-1]`` is the total; a plane of ``b`` bytes has
    ``ceil(b / 16)`` units, the last one short by ``-b % 16`` bytes)."""
    nbytes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    flags_off: int
    unit0: Tuple[int, ...]


def shift_layout(key) -> ShiftLayout:
    """The layout of the planes of channel ``key`` (``channel_key``)."""
    nbytes = tuple(math.prod(shape) * torch.empty((), dtype=dtype)
                   .element_size() for shape, dtype in key)
    offsets, unit0, at, units = [], [0], 0, 0
    for b in nbytes:
        offsets.append(at)
        at += -(-b // SEGMENT_ALIGN) * SEGMENT_ALIGN
        units += -(-b // UNIT_BYTES)
        unit0.append(units)
    return ShiftLayout(nbytes, tuple(offsets), max(at, SEGMENT_ALIGN),
                       tuple(unit0))


@functools.lru_cache(maxsize=64)
def _layout_arrays(key):
    """``shift_layout(key)``'s bytes, offsets and first units as the C
    arrays a launch takes (kept per key: a call's host set-up delays its
    launch)."""
    lay = shift_layout(key)
    i64 = ctypes.c_int64
    return (lay, (i64 * len(lay.nbytes))(*lay.nbytes),
            (i64 * len(lay.offsets))(*lay.offsets),
            (i64 * len(lay.unit0))(*lay.unit0))


class ShiftChannel:
    """One channel's buffers on this rank, for a ring of two ranks or more:
    its receive block (every plane at its ``shift_layout`` offset, then the
    flag words), the neighbours' blocks mapped into this process, the
    pinned timeout word, and the epoch counter.  Built by a collective
    call: every rank makes it in the same order."""

    def __init__(self, mesh, key, timeout_s: float):
        self.mesh, self.key = mesh, tuple(key)
        self.layout = shift_layout(self.key)
        self.timeout_ns = int(timeout_s * 1e9)
        self.dev = mesh.device.index
        self.epoch = 0
        lib = _shift_lib()
        self._block, self._opened = ctypes.c_void_p(), []
        _cuda_ok(lib.paxi_shift_alloc(self.dev,
                                      self.layout.flags_off + _FLAG_BYTES,
                                      ctypes.byref(self._block)),
                 "lane_shift buffer allocation")
        host, devp = ctypes.c_void_p(), ctypes.c_void_p()
        _cuda_ok(lib.paxi_shift_host_word(self.dev, ctypes.byref(host),
                                          ctypes.byref(devp)),
                 "lane_shift host word")
        self._host_err, self._dev_err = host, devp
        self._err = ctypes.c_int.from_address(host.value)
        self._exchange_handles(lib)

    def _exchange_handles(self, lib) -> None:
        import torch.distributed as dist
        handle = ctypes.create_string_buffer(64)
        _cuda_ok(lib.paxi_shift_handle(self.dev, self._block, handle),
                 "cudaIpcGetMemHandle")
        handles = [None] * self.mesh.world
        dist.all_gather_object(handles, handle.raw, group=self.mesh.group)
        peers = {}
        for r in ((self.mesh.rank + 1) % self.mesh.world,
                  (self.mesh.rank - 1) % self.mesh.world):
            if r in peers:
                continue
            ptr = ctypes.c_void_p()
            _cuda_ok(lib.paxi_shift_open(self.dev, handles[r],
                                         ctypes.byref(ptr)),
                     f"cudaIpcOpenMemHandle of rank {r}")
            peers[r] = ptr.value
            self._opened.append(ptr.value)
        self.right = peers[(self.mesh.rank + 1) % self.mesh.world]
        self.left = peers[(self.mesh.rank - 1) % self.mesh.world]

    def raise_if_broken(self) -> None:
        """Raise if a wait timed out: its code sits in the pinned word."""
        if self._err.value:
            raise RuntimeError(f"lane_shift: a wait timed out (code "
                               f"{self._err.value}): the ring is broken")

    def close(self) -> None:
        """Unmap the neighbours' blocks and free this rank's (every rank
        closes after the last shift)."""
        import torch.distributed as dist
        lib = _shift_lib()
        for ptr in self._opened:
            lib.paxi_shift_close(self.dev, ptr)
        self._opened = []
        # every neighbour has unmapped this block before it is freed
        dist.barrier(group=self.mesh.group)
        lib.paxi_shift_free(self.dev, self._block)
        lib.paxi_shift_free_host_word(self._host_err)


def lane_shift_launch(xs, mesh, ch: Optional[ShiftChannel] = None):
    """One ring shift of the planes ``xs`` on the card: each output holds
    the left neighbour's plane.  At world 1 (``ch`` None) one copy launch
    into fresh outputs; over ranks two launches (send, receive) through
    ``ch``, whose key must be ``channel_key(xs)``."""
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_SEGMENTS:
        raise ValueError(f"a launch takes 1 to {MAX_SEGMENTS} planes, got "
                         f"{len(xs)}")
    for x in xs:
        if not x.is_cuda:
            raise ValueError(f"x is on {x.device}, expected a CUDA device")
        if x.device != mesh.device:
            raise ValueError(f"x is on {x.device}, the mesh on "
                             f"{mesh.device}")
        if not x.is_contiguous():
            raise ValueError("x is not contiguous")
    key = channel_key(xs)
    if ch is None and mesh.world != 1:
        raise ValueError(f"a ring of {mesh.world} ranks needs a channel")
    if ch is not None and key != ch.key:
        raise ValueError(f"the planes {key} are not the channel's {ch.key}")
    layout, nbytes, offsets, unit0 = _layout_arrays(key)
    if ch is not None:
        ch.raise_if_broken()
    outs = [torch.empty_like(x) for x in xs]
    n, vp = len(xs), ctypes.c_void_p
    src = (vp * n)(*[x.data_ptr() for x in xs])
    dst = (vp * n)(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(mesh.device).cuda_stream
    lib = _shift_lib()
    if ch is None:
        err = lib.paxi_lane_copy(mesh.device.index, n, src, dst, nbytes,
                                 unit0, stream)
        launches = 1
    else:
        ch.epoch += 1
        err = lib.paxi_lane_shift(
            ch.dev, n, src, dst, nbytes, offsets, unit0, ch._block,
            ch.right, ch.left, layout.flags_off, ch.epoch & 0xFFFFFFFF,
            ch._dev_err, ch.timeout_ns, stream)
        launches = 2                      # the send and receive sides
    _raise_on(err, "lane_shift")
    make_remote_lane_shift.launches += launches
    return outs


def make_remote_lane_shift(mesh, timeout_s: float = SHIFT_TIMEOUT_S):
    """Build ``shift(x)``: on rank r the output is rank ``(r - 1) %
    world``'s ``x`` (every rank's shard moves to its right neighbour), and
    ``shift.many(xs)``, the same over a state's planes (``[shift(x) for x
    in xs]``, the reference's ``jax.tree.map(shift, state)``) in one launch
    at world 1 and two over ranks, for up to ``MAX_SEGMENTS`` planes (more
    go ``MAX_SEGMENTS`` a launch).  Every rank calls with the same shapes
    in the same order.  On CPU tensors it runs ``lane_shift_plain``; on
    CUDA tensors the kernel, over ranks with one ``ShiftChannel`` per
    ``channel_key``, built at first use.  ``shift.check()`` waits for the
    card and raises if a wait timed out; ``shift.close()`` frees the
    channels."""
    channels = {}

    def many(xs):
        xs = list(xs)
        if all(x.device.type == "cpu" for x in xs):
            return [lane_shift_plain(x, mesh) for x in xs]
        for x in xs:
            if x.device.type != "cuda":
                raise ValueError(f"no lane-shift kernel for device "
                                 f"{x.device}")
        out = []
        for i in range(0, len(xs), MAX_SEGMENTS):
            part = xs[i:i + MAX_SEGMENTS]
            ch = None
            if mesh.world > 1:
                key = channel_key(part)
                if key not in channels:
                    channels[key] = ShiftChannel(mesh, key, timeout_s)
                ch = channels[key]
            out += lane_shift_launch(part, mesh, ch)
        return out

    def shift(x: torch.Tensor) -> torch.Tensor:
        return many([x])[0]

    def check() -> None:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        for ch in channels.values():
            ch.raise_if_broken()

    def close() -> None:
        check()
        for ch in channels.values():
            ch.close()
        channels.clear()

    shift.many, shift.check, shift.close = many, check, close
    shift.channels = channels
    return shift


make_remote_lane_shift.launches = 0


def reset_launches() -> None:
    wheel_deliver.launches = 0
    wheel_insert.launches = 0
    make_remote_lane_shift.launches = 0
