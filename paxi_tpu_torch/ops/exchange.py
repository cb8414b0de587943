"""The lane-major message-exchange kernels and the ring shift between
ranks (CUDA for Hopper).

``wheel_deliver`` and ``wheel_insert`` replace the JAX package's Pallas
pair in ``paxi_tpu/ops/exchange.py`` and have the signatures of the plain
exchange in ``sim/mailbox.py``.  Per message type one kernel launch moves
the stacked ``(d, F, R, R, G)`` wheel block (``csrc/exchange.cu``).

``make_remote_lane_shift(mesh)`` replaces the reference's function of the
same name: ``shift(x)`` moves every rank's whole shard to its right-hand
neighbour, and ``shift.many(xs)`` every plane of a state at once: one copy
launch at world 1, and over ranks a copy kernel a side that stores
straight into the neighbour's memory through CUDA IPC
(``csrc/lane_shift.cu``).  No run path calls it,
as in the reference; it is the staged group-migration primitive.

Dispatch is by the tensors' device and nothing else: on CPU tensors each
runs its plain version (``mailbox.deliver_planes`` / ``insert_planes`` /
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
from typing import NamedTuple, Optional, Tuple

import torch

from paxi_tpu_torch.collectives import all_gather
from paxi_tpu_torch.ops import _build
from paxi_tpu_torch.sim import mailbox as mb

_LIB = "exchange"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built and
    loaded on the first launch)."""
    lib = _build.load(_LIB)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.paxi_wheel_deliver.argtypes = [p, p, p, i64, i32, p]
    lib.paxi_wheel_deliver.restype = i32
    lib.paxi_wheel_insert.argtypes = [p, p, p, p, p, p, i64, i32, i32, p]
    lib.paxi_wheel_insert.restype = i32
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def deliver_launch(w: torch.Tensor):
    """One message type on the card: ``(inbox, rolled)`` of the stacked
    wheel ``w (d, F, R, R, G)`` int32, as ``mailbox.deliver_planes``."""
    if w.ndim != 5 or w.shape[0] < 1:
        raise ValueError(f"wheel block must be (d, F, R, R, G), got "
                         f"{tuple(w.shape)}")
    _check(w, "wheel", torch.int32, w.shape, w.device)
    d = w.shape[0]
    inbox = torch.empty(w.shape[1:], dtype=torch.int32, device=w.device)
    rolled = torch.empty_like(w)
    lib = _lib()
    err = lib.paxi_wheel_deliver(
        w.data_ptr(), inbox.data_ptr(), rolled.data_ptr(), inbox.numel(), d,
        torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(err, "wheel_deliver")
    wheel_deliver.launches += 1
    return inbox, rolled


def insert_launch(w, ob, eff, delay, dup):
    """One message type on the card: the stacked wheel ``w (d, F, R, R,
    G)`` with the stacked outbox ``ob (F, R, R, G)`` pushed in under
    ``eff``/``dup`` (bool) and ``delay`` (int32) ``(R, R, G)``, as
    ``mailbox.insert_planes``."""
    if w.ndim != 5:
        raise ValueError(f"wheel block must be (d, F, R, R, G), got "
                         f"{tuple(w.shape)}")
    dev, edge = w.device, w.shape[2:]
    _check(w, "wheel", torch.int32, w.shape, dev)
    _check(ob, "outbox", torch.int32, w.shape[1:], dev)
    _check(eff, "eff", torch.bool, edge, dev)
    _check(delay, "delay", torch.int32, edge, dev)
    _check(dup, "dup", torch.bool, edge, dev)
    out = torch.empty_like(w)
    lib = _lib()
    err = lib.paxi_wheel_insert(
        w.data_ptr(), ob.data_ptr(), eff.data_ptr(), delay.data_ptr(),
        dup.data_ptr(), out.data_ptr(), eff.numel(), w.shape[1], w.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "wheel_insert")
    wheel_insert.launches += 1
    return out


def _deliver(w: torch.Tensor):
    if w.device.type == "cpu":
        return mb.deliver_planes(w)
    if w.device.type != "cuda":
        raise ValueError(f"no exchange kernel for device {w.device}")
    return deliver_launch(w)


def _insert(w, ob, eff, delay, dup):
    if w.device.type == "cpu":
        return mb.insert_planes(w, ob, eff, delay, dup)
    if w.device.type != "cuda":
        raise ValueError(f"no exchange kernel for device {w.device}")
    return insert_launch(w, ob, eff, delay, dup)


def wheel_deliver(wheel: mb.Wheel):
    """Pop slot 0 as this step's inbox; rotate the wheel forward (one
    kernel launch per message type on the card)."""
    return mb.wheel_deliver(wheel, deliver=_deliver)


def wheel_insert(wheel: mb.Wheel, outbox, fs, faults) -> mb.Wheel:
    """Push this step's outbox into the wheel under the fault schedule
    (one kernel launch per message type on the card)."""
    return mb.wheel_insert(wheel, outbox, fs, faults, insert=_insert)


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
