"""The lane-major message-exchange kernels (CUDA for Hopper).

``wheel_deliver`` and ``wheel_insert`` replace the JAX package's Pallas
pair in ``paxi_tpu/ops/exchange.py`` and have the signatures of the plain
exchange in ``sim/mailbox.py``.  Per message type one kernel launch moves
the stacked ``(d, F, R, R, G)`` wheel block (``csrc/exchange.cu``).

Dispatch is by the tensors' device and nothing else: on CPU tensors each
message type runs the plain version (``mailbox.deliver_planes`` /
``insert_planes``); on CUDA tensors it launches the kernel or raises.  Each
wrapper counts its kernel launches in a plain integer attribute
(``wheel_deliver.launches``, ``wheel_insert.launches``) so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


def reset_launches() -> None:
    wheel_deliver.launches = 0
    wheel_insert.launches = 0
