"""Carry a simulation's state across between the JAX package and the port.

The sim has no weights: what carries across is its carry ``(state, wheel,
fs, key)``, given on the JAX side as numpy arrays (``jax.device_get``) with
the wheel as a dict of per-type ``{"valid": bool, field: int32}`` planes
``(d, src, dst, G)`` and the key as ``uint32[2]``.  The port stores each
message type's lane-major wheel stacked (``sim/mailbox.WheelBox``) and its
key as int64 words.  A per-group carry (``paxos_pg``) keeps the
reference's layout: wheel planes ``(G, d, src, dst)`` as plain dicts, one
key a group ``(G, 2)``.  Dtypes carry over exactly: int32 stays int32,
bool stays bool.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from paxi_tpu_torch.sim.mailbox import WheelBox, stack_box, unstack_box


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def carry_from_numpy(carry, device, per_group: bool = False):
    """A JAX carry (numpy; lane-major, or a per-group kernel's when
    ``per_group``) -> the port's carry on ``device``."""
    state, wheel, fs, key = carry
    state = {k: _tensor(v, device) for k, v in state.items()}
    new_wheel = {}
    for name, planes in wheel.items():
        box = {k: _tensor(v, device) for k, v in planes.items()}
        if per_group:
            new_wheel[name] = box
            continue
        fields = tuple(k for k in planes if k != "valid")
        new_wheel[name] = WheelBox(fields, stack_box(box, fields))
    fs = {k: _tensor(v, device) for k, v in fs.items()}
    key = torch.from_numpy(np.asarray(key, dtype=np.uint32)
                           .astype(np.int64)).to(device)
    return (state, new_wheel, fs, key)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A state dict of tensors -> numpy arrays (dtypes kept)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def carry_to_numpy(carry) -> Tuple[Any, ...]:
    """The port's carry -> the JAX layout in numpy: the wheel back to
    per-type dicts of planes, the key to ``uint32[2]``."""
    state, wheel, fs, key = carry
    np_wheel = {name: state_to_numpy(unstack_box(box.planes, box.fields)
                                     if isinstance(box, WheelBox) else box)
                for name, box in wheel.items()}
    np_key = key.detach().cpu().numpy().astype(np.uint32)
    return (state_to_numpy(state), np_wheel, state_to_numpy(fs), np_key)
