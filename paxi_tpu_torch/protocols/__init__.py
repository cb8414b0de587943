"""Protocol plugin registry for the torch sim runtime: a name resolves to
a ``SimProtocol``.  The lane-major ``paxos`` and ``epaxos`` kernels are
ported so far.
"""

from __future__ import annotations

import importlib

from paxi_tpu_torch.sim.types import SimProtocol

_SIM_MODULES = {
    "paxos": "paxi_tpu_torch.protocols.paxos.sim",
    "epaxos": "paxi_tpu_torch.protocols.epaxos.sim",
}


def sim_protocol(name: str) -> SimProtocol:
    """The sim kernel registered under ``name``."""
    try:
        module = _SIM_MODULES[name]
    except KeyError:
        raise KeyError(f"unknown or unported sim protocol {name!r}; "
                       f"known: {sorted(_SIM_MODULES)}") from None
    return importlib.import_module(module).PROTOCOL
