"""Protocol plugin registry for the torch sim runtime: a name resolves to
a ``SimProtocol``.  The lane-major ``paxos``, ``epaxos``, ``sdpaxos`` and
``wpaxos`` kernels are ported so far, with ``wpaxos_thinq1``, the seeded
thin-read-quorum twin of ``wpaxos``, and ``paxos_pg``, the per-group
(group axis leading) Multi-Paxos kernel.
"""

from __future__ import annotations

import importlib

from paxi_tpu_torch.sim.types import SimProtocol

_SIM_MODULES = {
    "paxos": "paxi_tpu_torch.protocols.paxos.sim",
    "paxos_pg": "paxi_tpu_torch.protocols.paxos.sim_pg",
    "epaxos": "paxi_tpu_torch.protocols.epaxos.sim",
    "sdpaxos": "paxi_tpu_torch.protocols.sdpaxos.sim",
    "wpaxos": "paxi_tpu_torch.protocols.wpaxos.sim",
    "wpaxos_thinq1": "paxi_tpu_torch.protocols.wpaxos.sim:PROTOCOL_THINQ1",
}


def sim_protocol(name: str) -> SimProtocol:
    """The sim kernel registered under ``name``."""
    try:
        module = _SIM_MODULES[name]
    except KeyError:
        raise KeyError(f"unknown or unported sim protocol {name!r}; "
                       f"known: {sorted(_SIM_MODULES)}") from None
    module, _, attr = module.partition(":")
    return getattr(importlib.import_module(module), attr or "PROTOCOL")
