"""Protocol plugin registry for the torch sim runtime: a name resolves to
a ``SimProtocol``, as in the JAX package's registry (``"module:ATTR"``
picks a symbol other than ``PROTOCOL``).  Ported: the lane-major
``paxos``, ``epaxos``, ``sdpaxos``, ``wpaxos``, ``wankeeper``, ``bpaxos``,
``chain``, ``kpaxos``, ``abd``, ``dynamo``, ``blockchain`` and
``switchpaxos`` kernels; ``paxos_pg``, the per-group (group axis leading)
Multi-Paxos kernel; four seeded-bug twins, which violate by design:
``wpaxos_thinq1`` (a phase-1 grid quorum one zone thin),
``wankeeper_nofloor`` (no granted-version floor), ``bpaxos_noread``
(takeover without the column read) and ``switchpaxos_nogap`` (stamp gaps
NOOP-committed instead of gap agreement); and the per-group demo kernels
of the trace and scenario engines, ``fragile_counter`` and
``relay_churn``, which violate by design too.  Every sim name of the JAX
package's registry resolves here.
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
    "wankeeper": "paxi_tpu_torch.protocols.wankeeper.sim",
    "wankeeper_nofloor":
        "paxi_tpu_torch.protocols.wankeeper.sim:PROTOCOL_NOFLOOR",
    "bpaxos": "paxi_tpu_torch.protocols.bpaxos.sim",
    "bpaxos_noread": "paxi_tpu_torch.protocols.bpaxos.sim:PROTOCOL_NOREAD",
    "chain": "paxi_tpu_torch.protocols.chain.sim",
    "kpaxos": "paxi_tpu_torch.protocols.kpaxos.sim",
    "abd": "paxi_tpu_torch.protocols.abd.sim",
    "dynamo": "paxi_tpu_torch.protocols.dynamo.sim",
    "blockchain": "paxi_tpu_torch.protocols.blockchain.sim",
    "switchpaxos": "paxi_tpu_torch.protocols.switchpaxos.sim",
    "switchpaxos_nogap":
        "paxi_tpu_torch.protocols.switchpaxos.sim:PROTOCOL_NOGAP",
    "fragile_counter": "paxi_tpu_torch.trace.demo",
    "relay_churn": "paxi_tpu_torch.scenarios.demo",
}


def sim_protocol(name: str) -> SimProtocol:
    """The sim kernel registered under ``name``."""
    try:
        module = _SIM_MODULES[name]
    except KeyError:
        raise KeyError(f"unknown sim protocol {name!r}; "
                       f"known: {sorted(_SIM_MODULES)}") from None
    module, _, attr = module.partition(":")
    return getattr(importlib.import_module(module), attr or "PROTOCOL")
