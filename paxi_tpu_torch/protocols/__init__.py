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

``_HOST_MODULES`` is the asyncio host runtime's registry (``host_replica``
resolves a name to its replica factory): the host twins ported so far,
which the hunt's host replay and ``scenario run -host`` drive.  The JAX
package's other twins are queued (``trace/host.py`` keeps a copy of their
``TRACE_MSG_MAP``s, so their witnesses still project).
"""

from __future__ import annotations

import importlib
from typing import Callable

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

_HOST_MODULES = {
    # the host twin of the trace engine's demo kernel: the hunt's
    # end-to-end reproduction fixture
    "fragile_counter": "paxi_tpu_torch.trace.demo_host",
    "paxos": "paxi_tpu_torch.protocols.paxos.host",
    "switchpaxos": "paxi_tpu_torch.protocols.switchpaxos.host",
    # the seeded twin with a matching host twin: its drop witnesses are
    # the in-fabric tier's reproduced control
    "switchpaxos_nogap": "paxi_tpu_torch.protocols.switchpaxos.nogap",
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


def host_replica(name: str) -> Callable:
    """The host replica factory (``new_replica``) registered under
    ``name``."""
    try:
        module = _HOST_MODULES[name]
    except KeyError:
        raise KeyError(f"unknown host protocol {name!r}; "
                       f"known: {sorted(_HOST_MODULES)}") from None
    return importlib.import_module(module).new_replica
