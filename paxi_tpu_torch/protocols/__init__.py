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
resolves a name to its replica factory), the JAX package's sixteen names:
a host twin of every protocol, and of the seeded bugs that share their
bug with the host (``bpaxos_noread``, ``switchpaxos_nogap``) and the
demo kernels, which the hunt's host replay and ``scenario run -host``
drive.  A sim name without a twin of its own (``paxos_pg``,
``wpaxos_thinq1``, ``wankeeper_nofloor``) replays against its base
protocol's (``trace/host.host_algorithm``).
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
    "abd": "paxi_tpu_torch.protocols.abd.host",
    "chain": "paxi_tpu_torch.protocols.chain.host",
    "wpaxos": "paxi_tpu_torch.protocols.wpaxos.host",
    "epaxos": "paxi_tpu_torch.protocols.epaxos.host",
    "kpaxos": "paxi_tpu_torch.protocols.kpaxos.host",
    "dynamo": "paxi_tpu_torch.protocols.dynamo.host",
    "sdpaxos": "paxi_tpu_torch.protocols.sdpaxos.host",
    "wankeeper": "paxi_tpu_torch.protocols.wankeeper.host",
    "blockchain": "paxi_tpu_torch.protocols.blockchain.host",
    "bpaxos": "paxi_tpu_torch.protocols.bpaxos.host",
    # seeded twins with a matching host twin: takeover without the
    # column read, and stamp gaps NOOP-committed; their witnesses are
    # the hunt's reproduced controls for real protocols
    "bpaxos_noread": "paxi_tpu_torch.protocols.bpaxos.noread",
    "switchpaxos": "paxi_tpu_torch.protocols.switchpaxos.host",
    "switchpaxos_nogap": "paxi_tpu_torch.protocols.switchpaxos.nogap",
    # the host twin of the scenario engine's churn-sensitive demo kernel
    "relay_churn": "paxi_tpu_torch.scenarios.demo_host",
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
