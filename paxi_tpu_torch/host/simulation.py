"""Single-process multi-node simulation mode.

Reference: ``server -simulation`` (bin/server/main.go) launches every ID
from the config in one process over the ``chan`` transport [driver] —
the de-facto integration harness.  Here: all replicas share one asyncio
event loop; the in-process fabric lives in host/transport.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from paxi_tpu_torch.core.config import Config, local_config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.transport import reset_chan_fabric


def chan_config(n: int, zones: int = 1, tag: str = "sim") -> Config:
    """An n-replica config on the in-process fabric (+ local HTTP)."""
    cfg = local_config(n, zones=zones, scheme="tcp")
    cfg.addrs = {i: f"chan://{tag}/{i}" for i in cfg.addrs}
    return cfg


class Cluster:
    """All replicas of a config in one event loop (simulation mode).

    ``fabric``: a virtual-clock fabric (host/fabric.py) to sequence all
    peer deliveries through — the trace-replay transport.  It is made
    ambient while the replicas are constructed, so unmodified protocol
    factories (which only know ``(id, cfg)``) still wire into it."""

    def __init__(self, algorithm: str, cfg: Optional[Config] = None,
                 n: int = 3, zones: int = 1, http: bool = True,
                 fabric=None):
        from paxi_tpu_torch.host.fabric import use_fabric
        from paxi_tpu_torch.protocols import host_replica
        self.cfg = cfg or chan_config(n, zones)
        if not http:
            self.cfg.http_addrs = {}
        self.fabric = fabric
        new = host_replica(algorithm)
        if fabric is None:
            self.replicas: Dict[ID, object] = {
                i: new(i, self.cfg) for i in self.cfg.ids}
        else:
            with use_fabric(fabric):
                self.replicas = {i: new(i, self.cfg)
                                 for i in self.cfg.ids}

    async def start(self) -> None:
        for r in self.replicas.values():
            await r.start()

    async def stop(self) -> None:
        for r in self.replicas.values():
            await r.stop()
        reset_chan_fabric()

    def __getitem__(self, id) -> object:
        return self.replicas[ID(id)]

    @property
    def ids(self) -> List[ID]:
        return self.cfg.ids
