"""Cluster-of-clusters: G independent consensus groups behind one
router endpoint.

Each group is an ordinary ``host.simulation.Cluster`` — its own
config, its own chan fabric tag, any registered protocol — with the
group index folded into the zone digit of every replica id
(group g's replicas are ``{g+1}.1 .. {g+1}.n``), so the ids stay
globally unique and a SINGLE virtual-clock fabric can sequence all
groups in one logical clock (the fabric-replayed 2PC tests ride
this).  HTTP ports stack per group off one base port.

``proc=True`` runs each group as a ``server -simulation`` subprocess
instead (chan peers inside the subprocess, real TCP HTTP towards the
router) — the honest topology for throughput measurements: the groups
stop sharing the router/generator interpreter.

``routers=N`` starts N router endpoints over the same groups: one
PRIMARY (``router_url``) that owns map changes, plus N-1 stateless
secondaries (``router_urls``) that converge on a new map lazily — via
the coordinator's ``install_map`` fan-out when in its holder list, or
via the MOVED-bounce ``_map_refresh`` hook (GET /shardmap off the
primary) when a backend tells them their map is stale.  That is the
scale-out story for the router bottleneck BENCH_SHARD.json measures
past G=2: routers share nothing but the versioned map.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Union

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.shard.router import RouterServer, ShardRouter
from paxi_tpu_torch.shard.shardmap import ShardMap


def group_config(g: int, n: int, base_port: int, tag: str = "shard",
                 http: bool = True, batch_size: int = 64,
                 lease_s: float = 0.2) -> Config:
    """Group g's config: zone digit g+1, chan tag ``{tag}{g}``, HTTP
    ports ``base_port + g*n ..``."""
    cfg = Config()
    cfg.batch_size = batch_size
    cfg.lease_s = lease_s
    for k in range(1, n + 1):
        i = ID(f"{g + 1}.{k}")
        cfg.addrs[i] = f"chan://{tag}{g}/{i}"
        if http:
            cfg.http_addrs[i] = \
                f"http://127.0.0.1:{base_port + g * n + (k - 1)}"
    return cfg


class ShardedCluster:
    """G groups + the shard router, one start/stop lifecycle.

    ``algorithm`` may be one name for every group or a per-group
    sequence (heterogeneous fleets are first-class: any registered
    host protocol per group)."""

    def __init__(self, algorithm: Union[str, Sequence[str]],
                 groups: int = 2, n: int = 3,
                 shard_map: Optional[ShardMap] = None,
                 base_port: int = 0, router_port: int = 0,
                 http: bool = True, fabric=None, proc: bool = False,
                 tag: str = "shard", batch_size: int = 64,
                 lease_s: float = 0.2, routers: int = 1):
        if isinstance(algorithm, str):
            algorithm = [algorithm] * groups
        if len(algorithm) != groups:
            raise ValueError(f"{len(algorithm)} algorithms for "
                             f"{groups} groups")
        self.algorithms = list(algorithm)
        self.G = groups
        self.n = n
        self.map = shard_map or ShardMap.static(groups)
        if self.map.n_groups > groups:
            raise ValueError(f"map names group {self.map.n_groups - 1} "
                             f"but the fleet has {groups} groups")
        self.proc = proc
        self.fabric = fabric
        self.http = http or proc
        self.base_port = base_port or 18300
        self.router_port = router_port or (self.base_port + 99)
        self.cfgs = [group_config(g, n, self.base_port, tag=tag,
                                  http=self.http, batch_size=batch_size,
                                  lease_s=lease_s)
                     for g in range(groups)]
        self.n_routers = max(1, routers)
        self.clusters: List = []        # in-proc mode
        self.procs: List[subprocess.Popen] = []
        self._cfg_paths: List[str] = []
        self.router: Optional[ShardRouter] = None
        self.server: Optional[RouterServer] = None
        # (router, server) pairs for the stateless secondary tier
        self.secondaries: List = []
        self._mig_conns: Dict[int, object] = {}

    # ---- lifecycle ------------------------------------------------------
    async def start(self) -> None:
        from paxi_tpu_torch.host.simulation import Cluster
        if self.proc:
            for g, cfg in enumerate(self.cfgs):
                with tempfile.NamedTemporaryFile(
                        "w", suffix=f".shard{g}.json",
                        delete=False) as f:
                    path = f.name
                cfg.to_json(path)
                self._cfg_paths.append(path)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "paxi_tpu_torch", "server",
                     "-simulation", "-algorithm", self.algorithms[g],
                     "-config", path]))
            from paxi_tpu_torch.host.transport import wait_listening
            for cfg in self.cfgs:
                if not await wait_listening(cfg.http_addrs[cfg.ids[0]]):
                    raise RuntimeError("shard group subprocess never "
                                       "came up")
        else:
            self.clusters = [
                Cluster(self.algorithms[g], cfg=cfg, http=self.http,
                        fabric=self.fabric)
                for g, cfg in enumerate(self.cfgs)]
            for c in self.clusters:
                await c.start()
        if self.http:
            urls = [cfg.http_addrs[cfg.ids[0]] for cfg in self.cfgs]
            self.router = ShardRouter(
                self.map, urls,
                lease_s=self.cfgs[0].lease_s,
                group_scrape=self._scrape_groups,
                group_scrape_spans=self._scrape_spans)
            self.server = RouterServer(
                self.router, f"http://127.0.0.1:{self.router_port}")
            await self.server.start()
            for k in range(1, self.n_routers):
                r = ShardRouter(self.map, urls,
                                lease_s=self.cfgs[0].lease_s)
                r._map_refresh = self._refresh_for(r)
                s = RouterServer(
                    r, f"http://127.0.0.1:{self.router_port + k}")
                await s.start()
                self.secondaries.append((r, s))

    def _refresh_for(self, r: ShardRouter):
        """A secondary router's map-refresh hook: pull the primary's
        current map and install it (a no-op ValueError when this
        router already caught up)."""
        async def refresh() -> None:
            from paxi_tpu_torch.host.client import _Conn
            conn = _Conn(self.router_url)
            try:
                status, _, payload = await conn.request(
                    "GET", "/shardmap", {}, b"")
                if status == 200:
                    r.install_map(ShardMap.from_json(payload.decode()))
            finally:
                conn.close()
        return refresh

    async def stop(self) -> None:
        for _, s in self.secondaries:
            await s.stop()
        self.secondaries = []
        for conn in self._mig_conns.values():
            conn.close()
        self._mig_conns = {}
        if self.server:
            await self.server.stop()
        for c in self.clusters:
            await c.stop()
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for path in self._cfg_paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.procs, self._cfg_paths = [], []

    # ---- access ---------------------------------------------------------
    @property
    def router_url(self) -> str:
        return f"http://127.0.0.1:{self.router_port}"

    @property
    def router_urls(self) -> List[str]:
        """Every router endpoint: the primary first, then the
        stateless secondaries."""
        return [f"http://127.0.0.1:{self.router_port + k}"
                for k in range(self.n_routers)]

    # ---- live migration -------------------------------------------------
    def migrator(self, chunk: int = 64, crash_at: Optional[str] = None,
                 busy_wait_s: float = 0.05):
        """A MigrationCoordinator over this fleet: records travel as
        POST /mig to each group's entry node, and every router (the
        primary AND the secondaries) is in the holder list, so map
        epochs install everywhere before the records that depend on
        them commit."""
        from paxi_tpu_torch.shard.migrate import MigrationCoordinator
        if self.router is None:
            raise RuntimeError("migrator() needs the HTTP router tier")
        holders = [self.router] + [r for r, _ in self.secondaries]
        return MigrationCoordinator(self._mig_submit, holders,
                                    chunk=chunk, crash_at=crash_at,
                                    busy_wait_s=busy_wait_s)

    async def _mig_submit(self, group: int, key: int, rec: dict):
        """Migration-record transport: POST /mig to the group's entry
        node over a dedicated per-group connection (records must not
        queue behind a KV burst in the router's shared pipes)."""
        from paxi_tpu_torch.host.client import _Conn
        doc: Dict = {"kind": rec["kind"], "mid": rec["mid"],
                     "key": int(key)}
        for f in ("lo", "hi", "span", "cursor", "limit"):
            if f in rec:
                doc[f] = int(rec[f])
        if "items" in rec:
            doc["items"] = [[k, v.decode("latin1")]
                            for k, v in rec["items"]]
        conn = self._mig_conns.get(group)
        if conn is None:
            cfg = self.cfgs[group]
            conn = _Conn(cfg.http_addrs[cfg.ids[0]])
            self._mig_conns[group] = conn
        try:
            status, _, payload = await conn.request(
                "POST", "/mig", {}, json.dumps(doc).encode())
            return status == 200, payload
        except (IOError, OSError) as e:
            return False, repr(e).encode()

    def group(self, g: int):
        """The in-proc Cluster of group g (in-proc mode only)."""
        return self.clusters[g]

    def leader_node(self, g: int):
        """Group g's entry replica (in-proc mode only) — the node the
        router's pipes dial, and the direct-injection point for the
        fabric-replayed 2PC tests."""
        c = self.clusters[g]
        return c.replicas[c.cfg.ids[0]]

    async def _scrape_groups(self) -> List[List[Dict]]:
        """Per-group registry snapshots for the router's /metrics
        aggregation (``group`` label applied by the router)."""
        if self.clusters:
            return [[r.metrics.snapshot()
                     for r in c.replicas.values()]
                    for c in self.clusters]
        # subprocess mode: scrape each group's entry node
        from paxi_tpu_torch.host.client import _Conn
        out: List[List[Dict]] = []
        for cfg in self.cfgs:
            conn = _Conn(cfg.http_addrs[cfg.ids[0]])
            try:
                status, _, payload = await conn.request(
                    "GET", "/metrics?format=json", {}, b"")
                out.append([json.loads(payload.decode())]
                           if status == 200 else [])
            except (IOError, OSError):
                out.append([])
            finally:
                conn.close()
        return out

    async def _scrape_spans(self) -> List[List[Dict]]:
        """Per-group span exports for the router's /spans stitching —
        the span twin of ``_scrape_groups`` (the router stamps the
        ``group`` label before merging)."""
        if self.clusters:
            return [[d for r in c.replicas.values()
                     for d in r.spans.export()]
                    for c in self.clusters]
        from paxi_tpu_torch.host.client import _Conn
        out: List[List[Dict]] = []
        for cfg in self.cfgs:
            group: List[Dict] = []
            for i in cfg.ids:
                conn = _Conn(cfg.http_addrs[i])
                try:
                    status, _, payload = await conn.request(
                        "GET", "/spans", {}, b"")
                    if status == 200:
                        group.extend(
                            json.loads(payload.decode())["spans"])
                except (IOError, OSError):
                    pass
                finally:
                    conn.close()
            out.append(group)
        return out
