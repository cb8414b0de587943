"""Cluster and benchmark configuration.

Reference: paxi config.go — ``Config{Addrs, HTTPAddrs, Policy, Threshold,
BufferSize, ChanBufferSize, MultiVersion, Benchmark}`` loaded from a shared
static ``config.json`` (no dynamic membership service).  This file keeps
the JSON schema compatible so a paxi ``config.json`` loads unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Dict, List

from paxi_tpu_torch.core.ident import ID


@dataclass
class Bconfig:
    """Benchmark workload spec.

    Reference: benchmark.go Bconfig{T, N, K, W, Concurrency, Distribution,
    Conflicts, Min, Mu, Sigma, Move, Speed, Zipfian_s, Zipfian_v, Throttle,
    LinearizabilityCheck}.
    """

    T: int = 10                 # seconds to run (0 => use N ops)
    N: int = 0                  # total ops if T == 0
    K: int = 1000               # key-space size
    W: float = 0.5              # write fraction
    concurrency: int = 1        # closed-loop client streams
    distribution: str = "uniform"  # uniform|conflict|normal|zipfian
    conflicts: int = 100        # % conflicting ops (conflict distribution)
    min: int = 0                # min key (conflict distribution)
    mu: float = 0.0             # normal distribution mean
    sigma: float = 60.0         # normal distribution stddev
    move: bool = False          # move normal-mean over time
    speed: int = 500            # mean-move speed (ms)
    zipfian_s: float = 2.0      # zipf skew
    zipfian_v: float = 1.0      # zipf value shift
    throttle: int = 0           # ops/sec limit (0 = unlimited)
    linearizability_check: bool = True
    # completions inside the first ``warmup`` seconds are reported
    # separately (dial-up, leader election, batch ramp) so
    # throughput_ops_s is steady-state — the host analog of bench.py's
    # compile_s/warmup_s split (0 = no split, every op counts)
    warmup: float = 0.0

    @staticmethod
    def from_dict(d: dict) -> "Bconfig":
        aliases = {
            "t": "T", "n": "N", "k": "K", "w": "W",
            "linearizabilitycheck": "linearizability_check",
            "zipfians": "zipfian_s", "zipfianv": "zipfian_v",
        }
        out = {}
        for k, v in d.items():
            kk = aliases.get(k.lower(), k.lower())
            if kk in ("T", "N", "K", "W"):
                out[kk] = v
            elif kk in Bconfig.__dataclass_fields__:
                out[kk] = v
        return Bconfig(**out)


@dataclass
class Config:
    """Static cluster definition, JSON-compatible with paxi's config.json.

    Reference: config.go.  ``addrs`` maps ID -> peer transport URL
    (tcp://, chan://, tpu-sim://); ``http_addrs`` maps ID -> client REST URL.
    """

    addrs: Dict[ID, str] = field(default_factory=dict)
    http_addrs: Dict[ID, str] = field(default_factory=dict)
    policy: str = "consecutive"   # WPaxos stealing policy (policy.go)
    threshold: float = 3          # policy threshold
    buffer_size: int = 1024       # socket buffer (BufferSize)
    chan_buffer_size: int = 1024  # in-process chan buffer (ChanBufferSize)
    multi_version: bool = False   # per-key value history in Database
    # commit-path batching (host/batch.py): commands per slot ceiling,
    # and the flush-timer ceiling in seconds (0 = flush on the next
    # event-loop tick — near-zero added latency, bursts still batch)
    batch_size: int = 64
    batch_wait: float = 0.0
    # leader-local reads (read-index style): reads order at the
    # leader's execute barrier instead of occupying log slots — halves
    # replication work at mixed workloads.  Sound under a single
    # stable leader (the lease assumption); off by default, and the
    # benchmark's linearizability checker gates every run that uses it.
    leader_reads: bool = False
    # the lease that makes ``leader_reads`` sound across elections
    # (protocols/paxos/host.py): a leader serves barrier reads only
    # within ``lease_s`` of its last quorum round's START, and a fresh
    # leader fences its first proposals for ``lease_s`` so no write can
    # commit while a deposed leader's lease may still be live.
    # ``lease_s <= 0`` disables the lease (the unfenced behavior).
    lease_s: float = 0.2
    # BPaxos compartmentalized tier (protocols/bpaxos): node-id role
    # assignment over sorted(ids) — first ``n_proxies`` proxy leaders,
    # next ``grid_rows * grid_cols`` the acceptor grid, rest replicas
    n_proxies: int = 2
    grid_rows: int = 2
    grid_cols: int = 2
    benchmark: Bconfig = field(default_factory=Bconfig)

    # ---- derived topology helpers -------------------------------------
    @property
    def ids(self) -> List[ID]:
        return sorted(self.addrs.keys())

    @property
    def n(self) -> int:
        return len(self.addrs)

    def zones(self) -> List[int]:
        return sorted({i.zone for i in self.ids})

    def npz(self) -> int:
        """Nodes per zone (assumes rectangular zone grid, like WPaxos)."""
        zs = self.zones()
        return len([i for i in self.ids if i.zone == zs[0]]) if zs else 0

    def index(self, id: ID) -> int:
        """Dense 0-based replica index used by the sim runtime."""
        return self.ids.index(ID(id))

    # ---- (de)serialization --------------------------------------------
    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            d = json.load(f)
        return Config.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        lower = {k.lower(): v for k, v in d.items()}
        cfg = Config()
        cfg.addrs = {ID(k): v for k, v in lower.get("address", lower.get("addrs", {})).items()}
        cfg.http_addrs = {ID(k): v for k, v in lower.get("http_address", lower.get("http_addrs", {})).items()}
        cfg.policy = lower.get("policy", cfg.policy)
        cfg.threshold = lower.get("threshold", cfg.threshold)
        cfg.buffer_size = lower.get("buffersize", lower.get("buffer_size", cfg.buffer_size))
        cfg.chan_buffer_size = lower.get("chanbuffersize", lower.get("chan_buffer_size", cfg.chan_buffer_size))
        cfg.multi_version = lower.get("multiversion", lower.get("multi_version", cfg.multi_version))
        cfg.batch_size = lower.get("batchsize", lower.get("batch_size", cfg.batch_size))
        cfg.batch_wait = lower.get("batchwait", lower.get("batch_wait", cfg.batch_wait))
        cfg.leader_reads = lower.get("leaderreads", lower.get("leader_reads", cfg.leader_reads))
        cfg.lease_s = lower.get("leases", lower.get("lease_s", cfg.lease_s))
        cfg.n_proxies = lower.get("nproxies", lower.get("n_proxies", cfg.n_proxies))
        cfg.grid_rows = lower.get("gridrows", lower.get("grid_rows", cfg.grid_rows))
        cfg.grid_cols = lower.get("gridcols", lower.get("grid_cols", cfg.grid_cols))
        if "benchmark" in lower:
            cfg.benchmark = Bconfig.from_dict(lower["benchmark"])
        return cfg

    def to_json(self, path: str) -> None:
        d = asdict(self)
        d["address"] = {str(k): v for k, v in d.pop("addrs").items()}
        d["http_address"] = {str(k): v for k, v in d.pop("http_addrs").items()}
        with open(path, "w") as f:
            json.dump(d, f, indent=2)


def local_config(n: int, zones: int = 1, base_port: int = 1735,
                 scheme: str = "tcp") -> Config:
    """Build an n-replica localhost config (zones x nodes-per-zone grid).

    Mirrors the sample bin/config.json layouts used by paxi's run scripts.
    """
    cfg = Config()
    npz = n // zones
    k = 0
    for z in range(1, zones + 1):
        for nn in range(1, npz + 1):
            i = ID(f"{z}.{nn}")
            cfg.addrs[i] = f"{scheme}://127.0.0.1:{base_port + k}"
            cfg.http_addrs[i] = f"http://127.0.0.1:{base_port + 1000 + k}"
            k += 1
    return cfg
