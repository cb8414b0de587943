"""Sharded multi-group serving: key-range router, cluster-of-clusters,
cross-shard 2PC, live range migration (the port's copy of the JAX
package's ``shard/``: the same names, wire forms and records; asyncio
Python on the CPU, no torch)."""

from paxi_tpu_torch.shard.cluster import ShardedCluster, group_config
from paxi_tpu_torch.shard.migrate import (MapHolder, MigrationCoordinator,
                                    MigrationError, MigrationKilled,
                                    Rebalancer)
from paxi_tpu_torch.shard.router import RouterServer, ShardRouter, label_group
from paxi_tpu_torch.shard.shardmap import ShardMap
from paxi_tpu_torch.shard.txn import (CoordinatorKilled, ShardCoordinator,
                                TxnOutcome, atomic_check, partition_ops)

__all__ = [
    "ShardMap", "ShardRouter", "RouterServer", "label_group",
    "ShardedCluster", "group_config", "ShardCoordinator",
    "CoordinatorKilled", "TxnOutcome", "partition_ops", "atomic_check",
    "MigrationCoordinator", "MigrationError", "MigrationKilled",
    "MapHolder", "Rebalancer",
]
