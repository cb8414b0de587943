"""Shard the instance batch over ranks (``torch.distributed``)."""

from paxi_tpu_torch.parallel.mesh import (Mesh, gather_state, make_mesh,
                                          make_sharded_pinned_run,
                                          make_sharded_run)

__all__ = ["Mesh", "make_mesh", "make_sharded_run", "gather_state",
           "make_sharded_pinned_run"]
