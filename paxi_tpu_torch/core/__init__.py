"""Core types of the host runtime (the port's copy of the JAX package's
``core/``; ``policy.py`` is the wpaxos twin's object-stealing policy).

Reference (paxi): id.go, config.go, msg.go, db.go, quorum.go.
"""

from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.config import Config, Bconfig
from paxi_tpu_torch.core.command import Command, Request, Reply
from paxi_tpu_torch.core.db import Database
from paxi_tpu_torch.core.quorum import Quorum

__all__ = ["ID", "Config", "Bconfig", "Command", "Request", "Reply",
           "Database", "Quorum"]
