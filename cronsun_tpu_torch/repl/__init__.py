"""Replication plane, client side: replica-group store access.

Part of ``cronsun_tpu/repl/``: only :class:`ReplicaGroupStore`
(client.py), which ``store.sharded.connect_sharded`` builds for an
``addr1|addr2|addr3`` shard entry.  The server side (``ReplLog``,
``ReplManager``) is not in this package.
"""

from ..store.remote import NotLeaderError, QuorumTimeoutError
from .client import ReplicaGroupStore

__all__ = ["NotLeaderError", "QuorumTimeoutError", "ReplicaGroupStore"]
