"""Replication plane: per-shard leader/follower WAL shipping (copy of
``cronsun_tpu/repl/``).

Each store shard runs as a leader plus K followers shipping the
existing WAL record format (checkpoint/walsnap.py — the native
stored.cc shares it), so a follower's on-disk state is exactly a
replica's snap+WAL and bootstrap is snapshot transfer + tail
streaming.  Leases and fences are granted ONLY by the leader, so
exactly-once semantics are unchanged; followers serve bounded-lag
reads that report their applied revision into the existing
revision-vector machinery.  Failover stamps a fencing epoch into the
stream ("E" record) so a deposed leader's late appends are refused.

- :class:`ReplLog` (log.py): the leader's bounded in-memory shipping
  ring with a dedicated monotone cursor and the epoch history used for
  log matching at follower hello.
- :class:`ReplManager` (manager.py): the per-process role machine —
  leader-side follower/ack tracking, follower-side bootstrap + pull
  loop, promotion and demotion; a ``StoreServer`` serves it through
  ``attach_repl``.
- :class:`ReplicaGroupStore` (client.py): client wrapper over an
  ``addr1|addr2|addr3`` replica group that discovers the leader and
  rotates on leader loss; ``store.sharded.connect_sharded`` builds one
  for such a shard entry.
"""

from ..store.remote import NotLeaderError, QuorumTimeoutError
from .client import ReplicaGroupStore, fleet_repl_status
from .log import ReplLog
from .manager import ReplManager

__all__ = ["NotLeaderError", "QuorumTimeoutError", "ReplLog",
           "ReplManager", "ReplicaGroupStore", "fleet_repl_status"]
