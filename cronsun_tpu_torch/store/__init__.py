"""Coordination store (copy of ``cronsun_tpu/store/``).

- :class:`memstore.MemStore` — the in-process store with etcd v3
  semantics (revisioned KV, prefix watches with prev-kv, leases, CAS
  txns).
- :class:`remote.StoreServer` / :class:`remote.RemoteStore` — the same
  semantics over TCP, wire-compatible with the JAX package's server and
  client and with the native ``cronsun-stored``.
- :class:`sharded.ShardedStore` — the routing client over N store
  shards (``connect_sharded``), with the shard routing hash.
"""

from .memstore import (CompactedError, DELETE, Event, KV, Lease,  # noqa: F401
                       MemStore, PUT, WatchLost, Watcher)
from .remote import RemoteStore, StoreServer  # noqa: F401
from .sharded import (ShardedStore, ShardedWatcher,  # noqa: F401
                      connect_sharded, shard_index, shard_token)
