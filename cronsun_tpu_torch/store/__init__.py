"""Coordination store (copy of ``cronsun_tpu/store/``, in-process part).

:class:`memstore.MemStore` is the in-process store with etcd v3
semantics (revisioned KV, prefix watches with prev-kv, leases, CAS
txns); :mod:`sharded` holds the shard routing hash.  The TCP client and
server, and the sharded routing client, come with the port of the
launcher.
"""

from .memstore import (CompactedError, DELETE, Event, KV, Lease,  # noqa: F401
                       MemStore, PUT, WatchLost, Watcher)
