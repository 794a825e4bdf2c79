"""Client side of the replication plane: replica-group store access.

:class:`ReplicaGroupStore` wraps one shard's ``addr1|addr2|addr3``
replica group behind the exact RemoteStore surface, so it slots into
``ShardedStore`` (one group per shard, behind its breakers) and
``connect_store`` unchanged.  It discovers the group's leader via
``repl_status`` probes, sends every op there, and ROTATES on leader
loss: ``NotLeaderError`` / connection errors invalidate the cached
leader, the discovery sweep finds the promoted follower (highest
fencing epoch wins), and the op retries through the shared RECONNECT
backoff ladder.  A plain unreplicated server (``repl_status`` ->
``enabled: False``) counts as its own leader, so a 1-member "group" is
byte-compatible with today's direct connection.

Watches ride the leader connection with ``reconnect=False``: when that
connection dies the group marks every live watcher LOST (instead of
letting the built-in heal loop retry a dead address forever), so
consumers re-list + re-watch through the next ``watch()`` call, which
lands on the new leader.

Copy of ``cronsun_tpu/repl/client.py``; the only difference: comments that dated a
behaviour by the JAX package's history now say what it is.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import log as _log
from ..core.backoff import RECONNECT
from ..store.remote import (NotLeaderError, QuorumTimeoutError,
                            RemoteStore, RemoteStoreError, RemoteWatcher)

# every RemoteStore RPC the components call, forwarded with rotation
_FORWARD = frozenset({
    "put", "put_many", "get", "get_many", "get_prefix",
    "get_prefix_page", "count_prefix", "delete", "delete_prefix",
    "delete_many", "put_if_absent", "put_if_mod_rev", "claim",
    "claim_many", "claim_bundle", "claim_bundle_many", "grant",
    "keepalive", "revoke", "lease_ttl_remaining", "op_stats",
    "snapshot", "rev", "repl_status"})


class ReplicaGroupStore:
    """One shard's replica group as a single self-routing store client."""

    MAX_ATTEMPTS = 6    # rotation attempts per op before giving up

    def __init__(self, addrs: List[str], timeout: float = 10.0,
                 token: str = "", sslctx=None, tls_hostname: str = ""):
        if not addrs or any(not a.strip() for a in addrs):
            raise ValueError(f"replica group {addrs!r} has an empty "
                             "member")
        self.addrs = [a.strip() for a in addrs]
        self._timeout = timeout
        self._token = token
        self._sslctx = sslctx
        self._tls_hostname = tls_hostname
        self._mu = threading.RLock()
        self._leader: Optional[RemoteStore] = None
        self._leader_addr: Optional[str] = None
        self._closed = False
        # fail fast if NOTHING in the group answers at construction
        # (connect_store's contract: a bad address errors at connect
        # time, not on first use)
        if self._leader_client() is None:
            raise OSError(f"no replica of group {self.addrs} reachable")

    # ---- leader discovery ------------------------------------------------

    def _dial(self, addr: str) -> RemoteStore:
        host, _, port = addr.rpartition(":")
        return RemoteStore(host, int(port), timeout=self._timeout,
                           reconnect=False, token=self._token,
                           sslctx=self._sslctx,
                           tls_hostname=self._tls_hostname)

    def _leader_client(self) -> Optional[RemoteStore]:
        with self._mu:
            if self._closed:
                raise RemoteStoreError("replica-group store closed")
            cli = self._leader
            if cli is not None and cli._sock is not None \
                    and not cli._closed:
                return cli
            self._leader = self._leader_addr = None
            best = None      # (epoch, addr, client, status)
            for addr in self.addrs:
                try:
                    cli = self._dial(addr)
                    st = cli.repl_status()
                except (OSError, RemoteStoreError, KeyError):
                    continue
                if not isinstance(st, dict):
                    cli.close()
                    continue
                if not st.get("enabled"):
                    # plain unreplicated server: it IS the leader of
                    # its 1-member group
                    if best is not None:
                        best[2].close()
                    best = (0, addr, cli, st)
                    break
                if st.get("role") == "leader":
                    ep = int(st.get("epoch", 0))
                    if best is None or ep > best[0]:
                        if best is not None:
                            best[2].close()
                        best = (ep, addr, cli, st)
                        continue
                cli.close()
            if best is None:
                return None
            _ep, addr, cli, _st = best
            cli.on_disconnect = self._on_conn_dead
            self._leader, self._leader_addr = cli, addr
            if len(self.addrs) > 1:
                _log.infof("replica group %s: leader is %s",
                           self.addrs, addr)
            return cli

    def _on_conn_dead(self, cli: RemoteStore):
        """The leader connection died (reconnect=False, so the built-in
        heal is off): invalidate the cache and mark its watchers LOST —
        consumers re-list + re-watch, landing on the new leader."""
        with self._mu:
            if self._leader is cli:
                self._leader = self._leader_addr = None
        for w in list(cli._watchers.values()):
            w._mark_lost()

    def _invalidate(self, cli: Optional[RemoteStore]):
        with self._mu:
            if cli is not None and self._leader is cli:
                self._leader = self._leader_addr = None
        if cli is not None:
            for w in list(cli._watchers.values()):
                w._mark_lost()
            try:
                cli.close()
            except OSError:
                pass

    # ---- op routing ------------------------------------------------------

    def _op(self, name: str, *args, **kw):
        last: Optional[Exception] = None
        for attempt in range(self.MAX_ATTEMPTS):
            cli = self._leader_client()
            if cli is None:
                last = RemoteStoreError(
                    f"no leader reachable in replica group {self.addrs}")
                RECONNECT.sleep(attempt + 1)
                continue
            try:
                return getattr(cli, name)(*args, **kw)
            except QuorumTimeoutError:
                # the op APPLIED on the leader but missed its quorum
                # window: a blind rotation-retry would double-apply
                # non-idempotent ops (grant allocates a second lease,
                # put/delete double-bump the revision and double-fire
                # watches) — surface the named error, the caller
                # decides
                raise
            except NotLeaderError as e:
                # the replica demoted (or we raced a failover): rotate
                # immediately, the promoted member answers the sweep
                last = e
                self._invalidate(cli)
            except (RemoteStoreError, OSError) as e:
                last = e
                self._invalidate(cli)
                RECONNECT.sleep(attempt + 1)
        raise last if last is not None else RemoteStoreError(
            f"replica group {self.addrs}: no attempt ran")

    def __getattr__(self, name: str):
        if name in _FORWARD:
            def call(*args, __n=name, **kw):
                return self._op(__n, *args, **kw)
            call.__name__ = name
            return call
        raise AttributeError(name)

    def get_prefix_paged(self, prefix: str, page: int = 50_000):
        """RemoteStore.get_prefix_paged's loop, but each page routes
        through the rotation — a mid-iteration failover resumes on the
        new leader (usual range-pagination read skew applies)."""
        page = max(1, page)
        start_after = ""
        while True:
            kvs = self._op("get_prefix_page", prefix, start_after, page)
            yield from kvs
            if len(kvs) < page:
                return
            start_after = kvs[-1].key

    def watch(self, prefix: str, start_rev: int = 0,
              events: str = "") -> RemoteWatcher:
        """Watch via the current leader connection.  When that
        connection (or the leader) dies, the stream goes LOST — the
        consumer's normal re-list + re-watch lands here again and gets
        the promoted leader."""
        last: Optional[Exception] = None
        for attempt in range(self.MAX_ATTEMPTS):
            cli = self._leader_client()
            if cli is None:
                last = RemoteStoreError(
                    f"no leader reachable in replica group {self.addrs}")
                RECONNECT.sleep(attempt + 1)
                continue
            try:
                return cli.watch(prefix, start_rev, events)
            except NotLeaderError as e:
                last = e
                self._invalidate(cli)
            except RemoteStoreError as e:
                last = e
                self._invalidate(cli)
                RECONNECT.sleep(attempt + 1)
        raise last if last is not None else RemoteStoreError(
            f"replica group {self.addrs}: no attempt ran")

    # ---- replica access (fsck / status surfaces) -------------------------

    def leader_addr(self) -> Optional[str]:
        with self._mu:
            return self._leader_addr

    def replica_statuses(self) -> Dict[str, Optional[dict]]:
        """repl_status from EVERY member (None = unreachable) — the
        ctl/web status surfaces and the fsck replication audit."""
        out: Dict[str, Optional[dict]] = {}
        for addr in self.addrs:
            try:
                cli = self._dial(addr)
            except OSError:
                out[addr] = None
                continue
            try:
                out[addr] = cli.repl_status()
            except (RemoteStoreError, OSError, KeyError):
                out[addr] = None
            finally:
                cli.close()
        return out

    def dial_replica(self, addr: str) -> RemoteStore:
        """Fresh direct connection to one member (fsck reads follower
        state below the min applied revision through this)."""
        return self._dial(addr)

    # ---- lifecycle -------------------------------------------------------

    def clone(self) -> "ReplicaGroupStore":
        return ReplicaGroupStore(list(self.addrs), timeout=self._timeout,
                                 token=self._token, sslctx=self._sslctx,
                                 tls_hostname=self._tls_hostname)

    def close(self):
        with self._mu:
            self._closed = True
            cli, self._leader = self._leader, None
            self._leader_addr = None
        if cli is not None:
            try:
                cli.close()
            except OSError:
                pass

    def start_sweeper(self, interval: float = 0.2):
        pass    # the servers own their sweepers (RemoteStore compat)


def fleet_repl_status(store) -> List[dict]:
    """Per-shard replication status for a connected store client —
    the ``GET /v1/repl`` / ``cronsun-ctl repl status`` source.

    Accepts a ShardedStore (walks its raw shard clients), a
    ReplicaGroupStore, or a plain RemoteStore.  Returns one entry per
    shard: ``{"shard": i, "replicas": {addr: status-or-None}}`` where
    unreplicated shards carry their single ``repl_status`` reply."""
    raw = getattr(store, "_raw", None)
    clients = list(raw) if raw is not None else [store]
    out: List[dict] = []
    for i, cli in enumerate(clients):
        entry: dict = {"shard": i}
        if isinstance(cli, ReplicaGroupStore):
            entry["group"] = list(cli.addrs)
            entry["replicas"] = cli.replica_statuses()
        else:
            addr = f"{getattr(cli, 'host', '?')}:" \
                   f"{getattr(cli, 'port', '?')}"
            try:
                st = cli.repl_status()
            except (RemoteStoreError, OSError, KeyError):
                st = None
            entry["group"] = [addr]
            entry["replicas"] = {addr: st}
        out.append(entry)
    return out
