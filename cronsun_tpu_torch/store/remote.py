"""Networked coordination store: MemStore served over TCP.

The reference's topology is N machines talking to etcd over gRPC
(client.go:24-114, watches at job.go:369-371).  This module provides the
same boundary for the rebuild: :class:`StoreServer` exposes a MemStore's
full API (revisioned KV, prefix watches with prev-kv, leases, CAS txns)
over a line-delimited JSON protocol, and :class:`RemoteStore` is a
drop-in client with the identical Python surface — every component
(scheduler, agents, web, noticer) runs unchanged against either.

Wire protocol (one JSON object per line, UTF-8):

    client -> server   {"i": <id>, "o": <op>, "a": [args...]}
    server -> client   {"i": <id>, "r": <result>}            (ok)
                       {"i": <id>, "e": <msg>, "k": <kind>}  (error)
                       {"w": <wid>, "evs": [<event>...]}     (watch push,
                                                              batched)
                       {"w": <wid>, "ev": <event>}           (legacy
                                                              single push)

KV wire form: [key, value, create_rev, mod_rev, lease]
Event wire form: [type, kv, prev_kv-or-null]

Design notes:
- One reader thread per client demuxes RPC replies (by id) and watch
  events (by wid).  Calls are synchronous RPCs; any thread may call.
- Watch pushes are BATCHED: one pump thread per connection drains every
  ready watcher per wakeup and ships one {"w", "evs"} frame per watcher
  (one sendall for the whole wakeup) — a dispatch burst of K events
  costs a handful of wire frames, not K serialized lines.  Clients
  accept both the batched and the legacy single-event form.
- Leases live server-side and expire by TTL whether or not the client is
  connected — exactly etcd's behaviour, and what node-death detection
  relies on (noticer.go:172-200).  A dropped connection closes its
  watches but never its leases.
- ``put_many`` batches order publication into one round trip (the
  scheduler's dispatch plane writes whole windows at once).
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import log
from ..chaos.hooks import hooks as _chaos
from ..core.backoff import RECONNECT
from .memstore import CompactedError, DELETE, LossyEventStream, PUT, \
    Event, KV, MemStore, WatchLost, Watcher
from .wire import LineJsonHandler


def _kv_wire(kv: Optional[KV]):
    if kv is None:
        return None
    return [kv.key, kv.value, kv.create_rev, kv.mod_rev, kv.lease]


def _kv_unwire(w) -> Optional[KV]:
    if w is None:
        return None
    return KV(key=w[0], value=w[1], create_rev=w[2], mod_rev=w[3],
              lease=w[4])


def _ev_wire(ev: Event):
    return [ev.type, _kv_wire(ev.kv), _kv_wire(ev.prev_kv)]


def _ev_unwire(w) -> Event:
    return Event(type=w[0], kv=_kv_unwire(w[1]), prev_kv=_kv_unwire(w[2]))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

_OPS = ("put", "put_many", "get", "get_many", "get_prefix",
        "get_prefix_page", "count_prefix", "delete",
        "delete_prefix", "delete_many", "put_if_absent", "put_if_mod_rev",
        "claim", "claim_many", "claim_bundle", "claim_bundle_many",
        "grant", "keepalive", "revoke", "lease_ttl_remaining", "op_stats",
        "snapshot", "rev")

# ops a replica-group FOLLOWER refuses (leases and fences are granted
# only by the leader — the replication plane's exactly-once contract);
# under --repl-ack quorum these also wait for >= 1 follower ack before
# the success reply goes out
_MUTATING = frozenset({
    "put", "put_many", "delete", "delete_prefix", "delete_many",
    "put_if_absent", "put_if_mod_rev", "claim", "claim_many",
    "claim_bundle", "claim_bundle_many", "grant", "keepalive", "revoke"})


class _Conn(LineJsonHandler):
    def setup(self):
        super().setup()
        # register with the owning server so stop()/kill() can sever
        # established connections (handler threads are daemonic: without
        # this a "stopped" server keeps serving its open sockets, which
        # makes a killed replica leader look alive to its followers)
        conns = getattr(self.server, "conns", None)
        if conns is not None:
            with self.server.conns_lock:     # type: ignore[attr-defined]
                conns.add(self)
        self.watchers: Dict[int, Watcher] = {}
        # one BATCHING pump per connection (not a thread per watcher):
        # watchers signal readiness here; the pump drains every ready
        # stream per wakeup and ships one {"w", "evs"} frame per watcher
        # in a single send
        self._ready: "queue.Queue[int]" = queue.Queue()
        self._pump_thread: Optional[threading.Thread] = None

    # per-send coalescing cap (the native writer uses the same bound): a
    # catch-up replay or expiry burst of 100k events must not serialize
    # into one multi-MB buffer while holding the write lock — RPC
    # replies on this connection would stall behind the whole send
    SEND_CHUNK = 256 << 10

    def _send_batch(self, objs):
        buf = bytearray()
        for o in objs:
            buf += (json.dumps(o, separators=(",", ":")) + "\n").encode()
            if len(buf) >= self.SEND_CHUNK:
                self._send_bytes(bytes(buf))
                buf.clear()
        if buf:
            self._send_bytes(bytes(buf))

    def _send_bytes(self, data: bytes):
        with self.wlock:
            try:
                self.request.sendall(data)
            except OSError:
                self.alive = False

    def _pump(self):
        """Forward every watcher's events to the client until the
        connection dies: per wakeup, drain ALL ready watchers and ship
        one batched frame per watcher.  A slow-consumer cancellation
        propagates as a lost notification so the client can re-list +
        re-watch instead of starving silently."""
        store: MemStore = self.server.store      # type: ignore[attr-defined]
        while self.alive:
            try:
                wids = {self._ready.get(timeout=0.25)}
            except queue.Empty:
                continue
            while True:                     # coalesce the whole wakeup
                try:
                    wids.add(self._ready.get_nowait())
                except queue.Empty:
                    break
            frames = []
            nev = 0
            for wid in wids:
                w = self.watchers.get(wid)
                if w is None:
                    continue
                try:
                    evs = w.drain()
                except WatchLost:
                    frames.append({"w": wid, "lost": True})
                    self.watchers.pop(wid, None)
                    continue
                if evs:
                    # bounded frames: a catch-up replay can drain tens
                    # of thousands of events in one wakeup — ship them
                    # as a few capped frames, not one giant line
                    for i in range(0, len(evs), 2048):
                        chunk = evs[i:i + 2048]
                        frames.append(
                            {"w": wid,
                             "evs": [_ev_wire(e) for e in chunk]})
                    nev += len(evs)
                if w.lost:
                    # the buffered tail is out; come back for the
                    # WatchLost -> lost frame on the next wakeup
                    self._ready.put(wid)
            if frames:
                self._send_batch(frames)
                store.op_count("watch_frames", len(frames))
                if nev:
                    store.op_count("watch_events", nev)

    def dispatch(self, rid, op, args):
        store: MemStore = self.server.store      # type: ignore[attr-defined]
        try:
            if op == "watch":
                prefix, start_rev = args[0], args[1]
                events = args[2] if len(args) > 2 else ""
                w = store.watch(prefix, start_rev=start_rev or 0,
                                events=events)
                wid = rid
                self.watchers[wid] = w
                w.on_ready = lambda _w, q=self._ready, i=wid: q.put(i)
                if self._pump_thread is None:
                    self._pump_thread = threading.Thread(
                        target=self._pump, daemon=True,
                        name="store-pump")
                    self._pump_thread.start()
                # the start_rev replay filled the queue BEFORE on_ready
                # was attached: nudge the pump once unconditionally
                self._ready.put(wid)
                self._send({"i": rid, "r": wid})
            elif op == "unwatch":
                w = self.watchers.pop(args[0], None)
                if w:
                    w.close()
                self._send({"i": rid, "r": True})
            elif op == "repl_status":
                mgr = getattr(self.server, "repl", None)
                self._send({"i": rid, "r": {"enabled": False}
                            if mgr is None else mgr.status()})
            elif op in ("repl_hello", "repl_pull", "repl_ack",
                        "repl_snapshot"):
                mgr = getattr(self.server, "repl", None)
                if mgr is None:
                    self._send({"i": rid, "e": f"{op}: replication "
                                "disabled on this server",
                                "k": "RuntimeError"})
                else:
                    fn = {"repl_hello": mgr.hello,
                          "repl_pull": mgr.pull,
                          "repl_ack": mgr.ack,
                          "repl_snapshot": mgr.snapshot_dump}[op]
                    self._send({"i": rid, "r": fn(*args)})
            elif op in _OPS:
                mgr = getattr(self.server, "repl", None)
                mutating = mgr is not None and op in _MUTATING
                if mutating and mgr.role() != "leader":
                    # leases/fences/writes are the LEADER's alone: the
                    # client rotates to the leader on this error
                    raise NotLeaderError(
                        f"{op}: this replica is a follower")
                r = getattr(store, op)(*args)
                if op == "get":
                    r = _kv_wire(r)
                elif op in ("get_prefix", "get_prefix_page", "get_many"):
                    r = [_kv_wire(kv) for kv in r]
                if mutating and mgr.ack_mode == "quorum":
                    # durability before the ack: the reply waits until
                    # >= 1 follower's cursor covers this op's records.
                    # On timeout the op is applied locally but reported
                    # FAILED under the DISTINCT QuorumTimeout kind —
                    # clients must not blindly retry (grant is not
                    # idempotent; put/delete double-bump the revision),
                    # but a failover cannot lose a write we never
                    # acked.
                    seq = mgr.log.seq
                    if not mgr.ack_wait(seq):
                        self._send({
                            "i": rid,
                            "e": f"{op}: applied locally but no "
                                 f"follower ack of seq {seq} within "
                                 f"{mgr.ack_timeout}s (quorum mode)",
                            "k": "QuorumTimeout"})
                        return
                self._send({"i": rid, "r": r})
            else:
                self._send({"i": rid, "e": f"unknown op {op!r}",
                            "k": "ValueError"})
        except NotLeaderError as e:
            self._send({"i": rid, "e": str(e), "k": "NotLeader"})
        except KeyError as e:
            self._send({"i": rid, "e": str(e), "k": "KeyError"})
        except CompactedError as e:
            self._send({"i": rid, "e": str(e), "k": "CompactedError"})
        except WatchLost as e:
            self._send({"i": rid, "e": str(e), "k": "WatchLost"})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            self._send({"i": rid, "e": f"{type(e).__name__}: {e}",
                        "k": "RuntimeError"})

    def finish(self):
        super().finish()    # retire the handshake watchdog (wire.py)
        self.alive = False
        conns = getattr(self.server, "conns", None)
        if conns is not None:
            with self.server.conns_lock:     # type: ignore[attr-defined]
                conns.discard(self)
        # snapshot: the pump thread pops lost watchers concurrently
        for w in list(self.watchers.values()):
            w.close()
        self.watchers.clear()


class StoreServer:
    """Serve a MemStore over TCP.  ``addr`` like ("127.0.0.1", 7070);
    port 0 picks a free port (see :attr:`port`)."""

    def __init__(self, store: Optional[MemStore] = None,
                 host: str = "127.0.0.1", port: int = 0, token: str = "",
                 sslctx=None):
        self.store = store or MemStore()
        self.store.start_sweeper()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self._srv = _Server((host, port), _Conn)
        self._srv.conns = set()                      # type: ignore[attr-defined]
        self._srv.conns_lock = threading.Lock()      # type: ignore[attr-defined]
        self._srv.store = self.store                 # type: ignore[attr-defined]
        self._srv.token = token                      # type: ignore[attr-defined]
        self._srv.sslctx = sslctx                    # type: ignore[attr-defined]
        self._srv.repl = None                        # type: ignore[attr-defined]
        self.repl = None
        self.host, self.port = self._srv.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def attach_repl(self, mgr) -> "StoreServer":
        """Wire a repl.ReplManager into the dispatch plane: repl_* ops
        answer, followers refuse mutations, quorum ack gates replies.
        Attach before serving clients."""
        self.repl = mgr
        self._srv.repl = mgr                         # type: ignore[attr-defined]
        return self

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="store-server")
        self._thread.start()
        return self

    def _sever_conns(self):
        with self._srv.conns_lock:           # type: ignore[attr-defined]
            conns = list(self._srv.conns)    # type: ignore[attr-defined]
        for c in conns:
            c.alive = False
            try:
                c.request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.request.close()
            except OSError:
                pass

    def stop(self):
        if self.repl is not None:
            self.repl.stop()
        self._srv.shutdown()
        self._srv.server_close()
        self._sever_conns()
        if self._thread:
            self._thread.join(timeout=3)
        self.store.close()

    def kill(self):
        """Hard-kill (the in-process kill -9): stop accepting, sever
        every established connection mid-flight, and abandon the store
        WITHOUT closing it — no flush, no sweeper shutdown handshake,
        no repl goodbye.  Followers see their pull connections die
        exactly as they would for a dead process; the chaos drills'
        leader-kill is built on this."""
        if self.repl is not None:
            self.repl._stop.set()     # silence the loop; no demote/ack
        self._srv.shutdown()
        self._srv.server_close()
        self._sever_conns()
        if self._thread:
            self._thread.join(timeout=3)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RemoteWatcher(LossyEventStream):
    """Client-side watch stream; same surface (and WatchLost contract,
    via the shared LossyEventStream base) as memstore.Watcher."""

    def __init__(self, store: "RemoteStore", wid: int, prefix: str,
                 start_rev: int = 0, events: str = ""):
        super().__init__(prefix)
        self._store = store
        self._wid = wid
        self.start_rev = start_rev
        self.events = events       # "" all / "delete" only (re-watch too)
        self.last_rev = 0          # highest mod_rev seen (resume point)

    def _emit(self, ev: Event):
        if not self._closed:
            if ev.kv.mod_rev > self.last_rev:
                self.last_rev = ev.kv.mod_rev
            self._q.put(ev)

    def _mark_lost(self):
        """Server cancelled this stream (slow consumer): same WatchLost
        contract as the in-process Watcher."""
        self.lost = True
        self._closed = True
        self._store._watchers.pop(self._wid, None)
        self._q.put(None)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._store._unwatch(self._wid)
        self._q.put(None)


class RemoteStoreError(RuntimeError):
    pass


class NotLeaderError(RemoteStoreError):
    """The targeted replica is a follower: leases, fences, and writes
    belong to its group's leader (replication plane).  Replica-group
    clients rotate to the leader on this error."""


class QuorumTimeoutError(RemoteStoreError):
    """A ``--repl-ack quorum`` write was APPLIED on the leader but no
    follower acked it within the window — it is live locally and will
    ship when a follower catches up, it is just not known replicated.
    Distinct from a generic failure because a blind retry DOUBLE-
    APPLIES non-idempotent ops (``grant`` allocates a second lease;
    put/delete bump the revision and fire watch events twice):
    replica-group clients surface this instead of rotating, and the
    caller decides — re-read before re-granting, treat an idempotent
    overwrite as acceptable, or wait for the follower to rejoin."""


class RemoteStore:
    """TCP client with MemStore's exact API — scheduler/agent/web/noticer
    run unchanged against it (the rebuild's etcd clientv3,
    client.go:24-114).

    Self-healing: a dropped connection fails in-flight calls (callers see
    :class:`RemoteStoreError` and retry at their own cadence), then a
    background loop reconnects with backoff and re-establishes every open
    watch from its last seen revision — replaying the missed deltas.  If
    the server has compacted past that revision the watch resumes from
    the current revision and the gap is logged (callers that need
    completeness re-list, exactly like an etcd client)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 reconnect: bool = True, token: str = "", sslctx=None,
                 tls_hostname: str = ""):
        self.host, self.port = host, port
        self._timeout = timeout
        self._reconnect = reconnect
        self._token = token
        self._sslctx = sslctx
        self._tls_hostname = tls_hostname
        self._wlock = threading.Lock()
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._pending: Dict[int, dict] = {}
        self._pending_ev: Dict[int, threading.Event] = {}
        self._watchers: Dict[int, RemoteWatcher] = {}
        self._closed = False
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        # optional hook for replica-group clients (reconnect=False):
        # called once, with this store, when the connection dies
        # UNEXPECTEDLY — the group wrapper marks live watchers lost so
        # their consumers re-list through a freshly discovered leader
        # instead of starving on a closed-but-not-lost stream
        self.on_disconnect = None
        self._connect()

    # -- plumbing ----------------------------------------------------------

    def _connect(self):
        sock = socket.create_connection((self.host, self.port), timeout=30)
        if self._sslctx is not None:
            from ..tlsutil import wrap_client
            sock = wrap_client(sock, self._sslctx, self._tls_hostname)
        sock.settimeout(None)
        rfile = sock.makefile("rb")
        if self._sslctx is not None:
            # First round trip runs SYNCHRONOUSLY, before the reader
            # thread exists.  An OpenSSL connection is not a thread-safe
            # object, and right after the handshake the post-handshake
            # records (TLS 1.3 NewSessionTicket) are processed inside
            # the connection's first SSL_read — a concurrent SSL_write
            # from the calling thread raced that read and intermittently
            # swallowed the first frame, which surfaced as the server's
            # auth-timeout watchdog severing an apparently-healthy
            # connection ~10 s in (the test_tls flake: first-rpc
            # failures on fresh TLS connections under repetition).  One
            # synchronous auth round trip drains those records single-
            # threaded; afterwards the usual one-reader + serialized-
            # writers discipline holds.
            self._handshake_rpc(sock, rfile)
            threading.Thread(target=self._read_loop, args=(sock, rfile),
                             daemon=True,
                             name="remote-store-reader").start()
        else:
            threading.Thread(target=self._read_loop, args=(sock, rfile),
                             daemon=True,
                             name="remote-store-reader").start()
            if self._token:
                # authenticate BEFORE publishing the socket: a
                # concurrent _call sending ahead of the handshake would
                # hit the server's first-frame-must-auth rule and get
                # the fresh connection closed under us (reconnect churn
                # on every heal)
                self._call("auth", self._token, sock_override=sock)
        self._sock = sock
        self._rfile = rfile

    def _handshake_rpc(self, sock, rfile):
        """One blocking auth round trip on the freshly wrapped TLS
        socket (no reader thread yet; open servers answer the auth op
        as a no-op, so this doubles as the post-handshake drain)."""
        data = (json.dumps({"i": 0, "o": "auth",
                            "a": [self._token] if self._token else [""]},
                           separators=(",", ":")) + "\n").encode()
        sock.settimeout(self._timeout)
        try:
            sock.sendall(data)
            line = rfile.readline()
        except OSError as e:
            raise RemoteStoreError(f"tls handshake rpc failed: {e}")
        finally:
            sock.settimeout(None)
        if not line:
            raise RemoteStoreError(
                "connection closed during handshake rpc")
        try:
            msg = json.loads(line)
        except ValueError:
            raise RemoteStoreError("malformed handshake rpc reply")
        if "e" in msg:
            raise RemoteStoreError(msg["e"])

    def _read_loop(self, sock, rfile):
        while not self._closed:
            try:
                line = rfile.readline()
            except OSError:
                break
            if not line:
                break
            try:
                msg = json.loads(line)
            except ValueError:   # JSONDecodeError or UnicodeDecodeError
                continue         # (binary garbage: TLS alert bytes from a
                                 # mis-dialed TLS server, line noise)
            if "w" in msg:
                w = self._watchers.get(msg["w"])
                if w is not None:
                    if msg.get("lost"):
                        w._mark_lost()
                    elif "evs" in msg:       # batched push (one frame,
                        for e in msg["evs"]:  # many events)
                            w._emit(_ev_unwire(e))
                    else:                    # legacy single-event push
                        w._emit(_ev_unwire(msg["ev"]))
                continue
            rid = msg.get("i")
            ev = self._pending_ev.get(rid)
            if ev is not None:
                self._pending[rid] = msg
                ev.set()
        # connection gone: unpublish the socket FIRST (new calls fail
        # fast instead of sendall-ing into a dead TCP buffer and waiting
        # out the full rpc timeout with no reader left to fail them),
        # then fail in-flight calls
        if self._sock is sock:
            self._sock = None
        for rid, ev in list(self._pending_ev.items()):
            self._pending.setdefault(rid, {"e": "connection closed",
                                           "k": "RemoteStoreError"})
            ev.set()
        if self._closed or not self._reconnect:
            unexpected = not self._closed
            self._finalize()
            if unexpected:
                cb = self.on_disconnect
                if cb is not None:
                    try:
                        cb(self)
                    except Exception:  # noqa: BLE001 — reader must die
                        pass           # clean regardless of the hook
            return
        threading.Thread(target=self._heal, daemon=True,
                         name="remote-store-heal").start()

    def _finalize(self):
        self._closed = True
        for w in list(self._watchers.values()):
            w._closed = True
            w._q.put(None)

    def _heal(self):
        attempt = 0
        while not self._closed:
            try:
                self._connect()
                break
            except (OSError, RemoteStoreError) as e:
                # RemoteStoreError here is an auth refusal on the fresh
                # connection (server restarted with a new token?) — keep
                # retrying with backoff rather than dying silently
                if isinstance(e, RemoteStoreError):
                    log.errorf("store reconnect refused: %s", e)
                attempt += 1
                RECONNECT.sleep(attempt)   # 0.2 s doubling, 2 s cap
        if self._closed:
            self._finalize()
            return
        # re-establish watches, resuming after the last delivered event
        for wid, w in list(self._watchers.items()):
            if w._closed:
                continue
            resume = w.last_rev + 1 if w.last_rev else 0
            try:
                try:
                    self._call("watch", w.prefix, resume, w.events,
                               rid=wid)
                except (CompactedError, WatchLost):
                    # the gap is unrecoverable: deltas are gone.  Don't
                    # silently re-watch from current — surface WatchLost
                    # so the consumer re-lists (anti-entropy), exactly
                    # like the slow-consumer cancellation path.
                    log.warnf("watch %r resume rev %d compacted; "
                              "consumer must re-list", w.prefix, resume)
                    w._mark_lost()
            except Exception as e:  # noqa: BLE001 — ANY re-establish
                # failure (timeout, refused, reply lost, unexpected)
                # leaves this stream NOT live: mark it LOST so the
                # consumer re-lists, exactly like the compacted-resume
                # path.  Logging alone left a silently dead watcher —
                # an agent's dispatch stream starved with no signal
                # until its leased orders expired (found by the
                # shard_partition drill once per-shard publish lanes
                # shifted the heal's timing).
                log.errorf("watch %r re-establish failed (%s); marking "
                           "LOST for consumer re-list", w.prefix, e)
                w._mark_lost()
        log.infof("store connection re-established (%s:%d)",
                  self.host, self.port)

    def _call(self, op: str, *args, rid: Optional[int] = None,
              sock_override=None):
        if self._closed:
            raise RemoteStoreError("store connection closed")
        # deterministic fault injection (chaos plane, env-gated off in
        # production): a 'timeout' fault fails the RPC before anything
        # reaches the wire; a 'reply_lost' fault lets the op APPLY
        # server-side and fails the reply path — the
        # applied-but-indeterminate shape every degraded ladder must
        # survive; a 'delay' fault stalls the caller (browned-out wire)
        act = _chaos.intercept("store.rpc", op) if _chaos.armed else None
        if act is not None:
            act.pre(RemoteStoreError, op)
        if rid is None:
            with self._id_lock:
                rid = self._next_id
                self._next_id += 1
        done = threading.Event()
        self._pending_ev[rid] = done
        data = (json.dumps({"i": rid, "o": op, "a": list(args)},
                           separators=(",", ":")) + "\n").encode()
        try:
            sock = sock_override or self._sock
            if sock is None:
                raise RemoteStoreError("store disconnected")
            try:
                with self._wlock:
                    sock.sendall(data)
            except OSError as e:
                raise RemoteStoreError(f"send failed: {e}")
            if self._sock is not sock and sock_override is None \
                    and not done.is_set():
                # the connection died between our socket read and the
                # send: its reader's in-flight sweep ran before this rid
                # registered a reply could reach, so nobody will ever
                # fail it — a sendall into the dead socket's buffer
                # "succeeds" and would wait out the whole rpc timeout
                raise RemoteStoreError("connection lost mid-call")
            if not done.wait(self._timeout):
                raise RemoteStoreError(f"rpc timeout: {op}")
            msg = self._pending.pop(rid, None)
            if msg is None:
                # the reply vanished between done.set and this pop: a
                # FIXED-rid call (the heal path re-watches with
                # rid=wid) can collide with a previous attempt's
                # timed-out call on the same rid — its finally clause
                # sweeps _pending[rid] from under us.  A failed RPC,
                # never a local KeyError crashing the caller (a crashed
                # heal thread used to leave every remaining watcher
                # silently dead).
                raise RemoteStoreError(f"rpc reply lost: {op}")
        finally:
            self._pending_ev.pop(rid, None)
            self._pending.pop(rid, None)
        if "e" in msg:
            kind = msg.get("k")
            if kind == "KeyError":
                raise KeyError(msg["e"])
            if kind == "CompactedError":
                raise CompactedError(msg["e"])
            if kind == "WatchLost":
                raise WatchLost(msg["e"])
            if kind == "NotLeader":
                raise NotLeaderError(msg["e"])
            if kind == "QuorumTimeout":
                raise QuorumTimeoutError(msg["e"])
            raise RemoteStoreError(msg["e"])
        if act is not None:
            act.post(RemoteStoreError, op)   # applied; reply "lost"
        return msg.get("r")

    # -- KV ----------------------------------------------------------------

    def put(self, key: str, value: str, lease: int = 0) -> int:
        return self._call("put", key, value, lease)

    def put_many(self, items, lease: int = 0) -> int:
        return self._call("put_many", list(items), lease)

    def get(self, key: str) -> Optional[KV]:
        return _kv_unwire(self._call("get", key))

    def get_many(self, keys) -> List[Optional[KV]]:
        return [_kv_unwire(w) for w in self._call("get_many", list(keys))]

    def get_prefix(self, prefix: str) -> List[KV]:
        return [_kv_unwire(w) for w in self._call("get_prefix", prefix)]

    def get_prefix_page(self, prefix: str, start_after: str = "",
                        limit: int = 50_000) -> List[KV]:
        return [_kv_unwire(w) for w in self._call(
            "get_prefix_page", prefix, start_after, limit)]

    def get_prefix_paged(self, prefix: str, page: int = 50_000):
        """Iterate a prefix in bounded pages.  A 1M-key prefix as ONE
        get_prefix reply is a multi-hundred-MB line whose json parse
        holds the GIL for seconds (starving every other thread in the
        process — measured on the scheduler's anti-entropy listings);
        paging bounds the reply, the parse slice, and peak memory.
        Falls back to one-shot get_prefix on servers predating the op.
        Pages are individually consistent; the full iteration has the
        usual range-pagination read skew."""
        page = max(1, page)     # servers clamp to >= 1; an unclamped 0
        start_after = ""        # here would never satisfy len < page
        while True:
            try:
                kvs = self.get_prefix_page(prefix, start_after, page)
            except RemoteStoreError as e:
                if "unknown op" in str(e) and not start_after:
                    yield from self.get_prefix(prefix)
                    return
                raise
            yield from kvs
            if len(kvs) < page:
                return
            start_after = kvs[-1].key

    def count_prefix(self, prefix: str) -> int:
        return self._call("count_prefix", prefix)

    def delete(self, key: str) -> bool:
        return self._call("delete", key)

    def delete_prefix(self, prefix: str) -> int:
        return self._call("delete_prefix", prefix)

    def delete_many(self, keys) -> int:
        return self._call("delete_many", list(keys))

    # -- txns --------------------------------------------------------------

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        return self._call("put_if_absent", key, value, lease)

    def put_if_mod_rev(self, key: str, value: str, mod_rev: int,
                       lease: int = 0) -> bool:
        return self._call("put_if_mod_rev", key, value, mod_rev, lease)

    def claim(self, fence_key: str, fence_val: str, fence_lease: int = 0,
              order_key: str = "", proc_key: str = "", proc_val: str = "",
              proc_lease: int = 0) -> bool:
        """Atomic fence+proc+order-consume (memstore.claim) in ONE round
        trip — the dispatch plane's per-execution hot op."""
        return self._call("claim", fence_key, fence_val, fence_lease,
                          order_key, proc_key, proc_val, proc_lease)

    def claim_many(self, items, fence_lease: int = 0,
                   proc_lease: int = 0) -> List[bool]:
        """Batched claim (memstore.claim_many): one round trip for a
        whole burst of due executions."""
        return self._call("claim_many", [list(it) for it in items],
                          fence_lease, proc_lease)

    def claim_bundle(self, order_key: str, items, fence_lease: int = 0,
                     proc_lease: int = 0) -> List[bool]:
        """Coalesced-order consume (memstore.claim_bundle): the whole
        (node, second) bundle — per-job fences, winners' proc keys, and
        the single reservation-key delete — in ONE round trip."""
        return self._call("claim_bundle", order_key,
                          [list(it) for it in items],
                          fence_lease, proc_lease)

    def claim_bundle_many(self, bundles, fence_lease: int = 0,
                          proc_lease: int = 0) -> List[List[bool]]:
        """Batched claim_bundle (memstore.claim_bundle_many): a whole
        backlog of due (node, second) bundles — the herd catch-up case —
        settled in ONE round trip.  ``bundles`` is
        [(order_key, items), ...]."""
        return self._call(
            "claim_bundle_many",
            [[ok, [list(it) for it in items]] for ok, items in bundles],
            fence_lease, proc_lease)

    def op_stats(self) -> dict:
        """Server-side per-op timing snapshot (memstore.op_stats)."""
        return self._call("op_stats")

    def snapshot(self) -> int:
        """Checkpoint plane: write a consistent point-in-time snapshot
        of the server's keyspace + lease table and truncate its WAL
        (memstore.snapshot / stored.cc snapshot).  Returns the
        snapshot's revision; errors if the server runs without a WAL."""
        return self._call("snapshot")

    def rev(self) -> int:
        """Current store revision (memstore.rev)."""
        return self._call("rev")

    def repl_status(self) -> dict:
        """Replication-plane status of this server: ``{"enabled":
        False}`` on unreplicated servers, else role / fencing epoch /
        cursor / applied revision / lag (repl.ReplManager.status)."""
        return self._call("repl_status")

    # -- leases ------------------------------------------------------------

    def grant(self, ttl: float) -> int:
        return self._call("grant", ttl)

    def keepalive(self, lease_id: int) -> bool:
        return self._call("keepalive", lease_id)

    def revoke(self, lease_id: int) -> bool:
        return self._call("revoke", lease_id)

    def lease_ttl_remaining(self, lease_id: int) -> Optional[float]:
        return self._call("lease_ttl_remaining", lease_id)

    # -- watch -------------------------------------------------------------

    def watch(self, prefix: str, start_rev: int = 0,
              events: str = "") -> RemoteWatcher:
        with self._id_lock:
            wid = self._next_id          # reserve the id we'll rpc with
            self._next_id += 1
        # register the watcher BEFORE the rpc returns so no event races
        # past the registration (the server keys pushes by the request id)
        w = RemoteWatcher(self, wid, prefix, start_rev, events)
        self._watchers[wid] = w
        try:
            self._call("watch", prefix, start_rev, events, rid=wid)
        except Exception:
            self._watchers.pop(wid, None)
            raise
        return w

    def _unwatch(self, wid: int):
        self._watchers.pop(wid, None)
        if not self._closed:
            try:
                self._call("unwatch", wid)
            except (RemoteStoreError, KeyError):
                pass

    def clone(self) -> "RemoteStore":
        """A fresh connection to the same server with the same auth/TLS
        — publisher lanes shard bulk writes over several of these."""
        return RemoteStore(self.host, self.port, timeout=self._timeout,
                          reconnect=self._reconnect, token=self._token,
                          sslctx=self._sslctx,
                          tls_hostname=self._tls_hostname)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._closed = True
        sock = self._sock      # may be None mid-heal
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()

    # MemStore compat no-op: the server owns the sweeper
    def start_sweeper(self, interval: float = 0.2):
        pass
