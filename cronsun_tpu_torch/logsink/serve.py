"""Networked result store: JobLogStore served over TCP.

The reference's execution logs, latest-log, stats, node-liveness mirror
and accounts live in MongoDB — a networked multi-host store every node
writes and the web server reads (the reference's db/mgo.go:24-49,
job_log.go:84-133).  The rebuild's equivalent: :class:`LogSinkServer`
exposes a JobLogStore (SQLite, WAL) over the same line-JSON transport
the coordination store uses, and :class:`RemoteJobLogStore` is a client
with the identical Python surface — agent, web server and noticer run
unchanged against either, and processes on different machines share one
result store the way the reference's share one Mongo.

Wire protocol (one JSON object per line, UTF-8):

    client -> server   {"i": <id>, "o": <op>, "a": [args...]}
    server -> client   {"i": <id>, "r": <result>}        (ok)
                       {"i": <id>, "e": <msg>}           (error)

LogRecord wire form: plain dict of its dataclass fields.

Authentication: when the server is started with a ``token``, the first
request on every connection must be ``{"i":0,"o":"auth","a":[token]}``;
anything else (or a wrong token) closes the connection.  The reference
carries Mongo credentials through config the same way
(the reference's db/mgo.go:33-36).

Copy of ``cronsun_tpu/logsink/serve.py``; the only difference: the
reference's source is cited by its own paths.
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading
import uuid
from collections import deque
from typing import List, Optional, Tuple

from .. import log
from ..chaos.hooks import hooks as _chaos
from ..store.wire import LineJsonHandler
from .joblog import JobLogStore, LogRecord, SubscriptionLost

# ops dispatched 1:1 onto the JobLogStore surface (auth + create_job_log
# + query_logs + tail_snapshot get special marshalling)
_PLAIN_OPS = ("get_log", "stat_overall", "stat_day", "stat_days",
              "upsert_node", "set_node_alived", "get_nodes", "get_node",
              "upsert_account", "get_account", "list_accounts",
              "delete_account", "op_stats", "revision", "logmap",
              "age_out", "tier_info",
              "trace_get", "trace_top", "trace_stats")


def _rec_wire(rec: Optional[LogRecord]):
    # dict(__dict__), not dataclasses.asdict: asdict routes through the
    # recursive deep-copy machinery (~10x slower) and a latest-view
    # reply marshals 500+ records per dashboard poll; field order (and
    # so the wire bytes) is identical — __dict__ fills in declaration
    # order
    return None if rec is None else dict(rec.__dict__)


def _rec_unwire(w) -> Optional[LogRecord]:
    # positional construction — a latest reply carries 500+ records and
    # LogRecord(**w) pays the keyword-matching path per row
    return None if w is None else LogRecord(
        w["job_id"], w["job_group"], w["name"], w["node"], w["user"],
        w["command"], w["output"], w["success"], w["begin_ts"],
        w["end_ts"], w["id"])


class _Conn(LineJsonHandler):
    # Wire form of the change stream (see JobLogStore.subscribe): the
    # ``subscribe`` op acks {"rev": R, "lost": gap?} on the request id,
    # then the server pushes frames on the SAME connection —
    #   {"s": <rid>, "evs": [[id, job_id, job_group, name, node,
    #                         success, begin_ts, end_ts], ...]}
    # in id order, and {"s": <rid>, "lost": true} once the bounded
    # buffer overflowed (after which the subscription is dead and the
    # consumer re-lists + re-subscribes).  Both backends pin the same
    # frames byte-for-byte-compatibly.

    def setup(self):
        super().setup()
        # per-connection change-stream state: subscriptions opened on
        # this connection and the pump thread that writes their frames
        # (lazy — request/response-only connections never pay a thread)
        self._subs: dict = {}
        self._sub_ready: "queue.Queue" = queue.Queue()
        self._pump: Optional[threading.Thread] = None

    def finish(self):
        for sub in list(self._subs.values()):
            sub.close()
        self._subs.clear()
        if self._pump is not None:
            self._sub_ready.put(None)
        super().finish()

    def _subscribe(self, sink, rid, after_id, cap):
        sub = sink.subscribe(after_id=after_id, cap=cap)
        # ack FIRST, then arm the pump: events landing in between just
        # buffer in the subscription, and the nudge below flushes them —
        # so the client always reads the ack before any frame
        self._send({"i": rid, "r": {"rev": sub.rev,
                                    "lost": bool(sub.gap)}})
        sid = int(rid)
        self._subs[sid] = sub
        if self._pump is None:
            self._pump = threading.Thread(target=self._sub_pump,
                                          daemon=True,
                                          name="logsink-sub-pump")
            self._pump.start()
        sub.on_ready = lambda _s, q=self._sub_ready, i=sid: q.put(i)
        self._sub_ready.put(sid)

    def _sub_pump(self):
        while self.alive:
            sid = self._sub_ready.get()
            if sid is None:
                return
            sub = self._subs.get(sid)
            if sub is None:
                continue
            try:
                evs = sub.drain()
            except SubscriptionLost:
                self._send_raw('{"s":%d,"lost":true}\n' % sid)
                self._subs.pop(sid, None)
                sub.close()
                continue
            for i in range(0, len(evs), 2048):
                self._send_raw(json.dumps(
                    {"s": sid, "evs": evs[i:i + 2048]},
                    separators=(",", ":")) + "\n")

    def _send_raw(self, line: str):
        data = line.encode()
        with self.wlock:
            try:
                self.request.sendall(data)
            except OSError:
                self.alive = False

    def _latest_reply_cached(self, sink, rid, kw) -> bool:
        """Serialized-reply memo for the latest view, keyed on the
        sink's revision (the web cache's idea one level down): a
        dashboard fleet polling between write batches reuses the
        MARSHALLED bytes — no row copies, no dict building, no
        json.dumps of 500 records per poll.  Sound for the same reason
        the web cache is: the revision is read BEFORE computing, so a
        write racing the compute bumps it and the entry can never
        satisfy a later poll.  Only engaged on tiered sinks (revision
        there is a mirror read, not a SQL query).  Returns True when
        it handled the request."""
        if not kw.get("latest") or not getattr(sink, "_tier", False):
            return False
        try:
            rev = sink.revision()
        except Exception:  # noqa: BLE001 — fall back to the plain path
            return False
        key = json.dumps(kw, sort_keys=True)
        cache = self.server.reply_cache           # type: ignore[attr-defined]
        lock = self.server.reply_lock             # type: ignore[attr-defined]
        with lock:
            ent = cache.get(key)
            payload = ent[1] if ent and ent[0] == rev else None
        if payload is not None:
            sink.op_count("q_latest_memo")   # served from marshalled bytes
        else:
            recs, total = sink.query_logs(**kw)
            payload = json.dumps(
                {"total": total, "list": [_rec_wire(r) for r in recs]},
                separators=(",", ":"))
            with lock:
                cache[key] = (rev, payload)
                while len(cache) > 64:
                    cache.pop(next(iter(cache)))
        self._send_raw('{"i":%d,"r":%s}\n' % (rid, payload))
        return True

    def dispatch(self, rid, op, args):
        sink: JobLogStore = self.server.sink      # type: ignore[attr-defined]
        try:
            if op == "create_job_log":
                self._send({"i": rid,
                            "r": self._create(sink, args[0],
                                              args[1] if len(args) > 1
                                              else None)})
            elif op == "create_job_logs":
                self._send({"i": rid,
                            "r": self._create_bulk(
                                sink, args[0],
                                args[1] if len(args) > 1 else None,
                                args[2] if len(args) > 2 else None)})
            elif op == "query_logs":
                if not self._latest_reply_cached(sink, rid, args[0]):
                    recs, total = sink.query_logs(**args[0])
                    self._send({"i": rid, "r": {
                        "total": total,
                        "list": [_rec_wire(r) for r in recs]}})
            elif op == "tail_snapshot":
                rev, recs = sink.tail_snapshot(args[0] if args else 0)
                self._send({"i": rid, "r": {
                    "revision": rev,
                    "list": [_rec_wire(r) for r in recs]}})
            elif op == "subscribe":
                self._subscribe(sink, rid,
                                int(args[0]) if args else 0,
                                int(args[1]) if len(args) > 1 else 4096)
            elif op == "unsubscribe":
                sub = self._subs.pop(int(args[0]), None)
                if sub is not None:
                    sub.close()
                self._send({"i": rid, "r": sub is not None})
            elif op in _PLAIN_OPS:
                r = getattr(sink, op)(*args)
                if op == "get_log":
                    r = _rec_wire(r)
                self._send({"i": rid, "r": r})
            else:
                self._send({"i": rid, "e": f"unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            self._send({"i": rid, "e": f"{type(e).__name__}: {e}"})

    def _idempotent(self, idem, thunk):
        """Run ``thunk()`` at most once per idempotency token.  The token
        is RESERVED before the write — a concurrent retry of the same
        token latches onto the original attempt instead of racing it —
        and replays return the original result.  A failed attempt
        withdraws its reservation so a later retry can re-race; a waiter
        that times out (pathologically slow owner) re-races too.  Shared
        by the single and bulk create paths so the reservation state
        machine exists exactly once."""
        if not idem:
            return thunk()
        seen = self.server.idem                   # type: ignore[attr-defined]
        lock = self.server.idem_lock              # type: ignore[attr-defined]
        with lock:
            ent = seen.get(idem)
            if ent is None:
                ent = {"done": threading.Event(), "id": None}
                seen[idem] = ent
                # bounded LRU: evict oldest COMPLETED entries
                if len(seen) > 8192:
                    for k in list(seen):
                        if len(seen) <= 8192:
                            break
                        if k != idem and seen[k]["done"].is_set():
                            seen.pop(k)
                owner = True
            else:
                owner = False
        if not owner:
            ent["done"].wait(timeout=30)
            if ent["id"] is not None:
                return ent["id"]
            with lock:
                if seen.get(idem) is ent:
                    seen.pop(idem)
            return self._idempotent(idem, thunk)
        try:
            result = thunk()
        except Exception:
            with lock:
                seen.pop(idem, None)
            ent["done"].set()
            raise
        ent["id"] = result
        ent["done"].set()
        return result

    def _create_bulk(self, sink: JobLogStore, wires, idem, spans=None):
        """Bulk insert (agent record flushers): one idempotency token
        covers the whole batch — a retried batch whose first attempt
        committed replays the original ids, never double-inserts.  The
        trace-span sidecar rides INSIDE the idempotent thunk, so a
        replayed batch does not double-count the stage histograms."""
        recs = [_rec_unwire(w) for w in wires]      # parse before reserving
        if spans:
            return self._idempotent(
                idem, lambda: sink.create_job_logs(recs, spans=spans))
        return self._idempotent(idem, lambda: sink.create_job_logs(recs))

    def _create(self, sink: JobLogStore, wire, idem):
        """Idempotent insert: the client's transparent reconnect+retry
        must not double-insert a record whose first attempt committed (or
        is still committing) when the reply was lost."""
        # parse BEFORE reserving: a bad wire dict must raise without
        # leaking a never-completed reservation
        rec = _rec_unwire(wire)

        def write():
            sink.create_job_log(rec)
            return rec.id
        return self._idempotent(idem, write)


class LogSinkServer:
    """Serve a JobLogStore over TCP; port 0 picks a free port."""

    def __init__(self, sink: Optional[JobLogStore] = None,
                 db_path: str = ":memory:", host: str = "127.0.0.1",
                 port: int = 0, token: str = "", sslctx=None,
                 retain: int = 0, hot_days: int = 0,
                 age_interval: float = 30.0):
        self.sink = sink or JobLogStore(db_path, retain=retain,
                                        hot_days=hot_days)
        # the retention sweeper's tier move: day aging rides a
        # background beat (cheap when nothing aged — the boundary scan
        # is one indexed MIN(id)); native logd runs the same loop on
        # its sweep thread
        self._age_stop = threading.Event()
        self._age_thread: Optional[threading.Thread] = None
        self._age_interval = age_interval
        if hot_days > 0 and sink is None and db_path != ":memory:":
            self._age_thread = threading.Thread(
                target=self._age_loop, daemon=True, name="logsink-ager")

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self._srv = _Server((host, port), _Conn)
        self._srv.sink = self.sink                # type: ignore[attr-defined]
        self._srv.token = token                   # type: ignore[attr-defined]
        self._srv.sslctx = sslctx                 # type: ignore[attr-defined]
        self._srv.idem = {}                       # type: ignore[attr-defined]
        self._srv.idem_lock = threading.Lock()    # type: ignore[attr-defined]
        self._srv.reply_cache = {}                # type: ignore[attr-defined]
        self._srv.reply_lock = threading.Lock()   # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _age_loop(self):
        while not self._age_stop.wait(self._age_interval):
            try:
                self.sink.age_out()
            except Exception as e:  # noqa: BLE001 — keep sweeping
                log.warnf("logsink age_out failed: %s", e)

    def start(self) -> "LogSinkServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="logsink-server")
        self._thread.start()
        if self._age_thread:
            self._age_thread.start()
        return self

    def stop(self):
        self._age_stop.set()
        if self._thread:
            self._srv.shutdown()
            self._srv.server_close()
            self._thread.join(timeout=3)
        else:
            # never start()ed (error-path cleanup): shutdown() would
            # block forever on the serve_forever event that never fires
            self._srv.server_close()
        if self._age_thread and self._age_thread.ident is not None:
            # only a STARTED thread can be joined (stop() on a
            # constructed-but-never-started server must not raise);
            # passes are bounded (AGE_PASS_RECORDS) so the in-flight
            # one finishes inside the timeout — and the age loop
            # catches-and-warns if the close below still races it
            self._age_thread.join(timeout=10)
        self.sink.close()


class LogSinkError(RuntimeError):
    pass


class RemoteLogSubscription:
    """Client side of the ``subscribe`` wire op, on a DEDICATED
    connection (the shared request/response connection is strictly
    synchronous — one streaming op is not worth teaching every caller
    a demux).  A reader thread feeds a local bounded buffer with the
    same ``get``/``drain``/``lost``/``on_ready`` surface as the
    in-process :class:`~.joblog.LogSubscription`, and ANY transport
    failure latches ``lost`` (never silent staleness): the consumer
    re-lists from its cursor and re-subscribes, exactly as after an
    overflow."""

    def __init__(self, host: str, port: int, timeout: float,
                 token: str, sslctx, tls_hostname: str,
                 after_id: int, cap: int):
        sock = socket.create_connection((host, port), timeout=timeout)
        if sslctx is not None:
            from ..tlsutil import wrap_client
            sock = wrap_client(sock, sslctx, tls_hostname)
        sock.settimeout(timeout)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._cap = max(1, int(cap))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._buf: deque = deque()
        self.lost = False
        self.closed = False
        self.on_ready = None
        try:
            if token:
                self._handshake("auth", token)
            r = self._handshake("subscribe", int(after_id), int(cap))
            self.rev = int(r.get("rev", 0))
            self.gap = bool(r.get("lost"))
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
            raise
        # subscribed: frames arrive whenever the server has events, so
        # reads must be allowed to block indefinitely
        sock.settimeout(None)
        self._thread = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name="logsink-sub-reader")
        self._thread.start()

    def _handshake(self, op: str, *args):
        data = (json.dumps({"i": 1, "o": op, "a": list(args)},
                           separators=(",", ":")) + "\n").encode()
        self._sock.sendall(data)
        line = self._rfile.readline()
        if not line:
            raise LogSinkError(f"{op}: connection closed")
        msg = json.loads(line)
        if "e" in msg:
            raise LogSinkError(msg["e"])
        return msg.get("r")

    def _read_loop(self):
        while True:
            try:
                line = self._rfile.readline()
            except (OSError, ValueError):
                line = b""
            if not line:
                self._mark_lost()
                return
            try:
                msg = json.loads(line)
            except ValueError:
                self._mark_lost()
                return
            if msg.get("lost"):
                self._mark_lost()
                return
            evs = msg.get("evs") or []
            ready = None
            with self._cv:
                if self.closed:
                    return
                if len(self._buf) + len(evs) > self._cap:
                    # local overflow mirrors the server-side contract
                    self._buf.clear()
                    self.lost = True
                else:
                    self._buf.extend(tuple(e) for e in evs)
                self._cv.notify_all()
                ready = self.on_ready
            if ready is not None:
                ready(self)
            if self.lost:
                return

    def _mark_lost(self):
        ready = None
        with self._cv:
            if not self.closed:
                self._buf.clear()
                self.lost = True
                ready = self.on_ready
            self._cv.notify_all()
        if ready is not None:
            ready(self)

    def drain(self) -> list:
        with self._cv:
            if self.lost:
                raise SubscriptionLost("log subscription lost")
            out = list(self._buf)
            self._buf.clear()
        return out

    def get(self, timeout: Optional[float] = None) -> list:
        with self._cv:
            if not self._buf and not self.lost and not self.closed:
                self._cv.wait(timeout)
            if self.lost:
                raise SubscriptionLost("log subscription lost")
            if self.closed and not self._buf:
                raise SubscriptionLost("log subscription closed")
            out = list(self._buf)
            self._buf.clear()
        return out

    def close(self):
        with self._cv:
            self.closed = True
            self._cv.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteJobLogStore:
    """TCP client with JobLogStore's exact surface.

    Calls are synchronous request/response under one lock (the result
    path has no server pushes to demux).  A dropped connection is healed
    by one transparent reconnect+retry per call; if that also fails the
    caller sees :class:`LogSinkError` and retries at its own cadence —
    the agent's log writes tolerate this the way the reference tolerates
    a Mongo hiccup (job_log.go:84 logs and moves on)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 token: str = "", sslctx=None, tls_hostname: str = ""):
        self.host, self.port = host, port
        self._timeout = timeout
        self._token = token
        self._sslctx = sslctx
        self._tls_hostname = tls_hostname
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._next_id = 1
        self._closed = False
        with self._lock:
            self._connect()

    # -- plumbing ----------------------------------------------------------

    def _connect(self):
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self._timeout)
        if self._sslctx is not None:
            from ..tlsutil import wrap_client
            sock = wrap_client(sock, self._sslctx, self._tls_hostname)
        self._sock = sock
        self._sock.settimeout(self._timeout)
        self._rfile = self._sock.makefile("rb")
        if self._token:
            self._exchange("auth", self._token)

    def _exchange(self, op: str, *args):
        rid = self._next_id
        self._next_id += 1
        data = (json.dumps({"i": rid, "o": op, "a": list(args)},
                           separators=(",", ":")) + "\n").encode()
        self._sock.sendall(data)
        line = self._rfile.readline()
        if not line:
            raise OSError("connection closed")
        msg = json.loads(line)
        if "e" in msg:
            raise LogSinkError(msg["e"])
        return msg.get("r")

    def _call(self, op: str, *args):
        if self._closed:
            raise LogSinkError("logsink connection closed")
        # chaos-plane fault point (env-gated off in production): see
        # store/remote.py — 'timeout' fails before the wire,
        # 'reply_lost' lets the op apply and fails the reply path (the
        # indeterminate shape the record flusher's pinned idempotency
        # tokens exist for), 'delay' stalls the caller
        act = _chaos.intercept("logsink.rpc", op) if _chaos.armed else None
        if act is not None:
            act.pre(LogSinkError, op)
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    r = self._exchange(op, *args)
                    if act is not None:
                        # LogSinkError, not OSError: the reply is
                        # "lost" WITHOUT burning the reconnect retry
                        # (the op applied; the caller's idem ladder
                        # owns the re-send)
                        act.post(LogSinkError, op)
                    return r
                except (OSError, ValueError) as e:
                    # ValueError covers JSONDecodeError and the
                    # UnicodeDecodeError binary garbage raises
                    self._drop()
                    if attempt:
                        raise LogSinkError(f"{op}: {e}") from e
                    log.warnf("logsink call %s failed (%s); reconnecting",
                              op, e)

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    def close(self):
        with self._lock:
            self._closed = True
            self._drop()

    # -- surface (mirrors JobLogStore) -------------------------------------

    def create_job_log(self, rec: LogRecord, idem: str = ""):
        # one token per logical record, stable across the reconnect
        # retry; callers that re-send a record after an INDETERMINATE
        # reply (the agent's record flusher) pass their own stable
        # ``idem`` so an applied-but-reply-lost write dedups
        # server-side instead of double-inserting (the token contract
        # of _Conn._idempotent above)
        rec.id = self._call("create_job_log", _rec_wire(rec),
                            idem or uuid.uuid4().hex)

    def create_job_logs(self, recs: List[LogRecord], idem: str = "",
                        spans: Optional[list] = None):
        """Bulk insert in one round trip (one idempotency token per
        batch) — the agents' record flushers use this so a 10k-order
        burst is tens of calls, not 10k.  Callers that re-flush a
        failed batch pass a stable ``idem`` so an applied-but-reply-
        lost write dedups server-side instead of double-inserting.
        ``spans`` is the trace plane's piggybacked sidecar: shipped as
        a third wire argument (older servers ignore it)."""
        if not recs and not spans:
            return
        if spans:
            ids = self._call("create_job_logs",
                             [_rec_wire(r) for r in recs],
                             idem or uuid.uuid4().hex, spans)
        else:
            ids = self._call("create_job_logs",
                             [_rec_wire(r) for r in recs],
                             idem or uuid.uuid4().hex)
        for r, i in zip(recs, ids or []):
            r.id = i

    def query_logs(self, **kw) -> Tuple[List[LogRecord], int]:
        r = self._call("query_logs", kw)
        return [_rec_unwire(w) for w in r["list"]], r["total"]

    def get_log(self, log_id: int) -> Optional[LogRecord]:
        return _rec_unwire(self._call("get_log", log_id))

    def stat_overall(self) -> dict:
        return self._call("stat_overall")

    def stat_day(self, day: str) -> dict:
        return self._call("stat_day", day)

    def stat_days(self, n_days: int) -> List[dict]:
        return self._call("stat_days", n_days)

    def op_stats(self) -> dict:
        """Server-side per-op timing snapshot (JobLogStore.op_stats —
        bulk create vs query attribution for the result plane)."""
        return self._call("op_stats")

    def revision(self) -> int:
        """Monotone change token (max record id ever assigned) — the
        web tier's ETag key and the follow poller's tail bootstrap."""
        return self._call("revision")

    def tail_snapshot(self, limit: int = 0) -> Tuple[int, List[LogRecord]]:
        """Revision AND the last ``limit`` records from ONE server-side
        snapshot — the follow bootstrap's atomic read (see
        JobLogStore.tail_snapshot for why two reads can skip)."""
        r = self._call("tail_snapshot", limit)
        return r["revision"], [_rec_unwire(w) for w in r["list"]]

    def subscribe(self, after_id: int = 0,
                  cap: int = 4096) -> RemoteLogSubscription:
        """Open a live change stream (see JobLogStore.subscribe) on a
        dedicated connection.  Raises LogSinkError when the server is
        unreachable or predates the ``subscribe`` op."""
        if self._closed:
            raise LogSinkError("logsink connection closed")
        try:
            return RemoteLogSubscription(
                self.host, self.port, self._timeout, self._token,
                self._sslctx, self._tls_hostname, after_id, cap)
        except (OSError, ValueError) as e:
            raise LogSinkError(f"subscribe: {e}") from e

    def age_out(self, now: Optional[float] = None) -> int:
        """Force a cold-aging pass (the sweeper runs it periodically);
        ``now`` overrides the clock for deterministic tests."""
        return self._call("age_out") if now is None \
            else self._call("age_out", now)

    def tier_info(self) -> dict:
        """Tiering observability: watermark, hot sizes, segments."""
        return self._call("tier_info")

    def logmap(self, n=None, hash=None):
        """Topology pin (see JobLogStore.logmap): publish-if-absent with
        arguments, read-only peek without."""
        if n is None:
            return self._call("logmap")
        return self._call("logmap", n, hash)

    # -- trace plane -------------------------------------------------------

    def trace_get(self, job_id: str, epoch_s: int) -> list:
        return self._call("trace_get", job_id, int(epoch_s))

    def trace_top(self, n: int = 256) -> list:
        return self._call("trace_top", int(n))

    def trace_stats(self) -> dict:
        return self._call("trace_stats")

    def upsert_node(self, node_id: str, doc: str, alived: bool):
        self._call("upsert_node", node_id, doc, alived)

    def set_node_alived(self, node_id: str, alived: bool):
        self._call("set_node_alived", node_id, alived)

    def get_nodes(self) -> List[dict]:
        return self._call("get_nodes")

    def get_node(self, node_id: str) -> Optional[dict]:
        return self._call("get_node", node_id)

    def upsert_account(self, email: str, doc: str):
        self._call("upsert_account", email, doc)

    def get_account(self, email: str) -> Optional[str]:
        return self._call("get_account", email)

    def list_accounts(self) -> List[str]:
        return self._call("list_accounts")

    def delete_account(self, email: str) -> bool:
        return self._call("delete_account", email)
