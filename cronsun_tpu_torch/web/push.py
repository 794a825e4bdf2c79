"""Live-push plane for the web tier: logd change streams fanned out
to browsers over SSE.

The poll path made every dashboard poll cheap (revision ETags,
304s, the response cache) — but read cost still scaled O(viewers x
poll rate) even when nothing changed.  This module inverts it: the web
server subscribes ONCE per logd shard (the ``subscribe`` wire op, both
backends) and

- keeps a push-maintained per-shard revision vector,
- refreshes the response cache's changed-shard partials on push
  (debounced) so the NEXT poll is a body hit instead of a recompute,
- fans event summaries out to SSE viewers through bounded per-client
  queues — a stalled browser overflows its own queue, gets a terminal
  ``lost`` event, and re-lists; it cannot buffer the fleet.

Loss semantics are the store's watch semantics end to end: a shard
subscription that overflows is resumed server-side at the manager's
vector (the subscribe op replays from its hot window); only when the
server declares a gap — the missed range left retention — do viewers
see ``lost``.

``CRONSUN_WEB_PUSH=off`` is the rollback switch: no subscriptions, no
/v1/stream (503), byte-identical poll behavior.

Copy of ``cronsun_tpu/web/push.py``.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict, deque
from typing import List, Optional

from .. import log
from ..core.errors import is_error
from ..logsink.joblog import SubscriptionLost


def push_default() -> bool:
    return os.environ.get("CRONSUN_WEB_PUSH", "").lower() not in (
        "off", "0", "false")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def event_dict(ev) -> dict:
    """SSE ``data:`` payload for one event summary — the _log_dict
    field names minus the heavy payload (user/command/output stay
    behind /v1/log/<id>)."""
    return {"id": ev[0], "jobId": ev[1], "jobGroup": ev[2],
            "name": ev[3], "node": ev[4], "success": ev[5],
            "beginTime": ev[6], "endTime": ev[7]}


_json_memo: "OrderedDict[tuple, str]" = OrderedDict()
_frame_memo: "OrderedDict[tuple, bytes]" = OrderedDict()
_json_memo_mu = threading.Lock()
_JSON_MEMO_CAP = 8192


def event_data_json(ev) -> str:
    """``data:`` line payload, memoized: every connected viewer
    serializes the SAME summary, so at N viewers the naive path pays
    N json.dumps per record — the memo makes fan-out cost one dumps
    per record plus N string copies.  Keyed by the WHOLE summary
    tuple, not the id: the memo is process-global and record ids are
    per-sink, so two sinks in one process (tests, a future
    multi-sink replica) would otherwise serve each other stale
    frames."""
    key = tuple(ev)
    with _json_memo_mu:
        s = _json_memo.get(key)
        if s is not None:
            return s
    s = json.dumps(event_dict(ev), separators=(",", ":"))
    with _json_memo_mu:
        _json_memo[key] = s
        while len(_json_memo) > _JSON_MEMO_CAP:
            _json_memo.popitem(last=False)
    return s


def event_frame_tail(ev) -> bytes:
    """The per-event constant SSE frame suffix
    (``event: log\\ndata: <json>\\n\\n``), memoized like
    :func:`event_data_json` (same whole-tuple key).  Only the ``id:``
    line differs per viewer (it carries that viewer's cursor vector),
    so both writers serialize AND encode each record once per
    replica; fan-out to N viewers is N cheap concatenations."""
    key = tuple(ev)
    with _json_memo_mu:
        b = _frame_memo.get(key)
        if b is not None:
            return b
    b = (b"event: log\ndata: " + event_data_json(ev).encode() + b"\n\n")
    with _json_memo_mu:
        _frame_memo[key] = b
        while len(_frame_memo) > _JSON_MEMO_CAP:
            _frame_memo.popitem(last=False)
    return b


class SseClient:
    """One viewer: a bounded event queue plus its server-side filters.
    Overflow clears the queue and latches ``lost`` (watch semantics —
    the writer sends a terminal ``lost`` event and the browser
    re-lists), so a slow consumer's cost is capped at ``cap`` summaries
    however far it falls behind."""

    def __init__(self, filters: dict, cap: int, vec: List[int],
                 nshards: int):
        self.filters = filters
        self.cap = max(1, int(cap))
        self.vec = list(vec)          # delivered cursor (id: field)
        self.reg_vec = list(vec)      # fan-out starts past this point
        self.nshards = nshards
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._buf: deque = deque()
        self.lost = False
        self.stopping = False
        # event-driven writer hook (web/sse_epoll.py): wakes the epoll
        # loop that owns this viewer's socket whenever the queue state
        # changes.  None under the threaded writer — take() blocks on
        # the condvar instead.
        self.signal = None

    def matches(self, ev) -> bool:
        f = self.filters
        tids = f.get("tenant_ids")
        if tids is not None and ev[1] not in tids:
            return False
        jids = f.get("job_ids")
        if jids is not None and ev[1] not in jids:
            return False
        node = f.get("node")
        if node and ev[4] != node:
            return False
        if f.get("failed_only") and ev[5]:
            return False
        return True

    def push(self, evs) -> bool:
        """Queue events for the writer; returns False when this client
        just overflowed (caller counts the drop)."""
        with self._cv:
            if self.lost or self.stopping:
                return True
            if len(self._buf) + len(evs) > self.cap:
                self._buf.clear()
                self.lost = True
                self._cv.notify_all()
                self._signal()
                return False
            self._buf.extend(evs)
            self._cv.notify_all()
            self._signal()
            return True

    def mark_lost(self):
        with self._cv:
            self._buf.clear()
            self.lost = True
            self._cv.notify_all()
            self._signal()

    def stop(self):
        with self._cv:
            self.stopping = True
            self._cv.notify_all()
            self._signal()

    def _signal(self):
        sig = self.signal
        if sig is not None:
            try:
                sig()
            except Exception:  # noqa: BLE001 — a dying loop can't veto
                pass           # the fan-out path; the pool reaps it

    def take(self, timeout: Optional[float]):
        """-> (events, state): state is None (keep streaming), "lost"
        (send terminal lost + close) or "closed" (graceful drain)."""
        with self._cv:
            if not self._buf and not self.lost and not self.stopping:
                self._cv.wait(timeout)
            evs = list(self._buf)
            self._buf.clear()
            state = "lost" if self.lost else (
                "closed" if self.stopping else None)
            return evs, state

    def advance(self, eid: int):
        if self.nshards > 1:
            raw, si = eid // self.nshards, eid % self.nshards
            if raw > self.vec[si]:
                self.vec[si] = raw
        elif eid > self.vec[0]:
            self.vec[0] = eid


class PushManager:
    """Per-shard logd subscriptions + SSE fan-out + the debounced
    cache-refresh signal.  One instance per ApiServer."""

    def __init__(self, sink, on_change=None,
                 heartbeat: Optional[float] = None,
                 client_cap: Optional[int] = None,
                 sub_cap: int = 8192):
        self.sink = sink
        # raw shard clients when sharded (a stream failure latches lost
        # and this manager re-subscribes — that IS the breaker story;
        # routing streams through breaker guards would just add a
        # second failure detector), the sink itself otherwise
        self.shards = list(getattr(sink, "_raw", None) or [sink])
        self.nshards = max(1, int(getattr(sink, "nshards", 1)))
        self.on_change = on_change      # debounced: cache refresh hook
        self.heartbeat = heartbeat if heartbeat is not None else \
            _env_float("CRONSUN_SSE_HEARTBEAT", 15.0)
        self.client_cap = client_cap if client_cap is not None else \
            _env_int("CRONSUN_SSE_QUEUE", 256)
        self.sub_cap = sub_cap
        self._mu = threading.Lock()
        self._clients: list = []
        self._vec = [0] * self.nshards
        self._subs: list = [None] * self.nshards
        self._health: list = [(False, "connecting")] * self.nshards
        self._stats = {"events_total": 0, "dropped_slow_total": 0,
                       "resumes_total": 0, "cache_refreshes_total": 0,
                       "client_lost_total": 0,
                       "ring_evictions_total": 0}
        self._stop = threading.Event()
        self._dirty = threading.Event()
        self._threads: list = []
        self.running = False

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "PushManager":
        """Subscribe every shard (synchronously — readiness is truthful
        from the first /readyz) and start the drain + refresh threads.
        A shard that fails to subscribe here starts unhealthy and the
        drain loop keeps retrying with backoff."""
        for si in range(self.nshards):
            try:
                self._subscribe(si, after_id=0)
            except Exception as e:  # noqa: BLE001 — retried in the loop
                self._health[si] = (False, f"subscribe failed: {e}")
        self.running = True
        for si in range(self.nshards):
            t = threading.Thread(target=self._shard_loop, args=(si,),
                                 daemon=True, name=f"web-push-{si}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._refresh_loop, daemon=True,
                             name="web-push-refresh")
        t.start()
        self._threads.append(t)
        return self

    def stop(self, drain_timeout: float = 2.0):
        """Graceful drain: viewers get a final ``bye`` event (with a
        long ``retry:`` so browsers back off the dead replica) and the
        writer threads close their sockets; bounded wait, then the
        subscriptions come down."""
        self._stop.set()
        self._dirty.set()
        with self._mu:
            clients = list(self._clients)
        for c in clients:
            c.stop()
        deadline = _mono() + max(0.0, drain_timeout)
        while _mono() < deadline:
            with self._mu:
                if not self._clients:
                    break
            _sleep(0.02)
        with self._mu:
            subs, self._subs = self._subs, [None] * self.nshards
        for s in subs:
            if s is not None:
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
        self.running = False

    # ---- the per-shard subscription loops --------------------------------

    def _subscribe(self, si: int, after_id: int):
        """(Re)open shard ``si``'s stream.  A successful subscribe with
        a replayable window recovers every missed event server-side; a
        declared gap is unrecoverable — viewers get ``lost`` and
        re-list."""
        sub = self.shards[si].subscribe(after_id=after_id,
                                        cap=self.sub_cap)
        with self._mu:
            old = self._subs[si]
            self._subs[si] = sub
            if after_id <= 0 or sub.gap:
                self._vec[si] = sub.rev
            self._health[si] = (True, f"subscribed at {sub.rev}")
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001
                pass
        if after_id > 0 and sub.gap:
            # the missed range left the server's replay window: the
            # store's lossy contract reaches the viewers
            self._evict_all("shard %d resume gap" % si)
        return sub

    def _shard_loop(self, si: int):
        backoff = 0.2
        while not self._stop.is_set():
            with self._mu:
                sub = self._subs[si]
            if sub is None:
                try:
                    self._subscribe(si, after_id=self._vec[si])
                    backoff = 0.2
                except Exception as e:  # noqa: BLE001 — keep retrying
                    with self._mu:
                        self._health[si] = (
                            False, f"resubscribe failed: {e}")
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, 5.0)
                continue
            try:
                evs = sub.get(timeout=0.5)
            except Exception as e:  # noqa: BLE001 — SubscriptionLost
                # of either package (a sink of another package raises
                # its own class of the same name); anything else escapes
                if not is_error(e, SubscriptionLost):
                    raise
                with self._mu:
                    if self._subs[si] is sub:
                        self._subs[si] = None
                    self._health[si] = (False, "stream lost; resuming")
                continue
            if evs:
                self._apply(si, evs)

    def _apply(self, si: int, evs):
        """One batch from shard ``si``: encode ids to the global space,
        advance the vector, fan out, signal the cache refresher."""
        n = self.nshards
        if n > 1:
            enc = [(e[0] * n + si,) + tuple(e[1:]) for e in evs]
        else:
            enc = [tuple(e) for e in evs]
        with self._mu:
            if evs[-1][0] > self._vec[si]:
                self._vec[si] = evs[-1][0]
            clients = list(self._clients)
        delivered = 0
        for c in clients:
            out = [e for e in enc if c.matches(e)]
            if not out:
                continue
            if c.push(out):
                delivered += len(out)
            else:
                self.count("dropped_slow_total")
                self.count("client_lost_total")
        if delivered:
            self.count("events_total", delivered)
        self._dirty.set()

    def _evict_all(self, why: str):
        with self._mu:
            clients = list(self._clients)
        if clients:
            log.warnf("push: evicting %d sse client(s): %s",
                      len(clients), why)
        for c in clients:
            c.mark_lost()
            self.count("client_lost_total")

    def _refresh_loop(self):
        """Debounced cache refresh: coalesce event bursts for ~50 ms,
        then recompute only the changed shards' cached partials (the
        on_change hook is ApiServer._push_refresh)."""
        while not self._stop.is_set():
            self._dirty.wait()
            if self._stop.is_set():
                return
            self._dirty.clear()
            _sleep(0.05)
            self._dirty.clear()
            cb = self.on_change
            if cb is None:
                continue
            try:
                if cb():
                    self.count("cache_refreshes_total")
            except Exception as e:  # noqa: BLE001 — next burst retries
                log.warnf("push: cache refresh failed: %s", e)

    # ---- viewer surface --------------------------------------------------

    def vector(self) -> List[int]:
        """Push-maintained per-shard cursor (len == nshards; len 1 for
        an unsharded sink)."""
        with self._mu:
            return list(self._vec)

    def register(self, filters: dict, cap: Optional[int] = None
                 ) -> SseClient:
        with self._mu:
            c = SseClient(filters, cap or self.client_cap, self._vec,
                          self.nshards)
            self._clients.append(c)
            return c

    def unregister(self, client: SseClient):
        with self._mu:
            try:
                self._clients.remove(client)
            except ValueError:
                pass

    def replay(self, client: SseClient, cursor_vec: List[int],
               max_pages: int = 10) -> list:
        """Resume: the records in (cursor, registration-vector] as
        event tuples, via the cursor query (bounded —
        ``max_pages`` x 500; a client further behind than that is
        marked ``lost`` and re-lists).  Events already past the
        registration vector are skipped: they arrive through the live
        queue, so resume is exactly-once."""
        self.count("resumes_total")
        n = self.nshards
        after = list(cursor_vec) if n > 1 else cursor_vec[0]
        out = []
        for _ in range(max_pages):
            recs, _total = self.sink.query_logs(after_id=after,
                                                page=1, page_size=500)
            for r in recs:
                if r.id is None:
                    continue
                if n > 1:
                    raw, si = r.id // n, r.id % n
                    if raw > after[si]:
                        after[si] = raw
                    if raw > client.reg_vec[si]:
                        continue    # will arrive via the live queue
                else:
                    after = max(after, r.id)
                    if r.id > client.reg_vec[0]:
                        continue
                ev = (r.id, r.job_id, r.job_group, r.name, r.node,
                      r.success, r.begin_ts, r.end_ts)
                if client.matches(ev):
                    out.append(ev)
            if len(recs) < 500:
                return out
        client.mark_lost()          # too far behind: re-list
        return out

    # ---- observability ---------------------------------------------------

    def count(self, stat: str, n: int = 1):
        with self._mu:
            self._stats[stat] += n

    def stats(self) -> dict:
        with self._mu:
            out = dict(self._stats)
            out["connections"] = len(self._clients)
            return out

    def health(self) -> list:
        """[(ok, detail)] per shard — /readyz's named checks."""
        with self._mu:
            return list(self._health)


def _mono() -> float:
    import time
    return time.monotonic()


def _sleep(s: float):
    import time
    time.sleep(s)
