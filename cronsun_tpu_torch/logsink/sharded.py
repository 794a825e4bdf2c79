"""Horizontal result-plane sharding: a routing client over N ``logd``
shards.

The shard ladder proved the dispatch store scales past one process, and
measured the UNSHARDED logd sink as the new wall (~33k records/s on the
bench host, logd op_stats showing 60 s of busy time in a 13 s run).
This module partitions the RESULT keyspace across N independent logd
processes — each a perfectly ordinary ``cronsun-logd`` (same wire
protocol, same WAL/SQLite sidecar, just a smaller record space) — and
gives every component a drop-in client with the exact JobLogStore
surface, mirroring ``store/sharded.py`` end to end.

Routing — deterministic, shared with ``native/agentd.cc`` bit-for-bit:

- the token is the record's ``job_id``, hashed with the same 64-bit
  FNV-1a the store shards use (:func:`~cronsun_tpu_torch.store.sharded.fnv1a`
  — Python's salted builtin hash can't agree across processes).  A
  job's ``job_log`` rows, its ``job_latest_log`` entries, and its
  retention trim therefore all live on ONE shard: the hot write path
  (an agent's bulk flush) splits per shard and fans out concurrently,
  and the common dashboard filter ("this job's history") is a
  single-shard read.
- ``node`` and ``account`` tables pin to SHARD 0 — tiny, single-writer,
  not worth scattering.

Record ids are encoded ``raw * N + shard`` so they stay globally unique
and decodable: ``get_log`` routes by ``id % N``, and a follow poller
can recover each record's shard from the id alone.

Writes: :meth:`ShardedJobLogStore.create_job_logs` splits the batch by
job token, derives ONE pinned idempotency token per sub-batch from the
caller's batch token (``idem + ".s<shard>"`` — deterministic, so a
whole-batch retry re-derives the same per-shard tokens), and fans the
sub-batches out concurrently.  A retry after a partial failure re-sends
every sub-batch; shards that already applied dedup server-side — the
whole-batch retry contract, unchanged PER SHARD.

Reads scatter-gather:

- ``query_logs`` fetches up to ``page * page_size`` candidates per
  shard (paging the shard at a fixed stride) and merge-sorts with a
  DOCUMENTED stable tie order so paging is deterministic:
  ``(begin_ts DESC, shard ASC, id ASC)`` for history rows, and
  ``(begin_ts DESC, job_id ASC, node ASC)`` for the id-less latest
  view — the latter is exactly the order both backends pin, so the
  merged latest view is byte-identical to an unsharded sink's.
- cursor mode (``after_id``) becomes a PER-SHARD CURSOR VECTOR (the
  sharded store's revision-vector pattern): each shard keeps its own
  monotone id space, so one scalar cannot resume N independent
  streams without missing a slow shard's records.  Results merge by
  ``(raw id ASC, shard ASC)`` and carry encoded ids; the consumer
  advances its vector per delivered record (:func:`advance_cursor`).
- ``stat_overall`` / ``stat_day`` / ``stat_days`` sum per-shard
  counters — exact, because every record lands on exactly one shard
  (and a day in the global top-n is by date order within every
  shard's top-n where present).

The shard topology is pinned by a ``logmap`` record on shard 0: the
first client publishes ``{"n": N, "hash": HASH}``, every later client
verifies it, and a client configured with a different shard count
refuses to start instead of scattering one job's history under two
layouts.  With ONE shard every operation passes through verbatim — no
split, no id encoding, no pin write (:func:`connect_sharded_sink`
returns the plain client after a read-only pin check).

Copy of ``cronsun_tpu/logsink/sharded.py``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.breaker import BreakerBank, ShardDegradedError  # noqa: F401
# (ShardDegradedError re-exported: the error create_job_logs raises
# fail-fast into the agents' retry ladders when a shard's breaker is
# open)
from ..store.sharded import breaker_env_deadline, fnv1a
from .joblog import LogRecord, SubscriptionLost

LOG_HASH_SCHEME = "fnv1a-job-v1"


def log_shard_index(job_id: str, nshards: int) -> int:
    """The routing hash: 64-bit FNV-1a of the raw ``job_id`` mod N —
    deterministic across processes and languages (native/agentd.cc
    carries the same constants)."""
    if nshards <= 1:
        return 0
    return fnv1a(job_id) % nshards


def encode_log_id(raw: int, shard: int, nshards: int) -> int:
    """Globally-unique record id: ``raw * N + shard``.  Monotone per
    shard, decodable without a lookup."""
    return raw * nshards + shard


def decode_log_id(gid: int, nshards: int) -> Tuple[int, int]:
    """-> (raw per-shard id, shard index)."""
    return gid // nshards, gid % nshards


def advance_cursor(vec: Sequence[int], recs, nshards: int) -> List[int]:
    """Next per-shard cursor vector after consuming ``recs`` (records
    with ENCODED ids, as returned by a sharded cursor query): each
    delivered record advances its own shard's entry; shards that
    delivered nothing keep theirs."""
    out = list(vec)
    for r in recs:
        if r.id is None:
            continue
        raw, si = decode_log_id(r.id, nshards)
        if raw > out[si]:
            out[si] = raw
    return out


def fetch_top(client, kw: dict, need: int):
    """Top ``need`` rows from one sink client under ``kw``'s filters
    (the client's own documented order), paging at a fixed stride so
    backend OFFSET math stays consistent.  -> (rows, client total).
    Module-level so the web tier's response cache can compute one
    shard's partial with exactly the scatter-gather's fetch."""
    ps = max(1, min(500, need))
    out: List[LogRecord] = []
    total = 0
    page = 1
    while len(out) < need:
        rows, total = client.query_logs(**kw, page=page, page_size=ps)
        out.extend(rows)
        if len(rows) < ps:
            break
        page += 1
    return out[:need], total


def merge_latest_parts(parts, page: int, page_size: int):
    """Merge per-shard latest-view partials [(rows, total), ...] into
    the one global page: both backends pin (begin_ts DESC, job_id,
    node) and the (job, node) space partitions by shard, so this sort
    IS the global order — byte-identical to an unsharded sink.  Shared
    by the sharded read path and the web response cache (which reuses
    unchanged shards' cached partials before this merge)."""
    rows = [r for part, _t in parts for r in part]
    rows.sort(key=lambda r: (-r.begin_ts, r.job_id, r.node))
    total = sum(t for _p, t in parts)
    return rows[(page - 1) * page_size: page * page_size], total


def merge_stat_days(parts: List[List[dict]], n_days: int) -> List[dict]:
    """Sum per-shard stat_days partials per day, newest first.  Exact:
    each shard's top-n days contain every one of its days that falls
    in the GLOBAL top-n (day order is global).  Shared by the sharded
    read path and the web response cache."""
    days: Dict[str, List[int]] = {}
    for part in parts:
        for d in part:
            ent = days.setdefault(d["day"], [0, 0, 0])
            ent[0] += d["total"]
            ent[1] += d["successed"]
            ent[2] += d["failed"]
    return [{"day": day, "total": t, "successed": s, "failed": f}
            for day, (t, s, f) in
            sorted(days.items(), reverse=True)[:max(0, n_days)]]


class ShardedLogSubscription:
    """Merged change stream over one subscription PER SHARD — the
    cursor-vector machinery, live.  Each shard's drainer re-encodes its
    raw ids (``raw * N + shard``) and appends into one bounded merged
    buffer; per-shard order is preserved (cross-shard interleave is
    arbitrary, exactly like concurrent writes).  ``vector`` is the
    per-shard resume cursor advanced per DELIVERED event — hand it to
    ``query_logs(after_id=vector)`` to re-list after a ``lost``, or to
    ``subscribe`` to resume.  Any shard's loss (overflow, transport)
    latches the merged stream ``lost``: one vector describes one
    consistent resume point, so a half-lost stream is not a thing."""

    def __init__(self, sharded: "ShardedJobLogStore", vec: List[int],
                 cap: int):
        self._n = sharded.nshards
        self._cap = max(1, int(cap))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._buf: deque = deque()
        self.lost = False
        self.closed = False
        self.on_ready = None
        self._subs: list = []
        try:
            # raw clients, not breaker guards: a stream is long-lived —
            # failure latches ``lost`` and the consumer re-subscribes
            # at its own cadence, which IS the breaker story here
            for si in range(self._n):
                self._subs.append(
                    sharded._raw[si].subscribe(after_id=vec[si],
                                               cap=self._cap))
        except BaseException:
            for s in self._subs:
                s.close()
            raise
        self.rev = [s.rev for s in self._subs]
        self.gap = any(s.gap for s in self._subs)
        # resume vector: a gap (or from-now) shard starts at its stream
        # revision — the caller re-lists the gap once, signalled by
        # ``gap`` — a replayed shard at the requested cursor
        self._vec = [self._subs[si].rev
                     if vec[si] <= 0 or self._subs[si].gap else vec[si]
                     for si in range(self._n)]
        self._threads = [
            threading.Thread(target=self._drain_loop, args=(si,),
                             daemon=True, name=f"logsub-merge-{si}")
            for si in range(self._n)]
        for t in self._threads:
            t.start()

    def _drain_loop(self, si: int):
        sub = self._subs[si]
        while True:
            try:
                evs = sub.get(timeout=0.5)
            except SubscriptionLost:
                self._mark_lost()
                return
            with self._cv:
                if self.closed or self.lost:
                    return
            if not evs:
                continue
            enc = [(encode_log_id(e[0], si, self._n),) + tuple(e[1:])
                   for e in evs]
            ready = None
            with self._cv:
                if self.closed or self.lost:
                    return
                if len(self._buf) + len(enc) > self._cap:
                    self._buf.clear()
                    self.lost = True
                else:
                    self._buf.extend(enc)
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

    @property
    def vector(self) -> List[int]:
        """Per-shard resume cursor of everything DELIVERED so far."""
        with self._mu:
            return list(self._vec)

    def _take_locked(self) -> list:
        out = list(self._buf)
        self._buf.clear()
        for e in out:
            raw, si = decode_log_id(e[0], self._n)
            if raw > self._vec[si]:
                self._vec[si] = raw
        return out

    def drain(self) -> list:
        with self._cv:
            if self.lost:
                raise SubscriptionLost("sharded log subscription lost")
            return self._take_locked()

    def get(self, timeout: Optional[float] = None) -> list:
        """Pending events (encoded ids), blocking up to ``timeout``."""
        with self._cv:
            if not self._buf and not self.lost and not self.closed:
                self._cv.wait(timeout)
            if self.lost:
                raise SubscriptionLost("sharded log subscription lost")
            if self.closed and not self._buf:
                raise SubscriptionLost("sharded log subscription closed")
            return self._take_locked()

    def close(self):
        with self._cv:
            self.closed = True
            self._cv.notify_all()
        for s in self._subs:
            s.close()


class ShardedJobLogStore:
    """Routing client over N result-store shards with the full
    JobLogStore surface — agents, web, noticer and ctl run unchanged
    against it.

    ``shards`` is a list of sink clients (RemoteJobLogStore per shard
    in production; in-process JobLogStore works too, which is what the
    differential tests use)."""

    def __init__(self, shards: Sequence, verify_map: bool = True,
                 shard_deadline: Optional[float] = None,
                 breaker_fails: int = 3, breaker_cooldown: float = 1.0):
        if not shards:
            raise ValueError("ShardedJobLogStore needs at least one shard")
        self._raw = list(shards)
        self.nshards = len(self._raw)
        # per-shard brownout handling (the store client's contract,
        # store/sharded.py): with a deadline configured (param or
        # CRONSUN_SHARD_DEADLINE_S) each shard is breaker-guarded —
        # writes against an OPEN shard fail fast into the agents'
        # record-flush retry ladder (idem tokens pinned, so nothing
        # duplicates on the re-send), dashboard reads skip it with a
        # loud shard_degraded count.  deadline <= 0 (default) disables:
        # self.shards IS the raw list, behavior byte-identical.
        if shard_deadline is None:
            shard_deadline = breaker_env_deadline()
        self.shard_deadline = shard_deadline
        self._bank = BreakerBank(self.nshards, shard_deadline,
                                 fail_threshold=breaker_fails,
                                 cooldown=breaker_cooldown,
                                 label="logsink shard")
        self._breakers = self._bank.breakers
        self.shards = self._bank.guards(self._raw,
                                        healthy_errors=(KeyError,))
        self._pool = (ThreadPoolExecutor(
            max_workers=max(2, 2 * self.nshards) +
            (2 * self.nshards if shard_deadline > 0 else 0),
            thread_name_prefix="logshard-fan") if self.nshards > 1 else None)
        self._lock = threading.Lock()
        if self.nshards > 1 and verify_map:
            self._pin_log_map()

    def arm_breaker_notices(self, store, prefix: str = "/cronsun",
                            source: str = ""):
        """Route breaker OPEN transitions into the noticer plane.  The
        logsink client cannot write notices itself (they live in the
        COORDINATION store) — the process that owns both (the web
        server hosts the noticer in the reference) passes its store
        here.  No-op when the breaker bank is disabled."""
        self._bank.arm_notices(store, prefix, source=source)

    # ---- routing ---------------------------------------------------------

    def _idx(self, job_id: str) -> int:
        return log_shard_index(job_id, self.nshards)

    def _fan(self, fns):
        """Run thunks concurrently (one per shard touched); re-raises
        the first failure after all complete."""
        fns = list(fns)
        if len(fns) == 1 or self._pool is None:
            return [fn() for fn in fns]
        futs = [self._pool.submit(fn) for fn in fns]
        out, first_err = [], None
        for f in futs:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 — collected below
                out.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return out

    def _tolerant(self, i: int, fn, default=None):
        """A dashboard read that can TOLERATE a missing shard
        (core.breaker.BreakerBank): an open breaker yields ``default``
        (counted loudly) instead of failing — or stalling — the whole
        scatter-gather."""
        return self._bank.tolerant(i, fn, default=default)

    def breaker_snapshot(self) -> List[dict]:
        """Per-shard breaker state + degraded-read counts (rendered at
        /v1/metrics beside the store's).  Empty when disabled."""
        return self._bank.snapshot()

    def _pin_log_map(self):
        got = self.shards[0].logmap(self.nshards, LOG_HASH_SCHEME)
        if not isinstance(got, dict) or got.get("n") != self.nshards \
                or got.get("hash") != LOG_HASH_SCHEME:
            raise RuntimeError(
                f"logmap mismatch: result-store set was laid out as "
                f"{got!r}, this client is configured for "
                f"{{'n': {self.nshards}, 'hash': {LOG_HASH_SCHEME!r}}} — "
                "refusing to scatter one job's history under two "
                "topologies")

    # ---- writes ----------------------------------------------------------

    def create_job_log(self, rec: LogRecord, idem: str = ""):
        # idem passes through untouched (the wire client mints its own
        # per-call token when empty, exactly the unsharded behavior)
        si = self._idx(rec.job_id)
        self.shards[si].create_job_log(rec, idem=idem)
        if rec.id is not None:
            rec.id = encode_log_id(rec.id, si, self.nshards)
        return rec.id

    def create_job_logs(self, recs, idem: str = "",
                        spans: Optional[list] = None) -> list:
        """Split the batch by job token, fan the sub-batches out
        concurrently — one bulk RPC per shard touched, each riding a
        per-shard idempotency token DERIVED from the batch token
        (``idem + ".s<shard>"``).  A caller retrying the whole logical
        batch (the agents' record flushers, token pinned) re-derives
        the same per-shard tokens, so shards that applied the first
        attempt dedup server-side while the failed shard gets its
        records — whole-batch retry, per shard.  Raises on ANY shard
        failing (after every sub-batch settles), matching the
        unsharded client's all-or-retry contract."""
        recs = list(recs)
        # trace spans route by the SAME job token as their records, so
        # a trace's spans co-locate with its job's history
        span_groups: Dict[int, list] = {}
        for sp in spans or []:
            jid = sp.get("job") if isinstance(sp, dict) else None
            if isinstance(jid, str):
                span_groups.setdefault(self._idx(jid), []).append(sp)
        if not recs and not span_groups:
            return []
        groups: Dict[int, list] = {}
        for pos, r in enumerate(recs):
            groups.setdefault(self._idx(r.job_id), []).append((pos, r))
        for si in span_groups:
            groups.setdefault(si, [])

        def send(si, group):
            sub = [r for _p, r in group]
            # no caller token -> each shard's wire client mints its own
            # per-call token (a bare ".s<i>" suffix would be one shared
            # token for EVERY token-less batch — a dedup collision)
            sp = span_groups.get(si)
            if sp:
                self.shards[si].create_job_logs(
                    sub, idem=f"{idem}.s{si}" if idem else "", spans=sp)
            else:
                self.shards[si].create_job_logs(
                    sub, idem=f"{idem}.s{si}" if idem else "")
        self._fan([lambda si=si, g=g: send(si, g)
                   for si, g in groups.items()])
        for si, group in groups.items():
            for _pos, r in group:
                if r.id is not None:
                    r.id = encode_log_id(r.id, si, self.nshards)
        return [r.id for r in recs]

    # ---- queries ---------------------------------------------------------

    def _fetch_top(self, si: int, kw: dict, need: int):
        return fetch_top(self.shards[si], kw, need)

    def query_logs(self, node: Optional[str] = None,
                   job_ids: Optional[List[str]] = None,
                   name_like: Optional[str] = None,
                   begin: Optional[float] = None,
                   end: Optional[float] = None,
                   failed_only: bool = False,
                   latest: bool = False,
                   page: int = 1, page_size: int = 50,
                   after_id=None) -> Tuple[List[LogRecord], int]:
        """Scatter-gather read.  ``after_id`` in SHARDED cursor mode is
        a per-shard raw-id VECTOR (list/tuple, one entry per shard;
        scalar 0 means "from the beginning everywhere") — one scalar
        cannot resume N independent id spaces without skipping a slow
        shard's records.  Cursor results merge by (raw id ASC, shard
        ASC) with total pinned to -1; the consumer advances its vector
        from the delivered encoded ids (:func:`advance_cursor`)."""
        kw = dict(node=node, job_ids=job_ids, name_like=name_like,
                  begin=begin, end=end, failed_only=failed_only,
                  latest=latest)
        page = max(1, min(page, 1 << 40))
        page_size = max(1, min(page_size, 500))
        # a job-filtered read touches only the filter's shards — the
        # dashboard's "this job's history" is a single-shard read
        sids = sorted({self._idx(j) for j in job_ids}) if job_ids \
            else list(range(self.nshards))

        if after_id is not None and not latest:
            if isinstance(after_id, (list, tuple)):
                if len(after_id) != self.nshards:
                    raise ValueError(
                        f"cursor vector has {len(after_id)} entries for "
                        f"{self.nshards} shards")
                vec = [int(v) for v in after_id]
            elif int(after_id) == 0:
                vec = [0] * self.nshards
            else:
                raise ValueError(
                    "a sharded sink resumes from a per-shard cursor "
                    "vector (advance_cursor()), not a scalar id")
            parts = self._fan([
                self._tolerant(si, lambda si=si: (
                    si, self.shards[si].query_logs(
                        **kw, after_id=vec[si], page=1,
                        page_size=page_size)[0]))
                for si in sids])
            parts = [p for p in parts if p is not None]
            merged = [(r.id, si, r) for si, rows in parts for r in rows]
            merged.sort(key=lambda t: (t[0], t[1]))
            out = []
            for raw, si, r in merged[:page_size]:
                r.id = encode_log_id(raw, si, self.nshards)
                out.append(r)
            return out, -1

        need = page * page_size
        parts = self._fan([
            self._tolerant(si, lambda si=si: (
                si, *self._fetch_top(si, kw, need)))
            for si in sids])
        parts = [p for p in parts if p is not None]
        total = sum(t for _si, _rows, t in parts)
        if latest:
            return merge_latest_parts(
                [(part, t) for _si, part, t in parts], page, page_size)
        else:
            # documented cross-shard tie order: (begin_ts DESC, shard
            # ASC, id ASC) — per-shard order is preserved, ties across
            # shards break deterministically so page N+1 never
            # re-serves or skips a row page N touched
            keyed = [(-r.begin_ts, si, r.id, r)
                     for si, part, _t in parts for r in part]
            keyed.sort(key=lambda t: t[:3])
            rows = []
            for _b, si, raw, r in keyed:
                r.id = encode_log_id(raw, si, self.nshards)
                rows.append(r)
        return rows[(page - 1) * page_size: page * page_size], total

    def get_log(self, log_id: int) -> Optional[LogRecord]:
        raw, si = decode_log_id(int(log_id), self.nshards)
        rec = self.shards[si].get_log(raw)
        if rec is not None and rec.id is not None:
            rec.id = encode_log_id(rec.id, si, self.nshards)
        return rec

    # ---- stats (exact per-shard summation) -------------------------------

    @staticmethod
    def _sum_stats(parts: List[dict]) -> dict:
        return {k: sum(p[k] for p in parts)
                for k in ("total", "successed", "failed")}

    def stat_overall(self) -> dict:
        parts = self._fan([
            self._tolerant(i, lambda s=s: s.stat_overall())
            for i, s in enumerate(self.shards)])
        return self._sum_stats([p for p in parts if p is not None])

    def stat_day(self, day: str) -> dict:
        parts = self._fan([
            self._tolerant(i, lambda s=s: s.stat_day(day))
            for i, s in enumerate(self.shards)])
        return self._sum_stats([p for p in parts if p is not None])

    def stat_days(self, n_days: int) -> List[dict]:
        parts = self._fan([
            self._tolerant(i, lambda s=s: s.stat_days(n_days))
            for i, s in enumerate(self.shards)])
        return merge_stat_days([p for p in parts if p is not None],
                               n_days)

    # ---- change revision / ops -------------------------------------------

    def revision(self) -> List[int]:
        """Per-shard revision VECTOR (each entry that shard's max
        record id) — the web tier's ETag key and a follow poller's
        tail-cursor bootstrap in one read."""
        return self._fan([lambda s=s: s.revision() for s in self.shards])

    def tail_snapshot(self, limit: int = 0):
        """Per-shard atomic (revision, tail) snapshots, merged: the
        vector is each shard's snapshot revision, the tail is the last
        ``limit`` records under the cursor merge order (raw id, shard)
        with ENCODED ids.  Each shard's pair is atomic, so a cursor
        bootstrapped at this vector never skips a record that was
        visible in (or before) the returned tail."""
        parts = self._fan([lambda si=si: self.shards[si].tail_snapshot(limit)
                           for si in range(self.nshards)])
        vec = [rev for rev, _recs in parts]
        merged = [(r.id, si, r) for si, (_rev, recs) in enumerate(parts)
                  for r in recs]
        merged.sort(key=lambda t: (t[0], t[1]))
        out = []
        for raw, si, r in merged[-limit:] if limit else []:
            r.id = encode_log_id(raw, si, self.nshards)
            out.append(r)
        return vec, out

    def subscribe(self, after_id=0, cap: int = 8192
                  ) -> ShardedLogSubscription:
        """Merged live change stream across every shard.  ``after_id``
        is a per-shard cursor VECTOR (scalar <= 0 means from-now on
        every shard) — the same shape ``query_logs`` cursor mode takes
        and ``tail_snapshot`` returns.  Delivered events carry ENCODED
        ids; resume from ``sub.vector``."""
        if isinstance(after_id, (list, tuple)):
            if len(after_id) != self.nshards:
                raise ValueError(
                    f"cursor vector has {len(after_id)} entries for "
                    f"{self.nshards} shards")
            vec = [int(v) for v in after_id]
        elif int(after_id) <= 0:
            vec = [0] * self.nshards
        else:
            raise ValueError(
                "a sharded sink subscribes from a per-shard cursor "
                "vector (sub.vector), not a scalar id")
        return ShardedLogSubscription(self, vec, cap)

    def age_out(self, now=None) -> int:
        """Run a cold-aging pass on every shard; returns total aged."""
        return sum(self._fan([lambda s=s: s.age_out(now)
                              for s in self.shards]))

    def tier_info(self) -> List[dict]:
        """Per-shard tiering snapshots, shard order."""
        return self._fan([lambda s=s: s.tier_info() for s in self.shards])

    def op_stats(self) -> dict:
        """Per-op stats MERGED across shards (counts/total summed,
        max_ms maxed) — same shape as a single sink's."""
        parts = self.op_stats_shards()
        if len(parts) == 1:
            return parts[0]
        merged: Dict[str, dict] = {}
        for part in parts:
            for op, ent in part.items():
                m = merged.setdefault(op, {"count": 0, "total_ms": 0.0,
                                           "max_ms": 0.0})
                m["count"] += ent.get("count", 0)
                m["total_ms"] = round(
                    m["total_ms"] + ent.get("total_ms", 0.0), 3)
                m["max_ms"] = max(m["max_ms"], ent.get("max_ms", 0.0))
        return merged

    def op_stats_shards(self) -> List[dict]:
        """Per-SHARD op stats, shard order — /v1/metrics renders these
        with a ``shard`` label when more than one is present.  A
        degraded shard reports ``{}`` (metrics scraping must not stall
        behind a browned-out shard)."""
        return self._fan([
            self._tolerant(i, lambda s=s: s.op_stats(), default={})
            for i, s in enumerate(self.shards)])

    def logmap(self, n=None, hash=None):
        return self.shards[0].logmap(n, hash)

    # ---- trace plane -----------------------------------------------------

    def trace_get(self, job_id: str, epoch_s: int) -> list:
        """One trace lives on ONE shard (spans route by job token with
        their records) — a direct read, no scatter."""
        return self.shards[self._idx(job_id)].trace_get(job_id,
                                                        int(epoch_s))

    def trace_top(self, n: int = 256) -> list:
        """Recent-trace summaries from every shard, concatenated (the
        web tier sorts); a degraded shard contributes nothing."""
        parts = self._fan([
            self._tolerant(i, lambda s=s, m=n: s.trace_top(m),
                           default=[])
            for i, s in enumerate(self.shards)])
        return [t for part in parts for t in (part or [])]

    def trace_stats(self) -> dict:
        """Per-stage histogram counters SUMMED across shards — sound
        because the bucket bounds are fixed fleet-wide."""
        parts = self._fan([
            self._tolerant(i, lambda s=s: s.trace_stats(), default={})
            for i, s in enumerate(self.shards)])
        merged: dict = {"spans_total": 0, "stages": {}}
        for part in parts:
            if not part:
                continue
            merged["spans_total"] += part.get("spans_total", 0)
            for stage, ent in (part.get("stages") or {}).items():
                m = merged["stages"].setdefault(
                    stage, {"buckets": [0] * len(ent.get("buckets", [])),
                            "sum": 0.0, "count": 0})
                b = m["buckets"]
                for i, v in enumerate(ent.get("buckets", [])):
                    if i >= len(b):
                        b.extend([0] * (i + 1 - len(b)))
                    b[i] += int(v)
                m["sum"] = round(m["sum"] + ent.get("sum", 0.0), 3)
                m["count"] += ent.get("count", 0)
        return merged

    # ---- node mirror + accounts (tiny, single-writer: shard 0) -----------

    def upsert_node(self, node_id: str, doc: str, alived: bool):
        self.shards[0].upsert_node(node_id, doc, alived)

    def set_node_alived(self, node_id: str, alived: bool):
        self.shards[0].set_node_alived(node_id, alived)

    def get_nodes(self) -> List[dict]:
        return self.shards[0].get_nodes()

    def get_node(self, node_id: str) -> Optional[dict]:
        return self.shards[0].get_node(node_id)

    def upsert_account(self, email: str, doc: str):
        self.shards[0].upsert_account(email, doc)

    def get_account(self, email: str) -> Optional[str]:
        return self.shards[0].get_account(email)

    def list_accounts(self) -> List[str]:
        return self.shards[0].list_accounts()

    def delete_account(self, email: str) -> bool:
        return self.shards[0].delete_account(email)

    # ---- lifecycle -------------------------------------------------------

    def close(self):
        for s in self._raw:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def reshard_sinks(src: Sequence, dst: Sequence, batch: int = 500,
                  on_log=None) -> dict:
    """Online-resharding escape hatch: dump every record from the
    ``src`` shard set, rehash by job token under the ``dst`` layout,
    and load — closing the "record ids encode the shard count" trap
    (ids are re-encoded ``raw' * N' + shard'`` as the destination
    assigns them; the destination ``logmap`` is re-pinned to N').

    The dump rides per-shard cursors (``after_id`` from 0 — the tiered
    backends merge their COLD segments below the watermark, so aged
    history migrates too) and merges by (raw id, shard), the sharded
    cursor order; the load preserves that order, so each destination
    shard's per-job id order matches the source's and the rebuilt
    latest/stat tables land identical (stats for records the source
    had already retention-evicted cannot migrate — reported loudly in
    the summary as ``stat_shortfall``).

    ``src``/``dst`` are lists of sink clients (RemoteJobLogStore in
    production; in-process JobLogStore in tests).  Destination shards
    must be EMPTY (revision 0) and unpinned — refusing a half-full
    target beats interleaving two id spaces."""
    log_ = on_log or (lambda *a: None)
    if not src or not dst:
        raise ValueError("reshard needs at least one source and one "
                         "destination shard")
    sgot = src[0].logmap()
    if sgot is not None and sgot.get("n") != len(src):
        raise RuntimeError(
            f"source logmap {sgot!r} does not match the provided "
            f"{len(src)} source addresses — a partial source set would "
            "silently drop the missing shards' history")
    for i, s in enumerate(dst):
        rev = s.revision()
        if rev != 0:
            raise RuntimeError(
                f"destination shard {i} is not empty (revision {rev}) — "
                "reshard loads into a fresh shard set")
    got = dst[0].logmap()
    if got is not None and got.get("n") != len(dst):
        raise RuntimeError(
            f"destination logmap {got!r} does not match the "
            f"{len(dst)}-shard layout")
    out_sink = ShardedJobLogStore(dst) if len(dst) > 1 else dst[0]

    # dump: per-source-shard cursors, merged by (raw id, shard) — the
    # sharded cursor order — loaded in that order per batch
    cursors = [0] * len(src)
    done = [False] * len(src)
    moved = 0
    while not all(done):
        rows_batch = []
        for si, s in enumerate(src):
            if done[si]:
                continue
            rows, _t = s.query_logs(after_id=cursors[si], page=1,
                                    page_size=batch)
            if not rows:
                done[si] = True
                continue
            cursors[si] = rows[-1].id
            rows_batch.extend((r.id, si, r) for r in rows)
        if not rows_batch:
            break
        rows_batch.sort(key=lambda t: (t[0], t[1]))
        recs = []
        for _raw, _si, r in rows_batch:
            r.id = None          # destination assigns its own raw ids
            recs.append(r)
        out_sink.create_job_logs(recs)
        moved += len(recs)
        log_(f"reshard: moved {moved} records")

    # node mirror + accounts pin to shard 0 on both layouts
    nodes = 0
    for d in src[0].get_nodes():
        doc = dict(d)
        alived = bool(doc.pop("alived", False))
        out_sink.upsert_node(doc.get("id", ""), json.dumps(doc), alived)
        nodes += 1
    accounts = 0
    for doc in src[0].list_accounts():
        email = json.loads(doc).get("email", "")
        if email:
            out_sink.upsert_account(email, doc)
            accounts += 1

    def latest_map(sink_or_shards):
        out: Dict[tuple, float] = {}
        clients = sink_or_shards if isinstance(sink_or_shards, list) \
            else [sink_or_shards]
        for cl in clients:
            page = 1
            while True:
                rows, _t = cl.query_logs(latest=True, page=page,
                                         page_size=500)
                out.update(((r.job_id, r.node), r.begin_ts)
                           for r in rows)
                if len(rows) < 500:
                    break
                page += 1
        return out

    src_total = sum(s.stat_overall()["total"] for s in src)
    dst_total = out_sink.stat_overall()["total"]
    # the latest view survives retention (it summarizes ALL history),
    # but the destination rebuilds it purely from migrated records — a
    # (job, node) whose every record was evicted cannot reappear, and
    # one whose NEWEST record was evicted rebuilds from an older run.
    # Both counted and warned, not silently shrunk/regressed.
    src_latest = latest_map(src)
    dst_latest = latest_map(out_sink)
    lost_latest = set(src_latest) - set(dst_latest)
    stale_latest = {p for p, ts in dst_latest.items()
                    if p in src_latest and ts < src_latest[p]}
    summary = {"records": moved, "nodes": nodes, "accounts": accounts,
               "src_stat_total": src_total, "dst_stat_total": dst_total,
               "stat_shortfall": src_total - dst_total,
               "latest_shortfall": len(lost_latest),
               "latest_stale": len(stale_latest)}
    if summary["stat_shortfall"]:
        log_(f"reshard: WARNING — {summary['stat_shortfall']} executions "
             "counted in the source stats have no surviving record "
             "(retention-evicted before the reshard); the destination "
             "counters reflect migrated records only")

    def name_pairs(pairs):
        return (", ".join(f"{j}@{n}" for j, n in sorted(pairs)[:5])
                + ("…" if len(pairs) > 5 else ""))
    if lost_latest:
        log_(f"reshard: WARNING — {len(lost_latest)} (job, node) latest-"
             "status rows had no surviving record to rebuild from "
             "(fully retention-evicted jobs); they are absent from the "
             "destination's latest view: " + name_pairs(lost_latest))
    if stale_latest:
        log_(f"reshard: WARNING — {len(stale_latest)} (job, node) "
             "latest-status rows rebuilt from an OLDER surviving run "
             "(the newest record was retention-evicted): "
             + name_pairs(stale_latest))
    return summary


def verify_single_sink(sink):
    """Topology pin for a SINGLE-address client: a stale one-logd
    config pointed at shard 0 of a multi-shard layout must refuse (it
    would see a fraction of every job's history and write new records
    into the wrong id space), not silently serve.  Read-only — an
    un-sharded deployment never writes the pin, so its behavior is
    unchanged."""
    try:
        got = sink.logmap()
    except Exception:  # noqa: BLE001 — pre-logmap server: nothing to pin
        return
    if got is None:
        return
    if not isinstance(got, dict) or got.get("n") != 1:
        raise RuntimeError(
            f"logmap mismatch: result-store set was laid out as {got!r}, "
            "this client is configured for a single result store — "
            "refusing to scatter one job's history under two topologies")


def connect_sharded_sink(addrs: Sequence[str], timeout: float = 10.0,
                         token: str = "", sslctx=None,
                         tls_hostname: str = ""):
    """Connect a routing client to a logd shard set.  One address
    returns a plain RemoteJobLogStore (byte-identical single-sink
    behavior) after the read-only pin check; several return a
    ShardedJobLogStore that pins/verifies the logmap."""
    from .serve import RemoteJobLogStore
    addrs = [a for a in addrs if a]
    if not addrs:
        raise ValueError("logsink address list has no host:port entries")
    conns = []
    try:
        for addr in addrs:
            host, _, port = addr.rpartition(":")
            conns.append(RemoteJobLogStore(host or "127.0.0.1", int(port),
                                           timeout=timeout, token=token,
                                           sslctx=sslctx,
                                           tls_hostname=tls_hostname))
    except BaseException:
        for c in conns:
            c.close()
        raise
    if len(conns) == 1:
        try:
            verify_single_sink(conns[0])
        except BaseException:
            conns[0].close()
            raise
        return conns[0]
    return ShardedJobLogStore(conns)
