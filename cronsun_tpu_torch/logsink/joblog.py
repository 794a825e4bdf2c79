"""SQLite-backed execution log + stats + account storage, TIERED.

Mirrors the reference's Mongo collections and their access patterns:

- ``job_log``      — one row per execution (job_log.go:19-31)
- ``job_latest_log`` — latest row per (job, node) (job_log.go:12-16, upsert
  at job_log.go:103-117)
- ``stat``         — overall + per-day success/fail counters
  (job_log.go:118-132)
- ``node``         — liveness mirror for the UI (node.go:129-142)
- ``account``      — web users (account.go:67-105)

Thread-safe (single connection + lock; WAL mode).

Tiering (default ON; ``CRONSUN_TIERING=off`` or ``tiering=False`` is
the rollback switch and preserves the untiered behavior exactly):

- **hot tier** — in-memory mirrors behind their OWN lock (``_hot_mu``):
  the latest-per-(job, node) map, the per-day stat counters, and the
  most recent records (a contiguous id suffix, bounded by
  ``hot_max_records``), rebuilt from the DB on boot.  They answer the
  dashboard shapes — ``query_logs(latest=True)``, cursor-mode follow
  polls, ``stat_overall``/``stat_day``/``stat_days``, ``get_log`` of a
  recent id, ``revision`` and ``tail_snapshot`` — without touching
  SQL, so a poll never queues behind the write path's bulk commit.
  Results are byte-identical to the SQL path (same filters, same
  documented tie orders), pinned by a randomized differential test.
- **cold tier** — when ``hot_days`` > 0 and the store is file-backed,
  :meth:`age_out` moves records whose UTC day fell out of the hot
  window into immutable per-day segment files (``<db>.segs/<day>.seg``,
  format shared with native/logd.cc — see logsink/tiering.py) behind a
  prefix watermark (``cold_boundary``): segments are written + fsynced
  FIRST, then one SQL transaction deletes the rows and advances the
  watermark, so a crash between the two replays idempotently (the redo
  unions the same rows into the same bytes).  History/cursor queries
  that reach below the watermark merge cold + hot with the documented
  tie order; cold segments stay readable even with tiering off, so the
  rollback switch never hides data.

Per-op attribution: any read that runs SQL records op ``query_sql``;
hot-served shapes record ``q_latest_hot`` / ``q_cursor_hot`` /
``q_stat_hot`` / ``q_get_hot``; cold merges count ``q_history_cold`` /
``q_cursor_cold`` / ``q_get_cold`` — the bench's hot-hit ratio and the
CI "zero SQL on the hot shapes" smoke read these.

Copy of ``cronsun_tpu/logsink/joblog.py``; the only difference: the
reference's source is cited by its own paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
import string
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job_log (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  job_id TEXT NOT NULL, job_group TEXT NOT NULL, name TEXT NOT NULL,
  node TEXT NOT NULL, job_user TEXT DEFAULT '', command TEXT DEFAULT '',
  output TEXT DEFAULT '', success INTEGER NOT NULL,
  begin_ts REAL NOT NULL, end_ts REAL NOT NULL);
CREATE INDEX IF NOT EXISTS il_job ON job_log(job_id, begin_ts DESC);
CREATE INDEX IF NOT EXISTS il_node ON job_log(node, begin_ts DESC);
CREATE INDEX IF NOT EXISTS il_begin ON job_log(begin_ts DESC);

CREATE TABLE IF NOT EXISTS job_latest_log (
  job_id TEXT NOT NULL, node TEXT NOT NULL,
  job_group TEXT NOT NULL, name TEXT NOT NULL,
  job_user TEXT DEFAULT '', command TEXT DEFAULT '', output TEXT DEFAULT '',
  success INTEGER NOT NULL, begin_ts REAL NOT NULL, end_ts REAL NOT NULL,
  PRIMARY KEY (job_id, node));

CREATE TABLE IF NOT EXISTS stat (
  day TEXT PRIMARY KEY,           -- '' = overall
  total INTEGER NOT NULL DEFAULT 0,
  successed INTEGER NOT NULL DEFAULT 0,
  failed INTEGER NOT NULL DEFAULT 0);

CREATE TABLE IF NOT EXISTS node (
  id TEXT PRIMARY KEY, doc TEXT NOT NULL, alived INTEGER NOT NULL DEFAULT 0);

CREATE TABLE IF NOT EXISTS account (
  email TEXT PRIMARY KEY, doc TEXT NOT NULL);

CREATE TABLE IF NOT EXISTS meta (
  k TEXT PRIMARY KEY, v TEXT NOT NULL);
"""

# SQLite's default LIKE is case-insensitive for ASCII ONLY; the hot
# path must match it (and native/logd.cc's contains_nocase) exactly
_ASCII_LOWER = str.maketrans(string.ascii_uppercase, string.ascii_lowercase)


@dataclasses.dataclass
class LogRecord:
    job_id: str
    job_group: str
    name: str
    node: str
    user: str
    command: str
    output: str
    success: bool
    begin_ts: float
    end_ts: float
    id: Optional[int] = None

    @property
    def seconds(self) -> float:
        return max(0.0, self.end_ts - self.begin_ts)


_UNSET = object()


class SubscriptionLost(Exception):
    """The subscriber fell behind its bounded buffer (or the stream
    died): pending events were dropped.  The consumer re-lists (cursor
    query from its last delivered id) and re-subscribes — the store
    watch plane's ``WatchLost`` contract, result-plane edition."""


def sub_event(r: LogRecord) -> tuple:
    """The change-stream summary of one record: the 8 fields a
    dashboard row needs, WITHOUT user/command/output (a stream carrying
    every job's stdout would make one chatty job the fan-out's
    bandwidth ceiling; the detail endpoint serves bodies by id).  Wire
    form is the same fields as a JSON list, both backends byte-alike:
    ``[id, job_id, job_group, name, node, success, begin_ts,
    end_ts]``."""
    return (r.id, r.job_id, r.job_group, r.name, r.node, r.success,
            r.begin_ts, r.end_ts)


class LogSubscription:
    """A bounded, lossy, per-subscriber event buffer (the store's
    watcher shape: ``on_ready`` callback for pump loops, blocking
    ``get`` for thread-per-subscription consumers).  Writers push
    summaries; overflow drops EVERYTHING pending and latches ``lost``
    — a slow consumer costs itself a re-list, never the writer a
    stall."""

    def __init__(self, store, cap: int = 4096):
        self._store = store
        self._cap = max(1, int(cap))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._buf: deque = deque()
        self.lost = False
        self.closed = False
        # set by subscribe(): the revision the stream starts after, and
        # whether the requested resume gap was NOT replayable (the
        # consumer re-lists once; the stream itself is live from rev)
        self.rev = 0
        self.gap = False
        self.on_ready = None       # pump nudge: called outside _mu

    def _push(self, evs) -> None:
        """Writer side — events for this subscriber (already
        filtered/ordered).  Never blocks."""
        if not evs:
            return
        with self._cv:
            if self.lost or self.closed:
                return
            if len(self._buf) + len(evs) > self._cap:
                self._buf.clear()
                self.lost = True
            else:
                self._buf.extend(evs)
            self._cv.notify_all()
            ready = self.on_ready
        if ready is not None:
            ready(self)

    def drain(self) -> list:
        """All pending events, non-blocking.  Raises
        :class:`SubscriptionLost` once the buffer overflowed (after
        which the subscription is dead)."""
        with self._cv:
            if self.lost:
                raise SubscriptionLost("log subscription overflowed")
            out = list(self._buf)
            self._buf.clear()
        return out

    def get(self, timeout: Optional[float] = None) -> list:
        """Pending events, blocking up to ``timeout`` for the first one
        (empty list on timeout).  Raises :class:`SubscriptionLost` when
        the buffer overflowed or the stream closed under the consumer."""
        with self._cv:
            if not self._buf and not self.lost and not self.closed:
                self._cv.wait(timeout)
            if self.lost:
                raise SubscriptionLost("log subscription overflowed")
            if self.closed and not self._buf:
                raise SubscriptionLost("log subscription closed")
            out = list(self._buf)
            self._buf.clear()
        return out

    def close(self):
        store, self._store = self._store, None
        if store is not None:
            store.unsubscribe(self)
        with self._cv:
            self.closed = True
            self._cv.notify_all()


def copy_rec(r: LogRecord, id=_UNSET) -> LogRecord:
    """Positional-field copy — ~6x faster than dataclasses.replace
    (which routes through __init__ via a keyword dict); the hot read
    paths copy every returned row, so this is per-poll cost."""
    return LogRecord(r.job_id, r.job_group, r.name, r.node, r.user,
                     r.command, r.output, r.success, r.begin_ts,
                     r.end_ts, r.id if id is _UNSET else id)


def tiering_default() -> bool:
    """The rollback switch: ``CRONSUN_TIERING=off`` disables the hot
    mirrors (and day-based aging) everywhere — today's scan-per-poll
    behavior, exactly."""
    return os.environ.get("CRONSUN_TIERING", "").lower() not in (
        "off", "0", "false")


class JobLogStore:
    """``retain`` > 0 bounds execution-history rows (oldest evicted on
    insert), mirroring the native logd's --retain: the stats counters
    and the latest-status table — which summarize all history — are
    never evicted, so dashboards stay exact while disk stays bounded.
    The reference keeps Mongo job_log forever (no TTL index anywhere in
    the reference's db/ or job_log.go) — unbounded (0) matches that, the
    cap is the operational improvement.

    ``hot_days`` > 0 (file-backed stores only) turns on cold aging:
    days out of the hot window move to immutable segment files (see
    module docstring).  ``hot_max_records`` bounds the in-memory record
    mirror; reads below it fall back to SQL, correctness unchanged."""

    def __init__(self, path: str = ":memory:", retain: int = 0,
                 tiering: Optional[bool] = None, hot_days: int = 0,
                 hot_max_records: int = 200_000):
        self._lock = threading.RLock()
        self._retain = max(0, int(retain))
        self._path = path
        self._tier = tiering_default() if tiering is None else bool(tiering)
        self._hot_days = max(0, int(hot_days))
        self._hot_max = max(1, int(hot_max_records))
        # per-op timing (memstore.op_stats parity): lets a bench — and
        # /v1/metrics — attribute the result plane's ceiling to a named
        # op (bulk create vs query) instead of "the sink"
        from ..metrics import OpStats
        self._ops = OpStats()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        # hot-tier state: its OWN lock, so dashboard reads never queue
        # behind the SQL lock a bulk flush is committing under.  Writers
        # mutate the mirrors INSIDE self._lock (ordering) but only hold
        # _hot_mu for the in-memory update.
        self._hot_mu = threading.Lock()
        self._h_latest: dict = {}          # (job_id, node) -> LogRecord
        self._h_latest_sorted = None       # memo: pinned-order view, or
        #   None after any latest change — a dashboard polling between
        #   write batches reuses the sort instead of re-keying 512 rows
        self._h_stats: dict = {}           # day ('' = overall) -> [t, s, f]
        self._h_recs: deque = deque()      # contiguous-id record suffix
        self._h_rev = 0                    # max id ever assigned
        self._cold_boundary = 0            # ids <= this live in segments
        self._segments: list = []          # tiering.scan_segments index
        self._age_mu = threading.Lock()    # one age-out pass at a time
        # change-stream plane: live subscriptions (registered and fed
        # under self._lock, so a subscriber snapshot-then-register can
        # never miss a record between its revision and its first event)
        self._subs: dict = {}
        # trace plane: bounded span ring + per-day spill beside the
        # tiered store's segment directory (file-backed sinks only)
        from .traces import TraceStore
        self.traces = TraceStore(
            spill_dir=None if path == ":memory:" else path + ".traces")
        with self._lock:
            if path != ":memory:":
                self._db.execute("PRAGMA journal_mode=WAL")
                # WAL + NORMAL: no fsync per commit (the WAL is synced at
                # checkpoint); a power loss can drop the last moments of
                # execution history but cannot corrupt the DB — the right
                # trade for a result log whose writers retry anyway, and
                # ~10-20x the sustained create_job_log rate (the fsync was
                # the dispatch plane's bottleneck, not the store)
                self._db.execute("PRAGMA synchronous=NORMAL")
                self._db.execute("PRAGMA busy_timeout=5000")
            self._db.executescript(_SCHEMA)
            self._db.commit()
            self._boot_tiers()

    def _boot_tiers(self):
        """Rebuild the hot mirrors from the DB and index the cold
        segments — called under self._lock at boot.  The segment index
        and watermark load regardless of the tiering switch (a rollback
        must not hide already-aged data); the mirrors only when on."""
        from . import tiering as tg
        r = self._db.execute(
            "SELECT v FROM meta WHERE k='cold_boundary'").fetchone()
        self._cold_boundary = int(r["v"]) if r else 0
        self._segments = tg.scan_segments(tg.seg_dir(self._path))
        self._h_rev = self._sql_revision()
        if not self._tier:
            return
        for row in self._db.execute("SELECT * FROM stat"):
            self._h_stats[row["day"]] = [row["total"], row["successed"],
                                         row["failed"]]
        for row in self._db.execute("SELECT * FROM job_latest_log"):
            rec = self._row_to_rec(row, True)
            self._h_latest[(rec.job_id, rec.node)] = rec
        rows = self._db.execute(
            "SELECT * FROM job_log ORDER BY id DESC LIMIT ?",
            (self._hot_max,)).fetchall()
        for row in reversed(rows):
            self._h_recs.append(self._row_to_rec(row, False))

    def close(self):
        self.traces.close()
        with self._lock:
            for s in list(self._subs.values()):
                with s._cv:
                    s.closed = True
                    s._cv.notify_all()
            self._subs.clear()
            self._db.close()

    # ---- trace plane (fire-lifecycle spans) ------------------------------

    def trace_ingest(self, spans: list) -> int:
        t0 = time.perf_counter_ns()
        n = self.traces.ingest(spans)
        self._op_record("trace_ingest", t0)
        return n

    def trace_get(self, job_id: str, epoch_s: int) -> list:
        """Raw span dicts of one (job, second) trace — the web tier
        assembles the waterfall (trace.assemble)."""
        t0 = time.perf_counter_ns()
        out = self.traces.get(job_id, int(epoch_s))
        self._op_record("trace_get", t0)
        return out

    def trace_top(self, n: int = 256) -> list:
        return self.traces.top(int(n))

    def trace_stats(self) -> dict:
        """Cumulative per-stage histogram counters (fixed fleet-wide
        buckets — addable across shards and replicas)."""
        return self.traces.stats()

    # ---- op timing (delegates to the shared metrics.OpStats) -------------

    def _op_record(self, op: str, t0_ns: int):
        self._ops.record(op, t0_ns)

    def op_count(self, op: str, n: int = 1):
        """Count-only stat (no timing): per-record tallies under the
        bulk op — log_records / create_job_logs gives the observed
        batch size."""
        self._ops.count(op, n)

    def op_stats(self) -> dict:
        """Per-op timing snapshot: {op: {count, total_ms, max_ms}}."""
        return self._ops.snapshot()

    # ---- writes (the 4-write pattern of CreateJobLog) --------------------

    def create_job_log(self, rec: LogRecord, idem: str = ""):
        # ``idem`` is accepted for surface parity with the networked
        # sink (the agents' per-record degraded path passes a stable
        # token); in-process writes have no reply to lose, so unused
        del idem
        t0 = time.perf_counter_ns()
        with self._lock:
            day = self._create_locked(rec)
            self._db.commit()
            if self._tier:
                ok = 1 if rec.success else 0
                with self._hot_mu:
                    self._mirror_locked([(rec, ok)],
                                        {day: (1, ok, 1 - ok)}, rec.id)
            if self._subs:
                self._sub_emit([rec])
        self._op_record("create_job_log", t0)

    def _create_locked(self, rec: LogRecord) -> str:
        """The 4-write pattern, no commit — caller owns the transaction.
        Returns the record's day key."""
        day = time.strftime("%Y-%m-%d", time.gmtime(rec.begin_ts))
        ok = 1 if rec.success else 0
        self._insert_log_locked(rec, ok)
        if self._retain:
            # ids stay monotone (only the oldest rows are ever
            # deleted, so max rowid never frees), making the cap a
            # single indexed range delete per insert
            self._db.execute("DELETE FROM job_log WHERE id <= ?",
                             (rec.id - self._retain,))
        self._upsert_latest_locked(rec, ok)
        for d in ("", day):
            self._bump_stat_locked(d, 1, ok, 1 - ok)
        return day

    # the three statements of the 4-write pattern, shared by the single
    # path (one each per record) and the bulk path (insert per record,
    # latest/stat coalesced per batch) so the SQL exists exactly once

    def _insert_log_locked(self, rec: LogRecord, ok: int) -> int:
        cur = self._db.execute(
            "INSERT INTO job_log (job_id, job_group, name, node, "
            "job_user, command, output, success, begin_ts, end_ts) "
            "VALUES (?,?,?,?,?,?,?,?,?,?)",
            (rec.job_id, rec.job_group, rec.name, rec.node, rec.user,
             rec.command, rec.output, ok, rec.begin_ts, rec.end_ts))
        rec.id = cur.lastrowid
        return rec.id

    def _upsert_latest_locked(self, rec: LogRecord, ok: int):
        self._db.execute(
            "INSERT INTO job_latest_log VALUES (?,?,?,?,?,?,?,?,?,?) "
            "ON CONFLICT(job_id, node) DO UPDATE SET "
            "job_group=excluded.job_group, name=excluded.name, "
            "job_user=excluded.job_user, command=excluded.command, "
            "output=excluded.output, success=excluded.success, "
            "begin_ts=excluded.begin_ts, end_ts=excluded.end_ts",
            (rec.job_id, rec.node, rec.job_group, rec.name, rec.user,
             rec.command, rec.output, ok, rec.begin_ts, rec.end_ts))

    def _bump_stat_locked(self, day: str, total: int, ok_n: int,
                          fail_n: int):
        self._db.execute(
            "INSERT INTO stat (day, total, successed, failed) "
            "VALUES (?,?,?,?) ON CONFLICT(day) DO UPDATE SET "
            "total=total+excluded.total, "
            "successed=successed+excluded.successed, "
            "failed=failed+excluded.failed",
            (day, total, ok_n, fail_n))

    def _mirror_locked(self, recs_ok, day_deltas: dict, last_id: int):
        """Apply a committed batch to the hot mirrors — caller holds
        ``_hot_mu``.  ``recs_ok`` is [(rec, ok)] in insert order;
        records are COPIED in (callers — the sharded client, tests —
        mutate rec.id after create; the mirror must keep the raw id)."""
        for rec, ok in recs_ok:
            cp = copy_rec(rec)
            self._h_recs.append(cp)
            # mirror entries are REPLACED, never mutated in place: a
            # reader borrowing the sorted memo outside the lock keeps a
            # consistent snapshot
            self._h_latest[(cp.job_id, cp.node)] = copy_rec(cp, id=None)
        self._h_latest_sorted = None
        for day, (t, s, f) in day_deltas.items():
            for d in ("", day) if day else ("",):
                ent = self._h_stats.setdefault(d, [0, 0, 0])
                ent[0] += t
                ent[1] += s
                ent[2] += f
        self._h_rev = last_id
        floor = last_id - self._retain if self._retain else 0
        while self._h_recs and (self._h_recs[0].id <= floor
                                or len(self._h_recs) > self._hot_max):
            self._h_recs.popleft()

    def create_job_logs(self, recs, idem: str = "",
                        spans: Optional[list] = None) -> list:
        """Bulk insert: the agents' record flushers write whole batches
        in ONE transaction (one fsync).  The per-record side writes
        COALESCE per batch — one stat UPDATE per (day) touched plus one
        for the overall row, one latest-log upsert per (job, node)
        (the last record in batch order wins, exactly the sequential
        outcome), one retention trim — so a 1k-record batch pays ~4
        auxiliary statements, not 4k.  The hot mirrors apply the whole
        batch under ONE ``_hot_mu`` hold, so a concurrent hot read sees
        none or all of it — the same all-or-nothing a reader of the SQL
        transaction sees.  Returns the assigned row ids in order.
        ``idem`` is accepted for surface parity with the networked
        sink; in-process writes have no reply to lose, so it is
        unused.  ``spans`` is the trace plane's piggybacked sidecar —
        ingested into the trace ring/spill before the row writes (its
        merge is LWW-idempotent, so ordering vs the transaction does
        not matter)."""
        del idem
        if spans:
            self.trace_ingest(spans)
        if not recs:
            return []
        t0 = time.perf_counter_ns()
        with self._lock:
            try:
                ids = []
                latest: dict = {}
                days: dict = {}
                mirror = []
                for rec in recs:
                    day = time.strftime("%Y-%m-%d",
                                        time.gmtime(rec.begin_ts))
                    ok = 1 if rec.success else 0
                    ids.append(self._insert_log_locked(rec, ok))
                    mirror.append((rec, ok))
                    latest[(rec.job_id, rec.node)] = (rec, ok)
                    t, s, f = days.get(day, (0, 0, 0))
                    days[day] = (t + 1, s + ok, f + 1 - ok)
                if self._retain:
                    # ids stay monotone (only the oldest rows are ever
                    # deleted), making the cap one indexed range delete
                    # per batch
                    self._db.execute("DELETE FROM job_log WHERE id <= ?",
                                     (ids[-1] - self._retain,))
                for rec, ok in latest.values():
                    self._upsert_latest_locked(rec, ok)
                totals = [sum(v[i] for v in days.values())
                          for i in range(3)]
                for d, (t, s, f) in [("", tuple(totals))] + \
                        sorted(days.items()):
                    self._bump_stat_locked(d, t, s, f)
                self._db.commit()
            except Exception:
                # all-or-nothing: a mid-batch failure (SQLITE_BUSY past
                # the busy timeout, disk full) must not leave the head
                # rows pending in the implicit transaction — the
                # caller's retry re-sends the WHOLE batch, and a later
                # unrelated commit would otherwise flush the stale head
                # alongside it (duplicated rows + double-counted stats)
                self._db.rollback()
                raise
            if self._tier:
                with self._hot_mu:
                    self._mirror_locked(mirror, days, ids[-1])
            if self._subs:
                self._sub_emit([r for r, _ in mirror])
        self._op_record("create_job_logs", t0)
        self.op_count("log_records", len(ids))
        return ids

    # ---- queries (web/job_log.go:18-113) ---------------------------------

    @staticmethod
    def _hot_match(node, job_ids, name_like, begin, end, failed_only):
        """Predicate replicating the SQL WHERE semantics exactly:
        substring name match is ASCII-case-insensitive (SQLite's
        default LIKE; native contains_nocase pins the same).  Returns
        None when there is nothing to filter (every row matches)."""
        if not (node or job_ids or name_like or failed_only) and \
                begin is None and end is None:
            return None
        needle = name_like.translate(_ASCII_LOWER) if name_like else None
        job_set = set(job_ids) if job_ids else None

        def match(r: LogRecord) -> bool:
            if node and r.node != node:
                return False
            if job_set is not None and r.job_id not in job_set:
                return False
            if needle is not None and \
                    needle not in r.name.translate(_ASCII_LOWER):
                return False
            if begin is not None and r.begin_ts < begin:
                return False
            if end is not None and r.begin_ts >= end:
                return False
            if failed_only and r.success:
                return False
            return True
        return match

    def _retain_floor(self, rev: int) -> int:
        """Records with id <= floor are evicted in the untiered store —
        the tiered read path filters cold rows to the same visible set
        so the two layouts answer byte-identically."""
        return rev - self._retain if self._retain else 0

    def query_logs(self, node: Optional[str] = None,
                   job_ids: Optional[List[str]] = None,
                   name_like: Optional[str] = None,
                   begin: Optional[float] = None,
                   end: Optional[float] = None,
                   failed_only: bool = False,
                   latest: bool = False,
                   page: int = 1, page_size: int = 50,
                   after_id: Optional[int] = None
                   ) -> Tuple[List[LogRecord], int]:
        """``after_id`` switches to cursor mode: only rows with
        ``id > after_id``, ordered by id ASCENDING — insertion order, so
        a poller (cronsun-ctl logs --follow) never misses a record that
        was inserted with an old begin_ts (ids are monotone; begin_ts is
        not).  Ignored for the latest view, whose rows have no id.

        Cursor mode returns ``total == -1``: the poller advances its
        cursor from the delivered ids and never reads the total, but
        computing it cost a full filtered COUNT(*) scan PER POLL — the
        one O(history) term left on the follow path.  Both backends
        pin the same -1.

        Tiered serving: the latest view and cursor polls that start at
        or above the hot window come straight from the mirrors (no
        SQL); history — and a cursor resuming below the cold watermark
        — merges SQL rows with the cold segments under the documented
        tie orders, byte-identical to an untiered store fed the same
        stream."""
        # clamp absurd page numbers (empty page, never an overflow —
        # the native backend pins the same bound)
        page = max(1, min(page, 1 << 40))
        page_size = max(1, min(page_size, 500))
        cursor_mode = after_id is not None and not latest
        if cursor_mode:
            after_id = int(after_id)
        match = self._hot_match(node, job_ids, name_like, begin, end,
                                failed_only)
        if self._tier and latest:
            return self._query_latest_hot(match, page, page_size)
        if self._tier and cursor_mode:
            hot = self._query_cursor_hot(match, after_id, page, page_size)
            if hot is not None:
                return hot
        return self._query_sql(node, job_ids, name_like, begin, end,
                               failed_only, latest, page, page_size,
                               after_id, cursor_mode, match)

    def _query_latest_hot(self, match, page, page_size):
        """The dashboard's landing view from the latest mirror: filter
        + the pinned (begin_ts DESC, job_id, node) order + paging, no
        SQL, no SQL lock.  The sort is memoized on the mirror
        generation — polls between write batches (the common dashboard
        cadence) filter a pre-sorted immutable list instead of
        re-keying every row."""
        t0 = time.perf_counter_ns()
        with self._hot_mu:
            lst = self._h_latest_sorted
            if lst is None:
                lst = sorted(self._h_latest.values(),
                             key=lambda r: (-r.begin_ts, r.job_id,
                                            r.node))
                self._h_latest_sorted = lst
        # outside the lock: writers REPLACE the memo (never mutate it
        # or its rows), so this borrowed list is a stable snapshot —
        # and the returned page SHARES its rows (id-less latest rows
        # are never mutated by any caller: the sharded client only
        # re-encodes ids, and there are none), so the common
        # unfiltered dashboard poll is a slice, not 500 copies
        rows = lst if match is None else [r for r in lst if match(r)]
        total = len(rows)
        out = rows[(page - 1) * page_size: page * page_size]
        self._op_record("q_latest_hot", t0)
        return list(out), total

    def _query_cursor_hot(self, match, after_id, page, page_size):
        """Follow-poll fast path: when every id > after_id is inside
        the record mirror, answer from the deque (ids are contiguous —
        the jump is an index, the scan O(new records)).  Returns None
        when the cursor reaches below the mirror (SQL/cold fallback)."""
        t0 = time.perf_counter_ns()
        with self._hot_mu:
            if self._h_recs:
                front = self._h_recs[0].id
                covered = after_id >= front - 1
            else:
                covered = after_id >= self._h_rev
            if not covered:
                return None
            hits = []
            start = max(0, after_id - self._h_recs[0].id + 1) \
                if self._h_recs else 0
            need = page * page_size
            # islice, not positional indexing: deque[i] walks from the
            # nearest end, turning a long scan O(n^2)
            from itertools import islice
            for r in islice(self._h_recs, start, None):
                if match is None or match(r):
                    hits.append(r)
                    if len(hits) >= need:
                        break
            # cursor rows are copied: the sharded client re-encodes
            # their ids in place
            out = [copy_rec(r)
                   for r in hits[(page - 1) * page_size:]]
        self._op_record("q_cursor_hot", t0)
        return out, -1

    def _sql_rows(self, cond: str, args: list, order: str,
                  need: int) -> List[LogRecord]:
        """Up to ``need`` job_log rows under ``cond`` in ``order`` —
        the SQL side of a tier merge."""
        rows = self._db.execute(
            f"SELECT * FROM job_log{cond} ORDER BY {order} LIMIT ?",
            args + [need]).fetchall()
        return [self._row_to_rec(r, False) for r in rows]

    def _query_sql(self, node, job_ids, name_like, begin, end,
                   failed_only, latest, page, page_size, after_id,
                   cursor_mode, match):
        table = "job_latest_log" if latest else "job_log"
        where, args = [], []
        if cursor_mode:
            where.append("id > ?"); args.append(after_id)
        if node:
            where.append("node = ?"); args.append(node)
        if job_ids:
            where.append(f"job_id IN ({','.join('?' * len(job_ids))})")
            args.extend(job_ids)
        if name_like:
            # plain substring semantics: LIKE metacharacters in the
            # needle are escaped so both result-store backends (this
            # SQLite one and the native in-memory one) agree
            esc = (name_like.replace("\\", "\\\\")
                   .replace("%", r"\%").replace("_", r"\_"))
            where.append(r"name LIKE ? ESCAPE '\'")
            args.append(f"%{esc}%")
        if begin is not None:
            where.append("begin_ts >= ?"); args.append(begin)
        if end is not None:
            where.append("begin_ts < ?"); args.append(end)
        if failed_only:
            where.append("success = 0")
        cond = (" WHERE " + " AND ".join(where)) if where else ""
        t0 = time.perf_counter_ns()
        need = page * page_size
        from . import tiering as tg
        with self._lock:
            # cold participation: only history/cursor reads that can
            # reach below the watermark (never the latest view — its
            # rows summarize all history and live hot/in SQL)
            cold_rows: List[LogRecord] = []
            cold_total = 0
            boundary = self._cold_boundary
            if self._segments and not latest and \
                    (not cursor_mode or after_id < boundary):
                rev = self._h_rev if self._tier else self._sql_revision()
                cold_rows, cold_total, touched = tg.cold_query(
                    self._segments, boundary, match, begin, end,
                    min_id=max(self._retain_floor(rev),
                               after_id if cursor_mode else 0),
                    keep=need, hist_order=not cursor_mode)
                if touched:
                    self.op_count("q_cursor_cold" if cursor_mode
                                  else "q_history_cold")
            if cursor_mode:
                total = -1
                if cold_rows:
                    # cold ids all precede SQL ids: concatenation IS
                    # id-ascending order
                    rows = (cold_rows[:need] +
                            self._sql_rows(cond, args, "id ASC", need))
                    rows = rows[(page - 1) * page_size: page * page_size]
                else:
                    rows = [self._row_to_rec(r, False) for r in
                            self._db.execute(
                                f"SELECT * FROM {table}{cond} ORDER BY "
                                "id ASC LIMIT ? OFFSET ?",
                                args + [page_size,
                                        (page - 1) * page_size])]
            else:
                total = self._db.execute(
                    f"SELECT COUNT(*) c FROM {table}{cond}",
                    args).fetchone()["c"] + cold_total
                # tie order pinned explicitly (id ASC within equal
                # begin_ts; the id-less latest view breaks ties by its
                # (job_id, node) primary key) so the native backend —
                # and the sharded client's scatter-gather merge — page
                # identically
                order = "begin_ts DESC" + (", job_id ASC, node ASC"
                                           if latest else ", id ASC")
                if cold_rows:
                    hot = self._sql_rows(cond, args, order, need)
                    cold_rows.sort(key=lambda r: (-r.begin_ts, r.id))
                    merged = sorted(cold_rows[:need] + hot,
                                    key=lambda r: (-r.begin_ts, r.id))
                    rows = merged[(page - 1) * page_size:
                                  page * page_size]
                else:
                    rows = [self._row_to_rec(r, latest) for r in
                            self._db.execute(
                                f"SELECT * FROM {table}{cond} ORDER BY "
                                f"{order} LIMIT ? OFFSET ?",
                                args + [page_size,
                                        (page - 1) * page_size])]
        self._op_record("query_sql", t0)
        return rows, total

    # get_log serves from the mirror only this close to the tail:
    # deque indexing walks from the nearest end, so a mid-mirror id at
    # hot_max_records=200k would cost a ~100k-node walk where the SQL
    # primary-key fetch is an O(log n) B-tree probe — "recent" ids are
    # the hot contract, the rest belong to SQL
    GET_HOT_TAIL = 1024

    def get_log(self, log_id: int) -> Optional[LogRecord]:
        log_id = int(log_id)
        if self._tier:
            t0 = time.perf_counter_ns()
            with self._hot_mu:
                if self._h_recs and \
                        self._h_recs[0].id <= log_id <= self._h_recs[-1].id \
                        and log_id >= self._h_recs[-1].id - self.GET_HOT_TAIL:
                    r = self._h_recs[log_id - self._h_recs[-1].id - 1]
                    self._op_record("q_get_hot", t0)
                    return copy_rec(r)
        with self._lock:
            boundary = self._cold_boundary
            if self._segments and log_id <= boundary:
                rev = self._h_rev if self._tier else self._sql_revision()
                if log_id <= self._retain_floor(rev):
                    return None
                from . import tiering as tg
                for seg in self._segments:
                    if seg["min"] <= log_id <= seg["max"]:
                        # sparse-index seek: parses O(stride) lines of
                        # the day, not the whole segment
                        for r in tg.read_segment_range(
                                seg["path"], lo=log_id, hi=log_id):
                            if r.id == log_id:
                                self.op_count("q_get_cold")
                                return r
                return None
            t0 = time.perf_counter_ns()
            r = self._db.execute("SELECT * FROM job_log WHERE id = ?",
                                 (log_id,)).fetchone()
            self._op_record("query_sql", t0)
        return self._row_to_rec(r, False) if r else None

    @staticmethod
    def _row_to_rec(r, latest: bool) -> LogRecord:
        return LogRecord(
            id=None if latest else r["id"],
            job_id=r["job_id"], job_group=r["job_group"], name=r["name"],
            node=r["node"], user=r["job_user"], command=r["command"],
            output=r["output"], success=bool(r["success"]),
            begin_ts=r["begin_ts"], end_ts=r["end_ts"])

    # ---- change revision + tail snapshot + topology pin ------------------

    def _sql_revision(self) -> int:
        r = self._db.execute(
            "SELECT seq FROM sqlite_sequence WHERE name='job_log'"
        ).fetchone()
        return int(r["seq"]) if r else 0

    def revision(self) -> int:
        """Monotone change token for the read plane: the max record id
        ever assigned (0 when empty).  Every create bumps it; retention
        trims only the oldest rows so it never regresses — the web
        tier's revision-keyed ETag (and a follow poller's tail
        bootstrap) key off this instead of re-running the query.

        Tiered, this reads the mirror — which advances in the same
        critical section that makes the records queryable, so a cursor
        bootstrapped at this revision can never skip a record that was
        visible before it."""
        if self._tier:
            with self._hot_mu:
                return self._h_rev
        with self._lock:
            return self._sql_revision()

    def tail_snapshot(self, limit: int = 0) -> Tuple[int, List[LogRecord]]:
        """Revision AND the last ``limit`` records from ONE snapshot
        (one lock acquisition).  The follow bootstrap needs both
        atomically: reading them in two steps lets a record land in
        between — present in neither the tail page nor the follow
        stream keyed ``id > revision`` — and be skipped forever."""
        limit = max(0, min(int(limit), 500))
        if self._tier:
            from itertools import islice
            with self._hot_mu:
                rev = self._h_rev
                n = len(self._h_recs)
                recs = [copy_rec(r) for r in
                        islice(self._h_recs, max(0, n - limit), None)]
            return rev, recs
        with self._lock:
            rev = self._sql_revision()
            rows = self._db.execute(
                "SELECT * FROM job_log ORDER BY id DESC LIMIT ?",
                (limit,)).fetchall() if limit else []
        return rev, [self._row_to_rec(r, False) for r in reversed(rows)]

    # ---- change stream (the store watch plane, result-plane edition) -----

    def subscribe(self, after_id: int = 0, cap: int = 4096
                  ) -> LogSubscription:
        """Open a live event stream of new-record summaries.

        ``after_id`` <= 0 (or >= revision) starts from NOW; a positive
        cursor replays the gap ``(after_id, revision]`` when the store
        can still prove completeness — from the contiguous hot deque or
        from SQL rows above the retention/cold floor — and otherwise
        sets ``sub.gap`` (the consumer re-lists once; the stream itself
        is live from ``sub.rev`` regardless).  ``cap`` bounds the
        per-subscriber buffer: overflow drops everything pending and
        latches ``lost`` (store watch semantics).

        Registration and the revision snapshot share one ``self._lock``
        hold with the write path's emission, so no record can land
        between the snapshot and the first event."""
        t0 = time.perf_counter_ns()
        after_id = int(after_id)
        with self._lock:
            if self._tier:
                with self._hot_mu:
                    rev = self._h_rev
            else:
                rev = self._sql_revision()
            sub = LogSubscription(self, cap)
            sub.rev = rev
            replay: list = []
            if 0 < after_id < rev:
                served = False
                if self._tier:
                    with self._hot_mu:
                        if self._h_recs and \
                                self._h_recs[0].id <= after_id + 1:
                            # contiguous-id invariant: the deque holds
                            # EVERY id in [head, rev], so covering
                            # after_id+1 proves the replay is complete
                            replay = [sub_event(r) for r in self._h_recs
                                      if r.id > after_id]
                            served = True
                if not served:
                    floor = max(self._retain_floor(rev),
                                self._cold_boundary)
                    if after_id < floor:
                        sub.gap = True
                    else:
                        rows = self._db.execute(
                            "SELECT * FROM job_log WHERE id > ? "
                            "ORDER BY id ASC", (after_id,)).fetchall()
                        replay = [sub_event(self._row_to_rec(r, False))
                                  for r in rows]
            self._subs[id(sub)] = sub
            if replay:
                sub._push(replay)
        self._op_record("subscribe", t0)
        return sub

    def unsubscribe(self, sub: LogSubscription) -> None:
        with self._lock:
            self._subs.pop(id(sub), None)

    def _sub_emit(self, recs) -> None:
        """Fan a committed batch to every live subscription — called
        under ``self._lock`` from both create paths, AFTER the commit
        (an event must never precede the row it announces)."""
        evs = [sub_event(r) for r in recs]
        self.op_count("sub_events", len(evs) * len(self._subs))
        dead = []
        for k, s in self._subs.items():
            s._push(evs)
            if s.lost or s.closed:
                dead.append(k)
        for k in dead:
            self._subs.pop(k, None)

    def logmap(self, n=None, hash=None):
        """The sharded-result-plane topology pin (the store's shardmap,
        result-plane edition): with arguments, publish {n, hash} if no
        pin exists yet and return whatever pin now holds; without
        arguments, a read-only peek (None when unpinned).  Lives on
        shard 0 by fiat so a client can check it knowing only the
        address list; a mismatched client refuses to start instead of
        scattering one job's history under two layouts."""
        with self._lock:
            if n is not None:
                self._db.execute(
                    "INSERT OR IGNORE INTO meta VALUES ('logmap', ?)",
                    (json.dumps({"n": int(n), "hash": hash},
                                sort_keys=True),))
                self._db.commit()
            r = self._db.execute(
                "SELECT v FROM meta WHERE k='logmap'").fetchone()
        return json.loads(r["v"]) if r else None

    # ---- cold aging (the retention sweeper's tier move) ------------------

    AGE_PASS_RECORDS = 50_000

    def age_out(self, now: Optional[float] = None) -> int:
        """Move every record whose UTC day fell out of the hot window
        (``hot_days`` whole days including today) into its day's
        immutable segment file, then trim it from SQL and the mirror.

        Crash-safe by ordering: segments are written + fsynced FIRST
        (union by id — a redo converges on the same bytes), then ONE
        SQL transaction deletes the rows and advances the durable
        ``cold_boundary`` watermark.  A kill -9 anywhere in between
        leaves the rows hot and the watermark behind — reads stay
        exact (cold is only consulted at or below the watermark) and
        the next pass redoes the move idempotently.

        Runs in bounded PASSES of ``AGE_PASS_RECORDS`` each: the first
        enablement on an unbounded store may face millions of rows,
        and one monolithic SELECT would hold the SQL lock (and that
        many LogRecords in memory) for the duration — each pass keeps
        the lock hold and peak memory bounded, and the loop (still one
        pass at a time under ``_age_mu``) continues until the cutoff
        is reached.  Returns the number of records aged."""
        from . import tiering as tg
        dirp = tg.seg_dir(self._path)
        if not self._tier or self._hot_days <= 0 or dirp is None:
            return 0
        t0 = time.perf_counter_ns()
        cutoff = tg.hot_cutoff_ts(now if now is not None else time.time(),
                                  self._hot_days)
        total = 0
        with self._age_mu:
            while True:
                aged = self._age_pass(tg, dirp, cutoff)
                total += aged
                if aged < self.AGE_PASS_RECORDS:
                    break
        self._op_record("age_out", t0)
        if total:
            self.op_count("aged_records", total)
        return total

    def _age_pass(self, tg, dirp: str, cutoff: float) -> int:
        """One bounded age pass — caller holds ``_age_mu``."""
        with self._lock:
            m = self._db.execute(
                "SELECT MIN(id) m FROM job_log WHERE begin_ts >= ?",
                (cutoff,)).fetchone()["m"]
            if m is not None:
                nb = m - 1
            else:
                mx = self._db.execute(
                    "SELECT MAX(id) m FROM job_log").fetchone()["m"]
                nb = mx or 0
            if nb <= self._cold_boundary:
                return 0
            rows = [self._row_to_rec(r, False) for r in
                    self._db.execute(
                        "SELECT * FROM job_log WHERE id <= ? "
                        "ORDER BY id LIMIT ?",
                        (nb, self.AGE_PASS_RECORDS))]
            if not rows:
                # rows below nb already gone (retention evicted them):
                # just advance the durable watermark past the gap
                self._advance_boundary_locked(nb, [])
                return 0
            nb = rows[-1].id      # the pass's own (still-prefix) bound
        # segment writes OUTSIDE the SQL lock: new writes only ever
        # get ids > nb, so the aged set is immutable while we write
        by_day: dict = {}
        for r in rows:
            by_day.setdefault(tg.day_of(r.begin_ts), []).append(r)
        entries = [tg.write_segment(dirp, day, recs)
                   for day, recs in sorted(by_day.items())]
        with self._lock:
            self._db.execute("DELETE FROM job_log WHERE id <= ?", (nb,))
            self._advance_boundary_locked(nb, entries)
        return len(rows)

    def _advance_boundary_locked(self, nb: int, entries: list):
        """Durably advance the cold watermark + apply it to the
        mirrors and segment index — caller holds ``self._lock``."""
        self._db.execute(
            "INSERT INTO meta VALUES ('cold_boundary', ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (str(nb),))
        self._db.commit()
        with self._hot_mu:
            self._cold_boundary = nb
            while self._h_recs and self._h_recs[0].id <= nb:
                self._h_recs.popleft()
            segs = {s["day"]: s for s in self._segments}
            for e in entries:
                segs[e["day"]] = e
            # drop segments wholly below the retention floor — their
            # records are invisible either way; this bounds disk like
            # the untiered delete bounds rows
            floor = self._retain_floor(self._h_rev)
            keep = []
            for s in sorted(segs.values(), key=lambda s: s["day"]):
                if self._retain and s["max"] <= floor:
                    try:
                        os.remove(s["path"])
                    except OSError:
                        pass
                    continue
                keep.append(s)
            self._segments = keep

    def tier_info(self) -> dict:
        """Observability snapshot: watermark, hot sizes, segment
        inventory — OPERATIONS.md's runbook reads this."""
        with self._hot_mu:
            return {
                "tiering": self._tier,
                "hot_days": self._hot_days,
                "cold_boundary": self._cold_boundary,
                "hot_records": len(self._h_recs),
                "revision": self._h_rev if self._tier
                else None,
                "segments": [{k: s[k] for k in
                              ("day", "min", "max", "count")}
                             for s in self._segments],
            }

    # ---- stats -----------------------------------------------------------

    def stat_overall(self) -> dict:
        return self._stat("")

    def stat_day(self, day: str) -> dict:
        return self._stat(day)

    def _stat(self, day: str) -> dict:
        if self._tier:
            t0 = time.perf_counter_ns()
            with self._hot_mu:
                ent = self._h_stats.get(day)
                out = ({"total": ent[0], "successed": ent[1],
                        "failed": ent[2]} if ent else
                       {"total": 0, "successed": 0, "failed": 0})
            self._op_record("q_stat_hot", t0)
            return out
        t0 = time.perf_counter_ns()
        with self._lock:
            r = self._db.execute("SELECT * FROM stat WHERE day = ?",
                                 (day,)).fetchone()
        self._op_record("query_sql", t0)
        if r is None:
            return {"total": 0, "successed": 0, "failed": 0}
        return {"total": r["total"], "successed": r["successed"],
                "failed": r["failed"]}

    def stat_days(self, n_days: int) -> List[dict]:
        n_days = max(0, n_days)
        if self._tier:
            t0 = time.perf_counter_ns()
            with self._hot_mu:
                days = sorted((d for d in self._h_stats if d != ""),
                              reverse=True)[:n_days]
                out = [{"day": d, "total": self._h_stats[d][0],
                        "successed": self._h_stats[d][1],
                        "failed": self._h_stats[d][2]} for d in days]
            self._op_record("q_stat_hot", t0)
            return out
        t0 = time.perf_counter_ns()
        with self._lock:
            rows = self._db.execute(
                "SELECT * FROM stat WHERE day != '' ORDER BY day DESC "
                "LIMIT ?", (n_days,)).fetchall()
        self._op_record("query_sql", t0)
        return [{"day": r["day"], "total": r["total"],
                 "successed": r["successed"], "failed": r["failed"]}
                for r in rows]

    # ---- node mirror -----------------------------------------------------

    def upsert_node(self, node_id: str, doc: str, alived: bool):
        with self._lock:
            self._db.execute(
                "INSERT INTO node VALUES (?,?,?) ON CONFLICT(id) DO UPDATE "
                "SET doc=excluded.doc, alived=excluded.alived",
                (node_id, doc, 1 if alived else 0))
            self._db.commit()

    def set_node_alived(self, node_id: str, alived: bool):
        with self._lock:
            self._db.execute("UPDATE node SET alived=? WHERE id=?",
                             (1 if alived else 0, node_id))
            self._db.commit()

    def get_nodes(self) -> List[dict]:
        with self._lock:
            rows = self._db.execute("SELECT * FROM node ORDER BY id").fetchall()
        out = []
        for r in rows:
            d = json.loads(r["doc"])
            d["alived"] = bool(r["alived"])
            out.append(d)
        return out

    def get_node(self, node_id: str) -> Optional[dict]:
        with self._lock:
            r = self._db.execute("SELECT * FROM node WHERE id=?",
                                 (node_id,)).fetchone()
        if r is None:
            return None
        d = json.loads(r["doc"])
        d["alived"] = bool(r["alived"])
        return d

    # ---- accounts --------------------------------------------------------

    def upsert_account(self, email: str, doc: str):
        with self._lock:
            self._db.execute(
                "INSERT INTO account VALUES (?,?) ON CONFLICT(email) DO "
                "UPDATE SET doc=excluded.doc", (email, doc))
            self._db.commit()

    def get_account(self, email: str) -> Optional[str]:
        with self._lock:
            r = self._db.execute("SELECT doc FROM account WHERE email=?",
                                 (email,)).fetchone()
        return r["doc"] if r else None

    def list_accounts(self) -> List[str]:
        with self._lock:
            rows = self._db.execute(
                "SELECT doc FROM account ORDER BY email").fetchall()
        return [r["doc"] for r in rows]

    def delete_account(self, email: str) -> bool:
        with self._lock:
            cur = self._db.execute("DELETE FROM account WHERE email=?",
                                   (email,))
            self._db.commit()
            return cur.rowcount > 0
