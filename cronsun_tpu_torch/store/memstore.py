"""In-memory coordination store with etcd v3 semantics.

Implements exactly the subset the framework (and the reference) relies on:

- revisioned KV: every key carries (create_rev, mod_rev); a global revision
  counter advances on every mutation (etcd's store revision).
- prefix gets and prefix watches; watch events carry the previous KV for
  delete/modify deltas (the reference watches groups WithPrevKV,
  group.go:64-66).
- leases: grant(ttl)/keepalive/revoke; keys attached to an expired lease are
  deleted *with events*, which is how node death detection works
  (noticer.go:172-200).
- txns: put-if-absent on create_rev==0 (the distributed lock,
  client.go:95-109) and put-if-mod-rev CAS (pause toggle / group scrub,
  client.go:44-65).

Thread-safe, and STRIPED: the keyspace is hash-sharded across N lock
domains (default 16) so concurrent writers on disjoint keys — several
agents' claim batches, a publisher's put_many, lease keepalives — no
longer serialize behind one global lock.  Three small shared domains
remain, each held only for bookkeeping (never for per-key map work or
serialization):

- the EVENT PLANE (``_ev_lock``): revision counter + bounded history
  ring + watcher registry/fan-out.  Holding it per mutation keeps watch
  streams revision-ordered (etcd's contract) and history replayable.
- the LEASE TABLE (``_lease_lock``, reentrant): grants/keepalives and
  key<->lease attachment.  Claim ops hold it across their item loop so
  a validated lease cannot expire mid-batch (no half-applied claims).
- op stats (``_op_lock``).

Lock order (never acquired in reverse): stripe locks in ascending index
order -> lease lock -> event lock.  Multi-key ops (txn/claim_bundle/
put_many/delete_many/prefix scans) acquire every stripe they touch in
ascending order; lease expiry collects doomed keys under the lease lock
alone and deletes them through the normal striped path afterwards.

Watchers receive events through BOUNDED queues on the mutating thread —
a consumer that falls max_backlog behind loses the stream (WatchLost on
the next drain/get) and must re-list + re-watch, etcd's slow-watcher
cancellation.  Lease expiry is checked lazily on every operation while
no sweeper runs; once a sweeper owns expiry, the hot ops skip the
per-op whole-table scan (it was a measured per-put cost at dispatch
rates, and under the shared lease lock it re-serialized the striped
ops).  Writes still reject expired-but-unswept leases via an O(1)
deadline check at validation.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PUT = "PUT"
DELETE = "DELETE"


class CompactedError(RuntimeError):
    """watch(start_rev) asked for revisions older than the bounded event
    history retains (etcd's ErrCompacted): the caller must re-list the
    prefix and watch from the current revision instead."""


class WatchLost(RuntimeError):
    """The watch stream was cancelled because the consumer fell too far
    behind (etcd's slow-watcher cancellation).  Raised by get()/drain()
    once the buffered events are exhausted: the consumer must re-watch
    and re-list the prefix to resynchronize."""


@dataclasses.dataclass(frozen=True)
class KV:
    key: str
    value: str
    create_rev: int
    mod_rev: int
    lease: int = 0


@dataclasses.dataclass(frozen=True)
class Event:
    type: str                 # PUT | DELETE
    kv: KV
    prev_kv: Optional[KV]

    @property
    def is_create(self) -> bool:
        return self.type == PUT and self.prev_kv is None

    @property
    def is_modify(self) -> bool:
        return self.type == PUT and self.prev_kv is not None


@dataclasses.dataclass
class Lease:
    id: int
    ttl: float
    deadline: float
    keys: set = dataclasses.field(default_factory=set)


class LossyEventStream:
    """Event-queue base with the WatchLost contract, shared by the
    in-process :class:`Watcher` and the remote client's watcher: a lost
    stream first yields its buffered tail, then raises
    :class:`WatchLost` — never a silent starve."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.lost = False
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._closed = False

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event, or None on timeout/close.  Raises WatchLost once a
        cancelled stream has drained its buffered events."""
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            if self.lost:
                raise WatchLost(f"watch {self.prefix!r} overflowed")
            return None
        if ev is None and self.lost:
            raise WatchLost(f"watch {self.prefix!r} overflowed")
        return ev

    def drain(self) -> List[Event]:
        """Buffered events.  A cancelled stream first yields its
        remaining buffer, then raises WatchLost on the next call."""
        out = []
        while True:
            try:
                ev = self._q.get_nowait()
            except queue.Empty:
                if self.lost and not out:
                    raise WatchLost(f"watch {self.prefix!r} overflowed")
                return out
            if ev is None:
                if self.lost and not out:
                    raise WatchLost(f"watch {self.prefix!r} overflowed")
                return out
            out.append(ev)

    def __iter__(self):
        while not self._closed:
            ev = self.get()
            if ev is None:
                return
            yield ev


class Watcher(LossyEventStream):
    """A watch stream over a key prefix.

    The queue is bounded: a consumer that falls ``max_backlog`` events
    behind has lost the stream anyway, so the watcher cancels itself
    (etcd cancels slow watchers the same way; the native server bounds
    its per-connection outbox identically)."""

    MAX_BACKLOG = 1 << 17

    def __init__(self, store: "MemStore", prefix: str, start_rev: int,
                 max_backlog: int = MAX_BACKLOG, events: str = ""):
        super().__init__(prefix)
        self._store = store
        self.start_rev = start_rev
        self._max_backlog = max_backlog
        # "" = all event types; "delete" = DELETE only.  A writer
        # watching its own output prefix (the scheduler mirrors
        # outstanding orders it publishes by the tens of thousands per
        # window) would otherwise get every one of its own puts pushed
        # back, serialized and re-parsed, for nothing.
        self.events = events
        # optional readiness hook: called (with this watcher) after an
        # event or the close sentinel lands in the queue.  The remote
        # server's per-connection pump uses it to wake ONE batching
        # writer instead of parking a thread per watcher.
        self.on_ready: Optional[Callable[["Watcher"], None]] = None

    def _emit(self, ev: Event):
        if self._closed:
            return
        if self.events == "delete" and ev.type != DELETE:
            return
        if self._q.qsize() >= self._max_backlog:
            self.lost = True
            self.close()
            return
        self._q.put(ev)
        if self.on_ready is not None:
            self.on_ready(self)

    def close(self):
        self._closed = True
        self._store._remove_watcher(self)
        self._q.put(None)
        if self.on_ready is not None:
            self.on_ready(self)


class _Stripe:
    __slots__ = ("lock", "kv", "imaged", "cow")

    def __init__(self):
        self.lock = threading.Lock()
        self.kv: Dict[str, KV] = {}
        # staggered-snapshot state, guarded by this stripe's lock:
        # imaged=False while a snapshot is active and this stripe's
        # image hasn't been taken yet; cow holds the PRE-image (KV, or
        # None for not-present) of every key mutated in that window
        self.imaged = True
        self.cow: Dict[str, Optional[KV]] = {}


class MemStore:
    STRIPES = 16

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 history: int = 65536, stripes: int = STRIPES,
                 snapshot_staggered: Optional[bool] = None):
        self._nstripes = max(1, int(stripes))
        self._stripes = [_Stripe() for _ in range(self._nstripes)]
        # event plane: revision counter, history ring, watcher registry +
        # fan-out.  Reentrant because an overflowing watcher cancels
        # itself (-> _remove_watcher) from inside the fan-out.
        self._ev_lock = threading.RLock()
        # lease table.  Reentrant because claim ops hold it across their
        # whole item loop (a validated lease must not expire mid-batch)
        # while each inner put/delete re-takes it for attachment.
        self._lease_lock = threading.RLock()
        self._clock = clock
        self._rev = 0
        self._leases: Dict[int, Lease] = {}
        self._next_lease = 1
        self._watchers: List[Watcher] = []
        self._history: "collections.deque[Event]" = \
            collections.deque(maxlen=history)
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # per-op server-side timing for the dispatch plane's hot ops
        # (claim paths, bulk writes, watch fan-out).  Lets a bench
        # attribute the plane's ceiling to a NAMED component instead of
        # "the store" (VERDICT #2); shared shape with the result
        # store's op_stats (metrics.OpStats).
        from ..metrics import OpStats
        self._ops = OpStats()
        # optional persistence (checkpoint plane): WAL + snapshot
        # sidecar, same record format as the native stored.cc — see
        # open_wal / snapshot
        self._wal = None
        self._replaying = False
        self._wal_compact_bytes = 0
        # replication plane (repl/): when a ReplLog is attached, every
        # WAL-worthy record is mirrored into it for follower shipping
        # (same record format — walsnap.py's table).  ``_epoch`` is the
        # fencing epoch ("E" records / snapshot "v" 4th field): bumped
        # on promotion so a deposed leader's late appends are
        # refusable.  ``_repl_follower`` disables LOCAL lease expiry —
        # the leader is the sole expiry authority, a follower expiring
        # locally would emit "d"s the leader never shipped.
        self._repl_log = None
        self._epoch = 0
        self._repl_follower = False
        # staggered snapshots (default): image stripes one at a time
        # under their OWN locks against a pinned revision boundary with
        # per-stripe copy-on-write pre-images, so a multi-GB image never
        # stalls writers longer than one stripe's copy.  Off = the PR 5
        # full-lock hold (the rollback switch).
        if snapshot_staggered is None:
            import os as _os
            snapshot_staggered = _os.environ.get(
                "CRONSUN_SNAPSHOT_STAGGERED", "on").lower() \
                not in ("off", "0")
        self._snap_staggered = bool(snapshot_staggered)
        self._snap_active = False
        self._snap_mu = threading.Lock()   # one snapshot at a time

    # ---- striped locking -------------------------------------------------

    def _sidx(self, key: str) -> int:
        return hash(key) % self._nstripes

    def _acquire_stripe(self, idx: int):
        lk = self._stripes[idx].lock
        if not lk.acquire(False):
            # blocked acquisition = real cross-writer contention; counted
            # so the bench (and /v1/metrics via op_stats) can see whether
            # the stripe count is the ceiling
            self.op_count("stripe_contention")
            lk.acquire()

    @contextlib.contextmanager
    def _locked(self, keys: Optional[Sequence[str]] = None,
                all_stripes: bool = False):
        """Hold the stripe locks covering ``keys`` (or every stripe),
        acquired in ascending index order — the deadlock-free order every
        multi-stripe op (txn, claim_bundle, put_many, prefix scan) uses."""
        if all_stripes:
            idxs: Sequence[int] = range(self._nstripes)
        else:
            idxs = sorted({self._sidx(k) for k in keys})
        for i in idxs:
            self._acquire_stripe(i)
        try:
            yield
        finally:
            for i in reversed(list(idxs)):
                self._stripes[i].lock.release()

    def _op_record(self, op: str, t0_ns: int):
        self._ops.record(op, t0_ns)

    def op_count(self, op: str, n: int = 1):
        """Count-only stat (no timing): contention ticks, watch-batch
        frame/event tallies.  Rendered through the same op_stats surface."""
        self._ops.count(op, n)

    def op_stats(self) -> dict:
        """Per-op timing snapshot: {op: {count, total_ms, max_ms}}."""
        return self._ops.snapshot()

    # ---- lifecycle -------------------------------------------------------

    def start_sweeper(self, interval: float = 0.2):
        if self._sweeper:
            return
        def run():
            while not self._stop.wait(interval):
                self._expire_leases()
                wal = self._wal
                if wal is not None:
                    # fdatasync rides the sweep cadence (the native
                    # server's contract); size-triggered compaction
                    # keeps the WAL — and therefore the next boot's
                    # replay — bounded by snapshot cadence, not history
                    wal.sync()
                    if self._wal_compact_bytes and \
                            wal.size() > self._wal_compact_bytes:
                        try:
                            self.snapshot()
                        except Exception as e:  # noqa: BLE001 — retry
                            import sys      # at the next sweep; a full
                            print(f"wal compaction failed: {e}",  # disk
                                  file=sys.stderr)  # must not kill the
                                                    # sweeper
        self._sweeper = threading.Thread(target=run, daemon=True,
                                         name="memstore-sweeper")
        self._sweeper.start()

    def close(self):
        self._stop.set()
        with self._ev_lock:
            for w in list(self._watchers):
                w.close()
        if self._wal is not None:
            self._wal.sync()
            self._wal.close()

    # ---- persistence (checkpoint plane) ----------------------------------

    def open_wal(self, path: str, sync_per_commit: bool = False,
                 compact_bytes: int = 256 << 20) -> "MemStore":
        """Attach a WAL + snapshot pair at ``path`` / ``path + ".snap"``
        (native stored.cc record format): replay the snapshot, replay
        the WAL tail through the normal mutation paths, then write a
        fresh snapshot and truncate the WAL — boot cost is bounded by
        snapshot cadence, not total history.  Must run before the store
        serves clients (no concurrent mutations during replay)."""
        from ..checkpoint.walsnap import (WalFile, read_records,
                                          rotated_path, snap_path)
        if self._wal is not None:
            raise RuntimeError("wal already open")
        self._replaying = True
        try:
            t0 = time.perf_counter_ns()
            for rec in read_records(snap_path(path)):
                self._replay_record(rec)
            self._op_record("snapshot_load", t0)
            t0 = time.perf_counter_ns()
            # FILE.1 = pre-pin records parked by a staggered snapshot
            # that died mid-image: strictly older than the live WAL,
            # replayed between snapshot and tail so last-write-wins
            # convergence holds
            for rec in read_records(rotated_path(path)):
                self._replay_record(rec)
            for rec in read_records(path):
                self._replay_record(rec)
            self._op_record("wal_replay", t0)
        finally:
            self._replaying = False
        self._wal = WalFile(path, sync_per_commit)
        self._wal_compact_bytes = compact_bytes
        self.snapshot()
        return self

    def snapshot(self) -> int:
        """Write a point-in-time image of the striped keyspace + lease
        table (tagged with its revision) to the snapshot sidecar — temp
        file + atomic rename.  Two paths:

        - STAGGERED (default): a brief all-locks PIN (revision + lease
          copy + WAL rotation to ``FILE.1`` — O(1), no state copied but
          the lease table), then stripes image ONE AT A TIME under
          their own locks with copy-on-write pre-images for writes
          racing the image — writers never wait longer than one
          stripe's copy, and the ``.snap`` is consistent at the pinned
          revision (every post-pin mutation is in the fresh WAL, so
          boot replay converges regardless).  On success ``FILE.1`` is
          deleted (its records are covered).
        - FULL-LOCK (``snapshot_staggered=False`` /
          CRONSUN_SNAPSHOT_STAGGERED=off): the PR 5 behavior — every
          lock held for the whole serialization; kept as the rollback
          and the bench's stall baseline.

        Returns the snapshot's revision.  The per-path cost shows as
        the ``snapshot`` (and staggered ``snapshot_pin``) op in
        op_stats."""
        if self._wal is None:
            raise RuntimeError("snapshot: no WAL configured "
                               "(open_wal first)")
        from ..checkpoint.walsnap import rotated_path, write_snapshot
        if not self._snap_staggered:
            with self._locked(all_stripes=True), self._lease_lock, \
                    self._ev_lock:
                t0 = time.perf_counter_ns()
                write_snapshot(self._wal.path, self._snapshot_lines())
                # any parked FILE.1 goes BEFORE the truncation: a crash
                # between the two with the order reversed leaves
                # snapshot + stale FILE.1 + empty WAL, and the next
                # boot replays the stale records over the snapshot with
                # no newer tail to converge them
                self._remove_rotated(rotated_path(self._wal.path))
                self._wal.truncate()
                rev = self._rev
                self._op_record("snapshot", t0)
            return rev
        with self._snap_mu:
            t0 = time.perf_counter_ns()
            rotated = rotated_path(self._wal.path)
            # PIN — the brief exclusive window: all locks held only
            # long enough to fix the revision boundary, copy the (small)
            # lease table, rotate the WAL, and arm the per-stripe COW
            with self._locked(all_stripes=True), self._lease_lock, \
                    self._ev_lock:
                tp = time.perf_counter_ns()
                rev = self._rev
                next_lease = self._next_lease
                epoch = self._epoch
                now_c, now_w = self._clock(), time.time()
                leases = [(l.id, l.ttl, now_w + (l.deadline - now_c))
                          for l in self._leases.values()]
                self._wal.rotate(rotated)
                for s in self._stripes:
                    s.imaged = False
                    s.cow = {}
                self._snap_active = True
                self._op_record("snapshot_pin", tp)
            try:
                def lines():
                    yield ["v", rev, next_lease, epoch]
                    for lid, ttl, wall in leases:
                        yield ["g", lid, ttl, wall]
                    for s in self._stripes:
                        with s.lock:
                            img = dict(s.kv)
                            cow, s.cow = s.cow, {}
                            s.imaged = True
                        # pre-images overlay OUTSIDE the lock: a key
                        # mutated post-pin reverts to its pinned value
                        # (None = did not exist at the pin)
                        for k, pre in cow.items():
                            if pre is None:
                                img.pop(k, None)
                            else:
                                img[k] = pre
                        for k, kv in img.items():
                            yield ["s", k, kv.value, kv.create_rev,
                                   kv.mod_rev, kv.lease]
                write_snapshot(self._wal.path, lines())
            finally:
                self._snap_active = False
                for s in self._stripes:
                    with s.lock:
                        s.imaged = True
                        s.cow = {}
            # the rename published an image covering everything in the
            # rotated pre-pin records — they are dead weight now (left
            # in place on failure: boot and the next pin both handle a
            # lingering FILE.1)
            self._remove_rotated(rotated)
            self._op_record("snapshot", t0)
            return rev

    @staticmethod
    def _remove_rotated(rotated: str):
        import os as _os
        try:
            _os.remove(rotated)
        except OSError:
            pass

    def rev(self) -> int:
        """Current store revision — the checkpoint plane tags scheduler
        checkpoints with it so a restore can replay exactly the watch
        delta since the checkpointed state."""
        with self._ev_lock:
            return self._rev

    def _snapshot_lines(self):
        """Caller holds every stripe lock + lease + event locks."""
        yield ["v", self._rev, self._next_lease, self._epoch]
        now_c, now_w = self._clock(), time.time()
        for lid, l in self._leases.items():
            # deadlines persist as WALL-clock instants (the store clock
            # is monotonic and does not survive the process)
            yield ["g", lid, l.ttl, now_w + (l.deadline - now_c)]
        for s in self._stripes:
            for k, kv in s.kv.items():
                yield ["s", k, kv.value, kv.create_rev, kv.mod_rev,
                       kv.lease]

    def _replay_record(self, rec: list):
        """Apply one snapshot/WAL record (boot only: no clients yet)."""
        op = rec[0]
        if op == "p" and len(rec) >= 4:
            key, value, lease = rec[1], rec[2], int(rec[3] or 0)
            with self._lease_lock:
                if lease and lease not in self._leases:
                    # the lease expired+vanished during downtime; a
                    # recreate-then-expire is indistinguishable — drop
                    return
            with self._locked([key]):
                self._put_locked(key, value, lease)
        elif op == "d" and len(rec) >= 2:
            with self._locked([rec[1]]):
                self._delete_locked(rec[1])
        elif op == "g" and len(rec) >= 4:
            lid, ttl, wall_deadline = int(rec[1]), float(rec[2]), \
                float(rec[3])
            with self._lease_lock:
                self._leases[lid] = Lease(
                    lid, ttl, self._clock() + (wall_deadline - time.time()))
                if lid >= self._next_lease:
                    self._next_lease = lid + 1
        elif op == "k" and len(rec) >= 3:
            with self._lease_lock:
                l = self._leases.get(int(rec[1]))
                if l is not None:
                    l.deadline = self._clock() + (float(rec[2])
                                                  - time.time())
        elif op == "x" and len(rec) >= 2:
            # full revoke semantics: delete attached keys too — closes
            # the crash window between a flushed "x" and its "d"s
            lid = int(rec[1])
            with self._lease_lock:
                l = self._leases.pop(lid, None)
            if l is not None:
                self._delete_keys(sorted(l.keys), only_lease=lid)
        elif op == "v" and len(rec) >= 3:
            self._rev = int(rec[1])
            self._next_lease = int(rec[2])
            if len(rec) >= 4:       # pre-replication snapshots: epoch 0
                self._epoch = int(rec[3])
        elif op == "E" and len(rec) >= 2:
            # promotion fencing epoch (replication plane): adopt it so
            # a restarted replica rejoins at the epoch it last saw
            self._epoch = int(rec[1])
        elif op == "s" and len(rec) >= 6:
            key, value = rec[1], rec[2]
            kv = KV(key, value, int(rec[3]), int(rec[4]), int(rec[5]))
            if kv.lease:
                with self._lease_lock:
                    l = self._leases.get(kv.lease)
                    if l is None:
                        # the key's lease is gone (snapshot raced a
                        # revoke/expiry between the lease pop and the
                        # key deletes): the key was doomed — keeping it
                        # would resurrect it PERMANENTLY, attached to a
                        # lease that can never expire it
                        return
                    l.keys.add(key)
            self._stripes[self._sidx(key)].kv[key] = kv

    def _log(self, rec: list):
        """Record one mutation in every attached durability/shipping
        sink: the WAL (if open) and the replication log (if the repl
        plane is attached).  Replay never re-logs.  The caller holds
        the lock that ordered the mutation (``_ev_lock`` for KV
        records, ``_lease_lock`` for lease records), so both sinks see
        records in the order the store applied them."""
        if self._replaying:
            return
        if self._wal is not None:
            self._wal.append(rec)
        if self._repl_log is not None:
            self._repl_log.append(rec)

    # ---- replication (repl/ plane) ---------------------------------------

    def repl_attach(self, repl_log, follower: bool = False):
        """Attach the replication plane: every WAL-worthy record is
        mirrored into ``repl_log`` (repl.log.ReplLog) for follower
        shipping.  ``follower=True`` puts the store in follower mode:
        local lease expiry is disabled (the LEADER is the sole expiry
        authority — a follower expiring locally would generate "d"
        records the leader never shipped, diverging the replicas), and
        mutations are expected only via :meth:`repl_apply`."""
        self._repl_log = repl_log
        self._repl_follower = bool(follower)

    def repl_epoch(self) -> int:
        with self._ev_lock:
            return self._epoch

    def repl_is_follower(self) -> bool:
        return self._repl_follower

    def repl_apply(self, rec: list):
        """Apply one shipped WAL record on a FOLLOWER, through the
        normal mutation paths — watch events fire, the follower's own
        WAL and repl log record it (chained replication composes), and
        the revision counter advances exactly as the leader's did.

        Differences from boot replay (:meth:`_replay_record`):

        - a "p" whose lease is missing applies with lease=0 instead of
          dropping: the leader logs a revoke's "x" under the lease
          lock while a racing put logs its "p" later under the event
          lock, so the shipped order can be x-then-p even though the
          leader's state briefly held the key — the revoke's key-sweep
          "d" ships next, finds the key, and bumps the revision on
          both sides, so state AND revision converge.  Boot replay's
          drop would leave the follower's revision permanently behind.
        - "x" pops the lease-table entry ONLY: the leader ships one
          "d" per swept key itself; sweeping here too would
          double-delete (and double-bump the revision).
        - "E" adopts the fencing epoch a promotion stamped.
        """
        op = rec[0]
        if op == "p" and len(rec) >= 4:
            key, value, lease = rec[1], rec[2], int(rec[3] or 0)
            with self._locked([key]), self._lease_lock:
                if lease and lease not in self._leases:
                    lease = 0
                self._put_locked(key, value, lease)
        elif op == "d" and len(rec) >= 2:
            with self._locked([rec[1]]):
                self._delete_locked(rec[1])
        elif op == "g" and len(rec) >= 4:
            lid, ttl, wall = int(rec[1]), float(rec[2]), float(rec[3])
            with self._lease_lock:
                self._leases[lid] = Lease(
                    lid, ttl, self._clock() + (wall - time.time()))
                if lid >= self._next_lease:
                    self._next_lease = lid + 1
                self._log(["g", lid, ttl, wall])
        elif op == "k" and len(rec) >= 3:
            with self._lease_lock:
                l = self._leases.get(int(rec[1]))
                if l is not None:
                    l.deadline = self._clock() + (float(rec[2])
                                                  - time.time())
                    self._log(["k", l.id, float(rec[2])])
        elif op == "x" and len(rec) >= 2:
            lid = int(rec[1])
            with self._lease_lock:
                if self._leases.pop(lid, None) is not None:
                    self._log(["x", lid])
        elif op == "E" and len(rec) >= 2:
            with self._ev_lock:
                self._epoch = int(rec[1])
                self._log(["E", self._epoch])

    def repl_dump(self) -> Tuple[list, int, int]:
        """Consistent bootstrap image for a joining follower: the full
        snapshot line stream plus the repl-log sequence and fencing
        epoch it corresponds to.

        Staggered by default, reusing the snapshot plane's machinery
        (same ``_snap_mu`` / per-stripe COW state, so it serializes
        with :meth:`snapshot`): a brief all-locks PIN fixes the cursor,
        revision and lease copy and arms the copy-on-write pre-images,
        then stripes image ONE AT A TIME under their own locks — a
        follower bootstrap never stalls the leader's write plane longer
        than one stripe's copy.  Post-pin mutations revert to their
        pinned pre-image in the lines, so the image is exactly the
        state at the captured cursor (their records ship via the tail
        stream).  ``snapshot_staggered=False`` keeps the full-lock hold
        (the same rollback switch as :meth:`snapshot`)."""
        if not self._snap_staggered:
            with self._locked(all_stripes=True), self._lease_lock, \
                    self._ev_lock:
                lines = [list(r) for r in self._snapshot_lines()]
                seq = self._repl_log.seq \
                    if self._repl_log is not None else 0
                return lines, seq, self._epoch
        with self._snap_mu:
            t0 = time.perf_counter_ns()
            # PIN: all locks held only long enough to fix the cursor /
            # revision boundary, copy the (small) lease table and arm
            # the per-stripe COW — _log appends happen under _ev_lock
            # (KV) or _lease_lock (lease records), both held here, so
            # no record can land between the state capture and the seq
            with self._locked(all_stripes=True), self._lease_lock, \
                    self._ev_lock:
                rev = self._rev
                next_lease = self._next_lease
                epoch = self._epoch
                seq = self._repl_log.seq \
                    if self._repl_log is not None else 0
                now_c, now_w = self._clock(), time.time()
                leases = [(l.id, l.ttl, now_w + (l.deadline - now_c))
                          for l in self._leases.values()]
                for s in self._stripes:
                    s.imaged = False
                    s.cow = {}
                self._snap_active = True
            lines: list = [["v", rev, next_lease, epoch]]
            try:
                for lid, ttl, wall in leases:
                    lines.append(["g", lid, ttl, wall])
                for s in self._stripes:
                    with s.lock:
                        img = dict(s.kv)
                        cow, s.cow = s.cow, {}
                        s.imaged = True
                    # pre-images overlay OUTSIDE the lock: a key
                    # mutated post-pin reverts to its pinned value
                    # (None = did not exist at the pin)
                    for k, pre in cow.items():
                        if pre is None:
                            img.pop(k, None)
                        else:
                            img[k] = pre
                    for k, kv in img.items():
                        lines.append(["s", k, kv.value, kv.create_rev,
                                      kv.mod_rev, kv.lease])
            finally:
                self._snap_active = False
                for s in self._stripes:
                    with s.lock:
                        s.imaged = True
                        s.cow = {}
            self._op_record("repl_dump", t0)
            return lines, seq, epoch

    def repl_load(self, lines: Sequence[list], seq: int, epoch: int):
        """Follower bootstrap: replace local state with a leader's
        :meth:`repl_dump` image, then (if a WAL is attached) write one
        fresh local snapshot so the on-disk state is exactly a
        replica's snap+WAL; the attached repl log resets its cursor to
        the leader's ``seq`` so the tail stream continues the same
        numbering.  Only the repl apply thread may mutate during the
        load (concurrent READS can observe the partial image — the
        manager reports the follower unready until the load returns)."""
        with self._locked(all_stripes=True), self._lease_lock, \
                self._ev_lock:
            for s in self._stripes:
                s.kv.clear()
                s.cow = {}
            self._leases.clear()
            self._rev = 0
            self._next_lease = 1
        self._replaying = True
        try:
            for rec in lines:
                self._replay_record(rec)
        finally:
            self._replaying = False
        with self._ev_lock:
            self._epoch = int(epoch)
        if self._repl_log is not None:
            self._repl_log.reset(int(seq), int(epoch))
        if self._wal is not None:
            self.snapshot()

    def repl_promote(self) -> int:
        """Follower -> leader takeover: bump the fencing epoch and
        stamp it into the WAL/repl stream ("E" record), re-arm local
        lease expiry, give every replicated lease one fresh ttl (its
        deadline was converted from the OLD leader's wall clock; a
        takeover must not insta-expire the fleet's live leases — the
        owners re-keepalive within one ttl), and sweep orphan keys
        whose lease died in the old leader's crash window between a
        flushed "x" and its "d"s.  Returns the new epoch."""
        with self._locked(all_stripes=True), self._lease_lock, \
                self._ev_lock:
            self._repl_follower = False
            self._epoch += 1
            self._log(["E", self._epoch])
            now = self._clock()
            for l in self._leases.values():
                l.deadline = now + l.ttl
            for s in self._stripes:
                doomed = [k for k, kv in s.kv.items()
                          if kv.lease and kv.lease not in self._leases]
                for k in doomed:
                    self._delete_locked(k)
            return self._epoch

    # ---- KV --------------------------------------------------------------

    def _lazy_expire(self):
        """Per-op lease expiry: skip the scan entirely when the lease
        table is empty, and leave expiry to the sweeper when one is
        running — an unconditional whole-table scan per op (under the
        shared lease lock) was a measured hot-path cost at
        dispatch-plane rates, and with a sweeper it re-serialized the
        freshly striped ops.  Correctness holds either way: writes
        validate their own leases' deadlines (_check_lease), and an
        expired-but-unswept key lingering for one sweep interval is the
        same staleness any etcd client tolerates."""
        if self._leases and self._sweeper is None \
                and not self._repl_follower:
            self._expire_leases()

    def put(self, key: str, value: str, lease: int = 0) -> int:
        self._lazy_expire()
        self._validate_lease_arg(lease)
        with self._locked([key]):
            return self._put_locked(key, value, lease)

    def put_many(self, items: Sequence[Sequence[str]], lease: int = 0) -> int:
        """Bulk put under one striped acquisition — the dispatch plane
        writes whole planned windows at once.  ``items`` is
        [(key, value), ...]; the lease (if any) applies to every key."""
        self._lazy_expire()
        self._validate_lease_arg(lease)
        with self._locked([key for key, _v in items]):
            t0 = time.perf_counter_ns()
            rev = self._rev
            for key, value in items:
                rev = self._put_locked(key, value, lease)
            self._op_record("put_many", t0)
            return rev

    def _check_lease(self, lz: int) -> Lease:
        """Caller holds the lease lock.  An expired-but-unswept lease is
        as dead as a revoked one: the write paths no longer scan the
        whole table per op, so this O(1) deadline check at each op's
        validation point is what keeps a write from silently attaching
        to a lease the next sweep will kill (the old per-op scan raised
        KeyError in that window too)."""
        l = self._leases.get(lz)
        if l is None or l.deadline <= self._clock():
            raise KeyError(f"lease {lz} not found")
        return l

    def _validate_lease_arg(self, lease: int):
        if lease:
            with self._lease_lock:
                self._check_lease(lease)

    def _cow_save(self, key: str):
        """Staggered-snapshot copy-on-write: a mutation landing in a
        stripe the active snapshot has NOT yet imaged first saves the
        key's PRE-image (first touch only), so the image taken later
        reads as of the pinned revision.  Caller holds the key's stripe
        lock — the pin (which arms this under ALL stripe locks) and the
        imager (which flips ``imaged`` under this stripe's lock) both
        serialize against it, so the flag reads are race-free."""
        if not self._snap_active:
            return
        s = self._stripes[self._sidx(key)]
        if not s.imaged and key not in s.cow:
            s.cow[key] = s.kv.get(key)

    def _put_locked(self, key: str, value: str, lease: int) -> int:
        """Caller holds the key's stripe lock and has VALIDATED the
        lease (existence + deadline) at the op's entry; the existence
        re-check here only guards the mid-batch pop race, where failing
        is correct (the applied prefix dies with the lease anyway)."""
        self._cow_save(key)
        kvmap = self._stripes[self._sidx(key)].kv
        prev = kvmap.get(key)
        if lease or (prev and prev.lease):
            # only lease-touching puts pay the shared lease lock — an
            # unleased put over an unleased key (most mirror/state
            # writes) must not serialize behind a claim batch holding it
            with self._lease_lock:
                if lease:
                    new_lease = self._leases.get(lease)
                    if new_lease is None:
                        raise KeyError(f"lease {lease} not found")
                if prev and prev.lease and prev.lease != lease:
                    # etcd semantics: a put re-binds the key's lease
                    # attachment — the old lease must no longer own (and
                    # delete) this key.
                    old = self._leases.get(prev.lease)
                    if old is not None:
                        old.keys.discard(key)
                if lease:
                    new_lease.keys.add(key)
        with self._ev_lock:
            self._rev += 1
            kv = KV(key, value, prev.create_rev if prev else self._rev,
                    self._rev, lease)
            kvmap[key] = kv
            self._log(["p", key, value, lease])
            self._notify(Event(PUT, kv, prev))
            return self._rev

    def get(self, key: str) -> Optional[KV]:
        self._lazy_expire()
        with self._locked([key]):
            return self._stripes[self._sidx(key)].kv.get(key)

    def get_many(self, keys: Sequence[str]) -> List[Optional[KV]]:
        """Bulk point-get under one striped acquisition (one round trip
        over the wire) — agents batch their job-cache fills with this."""
        self._lazy_expire()
        keys = list(keys)
        with self._locked(keys):
            return [self._stripes[self._sidx(k)].kv.get(k) for k in keys]

    def get_prefix(self, prefix: str) -> List[KV]:
        self._lazy_expire()
        with self._locked(all_stripes=True):
            hits = [kv for s in self._stripes for k, kv in s.kv.items()
                    if k.startswith(prefix)]
            hits.sort(key=lambda kv: kv.key)
            return hits

    def get_prefix_page(self, prefix: str, start_after: str = "",
                        limit: int = 50_000) -> List[KV]:
        """One PAGE of a prefix listing: up to ``limit`` keys strictly
        after ``start_after``, in key order.  A million-key prefix as
        one reply is hundreds of MB serialized and a seconds-long GIL
        hold to parse client-side; pagination turns both into bounded
        slices (etcd's WithRange+WithLimit).  The page is a consistent
        snapshot; the WHOLE iteration is not — callers that page
        through a live keyspace get the same read-skew any etcd range
        pagination has, which every consumer here already tolerates
        (anti-entropy re-lists, leases expire)."""
        import heapq
        self._lazy_expire()
        with self._locked(all_stripes=True):
            # nsmallest keeps each page O(n log limit), not a full sort
            # of every matching key per page (O(pages x n log n) across
            # an iteration)
            hits = heapq.nsmallest(
                max(1, limit),
                (k for s in self._stripes for k in s.kv
                 if k.startswith(prefix) and k > start_after))
            return [self._stripes[self._sidx(k)].kv[k] for k in hits]

    def count_prefix(self, prefix: str) -> int:
        self._lazy_expire()
        with self._locked(all_stripes=True):
            return sum(1 for s in self._stripes for k in s.kv
                       if k.startswith(prefix))

    def delete(self, key: str) -> bool:
        self._lazy_expire()
        with self._locked([key]):
            return self._delete_locked(key)

    def _delete_locked(self, key: str) -> bool:
        """Caller holds the key's stripe lock."""
        self._cow_save(key)
        kvmap = self._stripes[self._sidx(key)].kv
        prev = kvmap.pop(key, None)
        if prev is None:
            return False
        if prev.lease:
            with self._lease_lock:
                l = self._leases.get(prev.lease)
                if l is not None:
                    l.keys.discard(key)
        with self._ev_lock:
            self._rev += 1
            tomb = KV(key, "", prev.create_rev, self._rev, 0)
            self._log(["d", key])
            self._notify(Event(DELETE, tomb, prev))
        return True

    def delete_prefix(self, prefix: str) -> int:
        self._lazy_expire()
        with self._locked(all_stripes=True):
            keys = [k for s in self._stripes for k in s.kv
                    if k.startswith(prefix)]
            for k in keys:
                self._delete_locked(k)
            return len(keys)

    def delete_many(self, keys: Sequence[str]) -> int:
        """Bulk delete under one striped acquisition — completion
        flushers (and the agents' buffered order-ack flush) retire whole
        batches of keys in one round trip."""
        self._lazy_expire()
        keys = list(keys)
        with self._locked(keys):
            t0 = time.perf_counter_ns()
            n = sum(1 for k in keys if self._delete_locked(k))
            self._op_record("delete_many", t0)
            return n

    # ---- txns ------------------------------------------------------------

    def put_if_absent(self, key: str, value: str, lease: int = 0) -> bool:
        """Txn If(create_rev(key)==0) Then(put) — the distributed lock
        acquire (reference client.go:95-109)."""
        self._lazy_expire()
        self._validate_lease_arg(lease)
        with self._locked([key]):
            if key in self._stripes[self._sidx(key)].kv:
                return False
            self._put_locked(key, value, lease)
            return True

    def put_if_mod_rev(self, key: str, value: str, mod_rev: int,
                       lease: int = 0) -> bool:
        """CAS on mod revision (reference client.go:44-65).  mod_rev 0 means
        'must not exist'."""
        self._lazy_expire()
        self._validate_lease_arg(lease)
        with self._locked([key]):
            cur = self._stripes[self._sidx(key)].kv.get(key)
            if mod_rev == 0:
                if cur is not None:
                    return False
            elif cur is None or cur.mod_rev != mod_rev:
                return False
            self._put_locked(key, value, lease)
            return True

    def claim(self, fence_key: str, fence_val: str, fence_lease: int = 0,
              order_key: str = "", proc_key: str = "", proc_val: str = "",
              proc_lease: int = 0) -> bool:
        """Atomic execution claim — the dispatch plane's per-order hot op.

        One round trip replaces the agent's fence ``put_if_absent`` +
        proc-registry put + order-key delete chain (the reference pays up
        to 3 etcd RPCs per fire: lock txn job.go:243-271, proc put
        proc.go:209-237, and its own cleanup).  Semantics:

        - fence_key already exists -> the claim LOSES: the order key is
          still consumed (another node ran this (job, second)), nothing
          else changes, returns False;
        - otherwise the fence is written (under fence_lease), the proc
          key (if given) is written under proc_lease, the order key (if
          given) is deleted, and the claim WINS: returns True.

        Both leases are validated before any mutation, so an expired
        lease raises KeyError without a half-applied claim.
        """
        self._lazy_expire()
        keys = [k for k in (fence_key, order_key, proc_key) if k]
        with self._locked(keys):
            t0 = time.perf_counter_ns()
            # the lease lock is held across the whole claim so a lease
            # validated here cannot expire between validation and use
            with self._lease_lock:
                for lz in (fence_lease, proc_lease if proc_key else 0):
                    if lz:
                        self._check_lease(lz)
                if fence_key in self._stripes[self._sidx(fence_key)].kv:
                    if order_key:
                        self._delete_locked(order_key)
                    self._op_record("claim", t0)
                    return False
                self._put_locked(fence_key, fence_val, fence_lease)
                if proc_key:
                    self._put_locked(proc_key, proc_val, proc_lease)
                if order_key:
                    self._delete_locked(order_key)
                self._op_record("claim", t0)
                return True

    def claim_many(self, items: Sequence[Sequence[str]],
                   fence_lease: int = 0,
                   proc_lease: int = 0) -> List[bool]:
        """Batched :meth:`claim` under one striped acquisition: ``items``
        is [(fence_key, fence_val, order_key, proc_key, proc_val), ...];
        the two leases are shared by the whole batch (agents pool their
        fence and proc keys on shared leases anyway).  Returns one
        win/lose bool per item — an agent's claim batcher turns a burst
        of due executions into a single store round trip."""
        self._lazy_expire()
        keys = [k for it in items if len(it) >= 5
                for k in (it[0], it[2], it[3]) if k]
        with self._locked(keys):
            t0 = time.perf_counter_ns()
            # malformed items yield per-item False WITHOUT aborting the
            # batch (never a half-applied batch + whole-batch error) —
            # bit-for-bit the native stored's behavior
            any_proc = any(len(it) >= 5 and it[3] for it in items)
            with self._lease_lock:
                for lz in (fence_lease, proc_lease if any_proc else 0):
                    if lz:
                        self._check_lease(lz)
                out = []
                for it in items:
                    if len(it) < 5:
                        out.append(False)
                        continue
                    fence_key, fence_val, order_key, proc_key, proc_val = \
                        it[:5]
                    if fence_key in self._stripes[self._sidx(fence_key)].kv:
                        if order_key:
                            self._delete_locked(order_key)
                        out.append(False)
                        continue
                    self._put_locked(fence_key, fence_val, fence_lease)
                    if proc_key:
                        self._put_locked(proc_key, proc_val, proc_lease)
                    if order_key:
                        self._delete_locked(order_key)
                    out.append(True)
            self._op_record("claim_many", t0)
            return out

    def _claim_bundle_locked(self, order_key: str,
                             items: Sequence[Sequence[str]],
                             fence_lease: int, proc_lease: int) -> List[bool]:
        """Shared claim_bundle body.  Caller holds every involved stripe
        lock AND the lease lock (leases already validated)."""
        out = []
        for it in items:
            if len(it) < 4:
                out.append(False)
                continue
            fence_key, fence_val, proc_key, proc_val = it[:4]
            if fence_key in self._stripes[self._sidx(fence_key)].kv:
                out.append(False)
                continue
            self._put_locked(fence_key, fence_val, fence_lease)
            if proc_key:
                self._put_locked(proc_key, proc_val, proc_lease)
            out.append(True)
        if order_key:
            self._delete_locked(order_key)
        return out

    @staticmethod
    def _bundle_keys(order_key, items) -> List[str]:
        keys = [order_key] if order_key else []
        for it in items:
            if len(it) >= 4:
                keys.append(it[0])
                if it[2]:
                    keys.append(it[2])
        return keys

    def claim_bundle(self, order_key: str,
                     items: Sequence[Sequence[str]],
                     fence_lease: int = 0,
                     proc_lease: int = 0) -> List[bool]:
        """Consume one coalesced (node, second) dispatch bundle in a
        single atomic op: per-job fence claims + proc registrations for
        the winners, then ONE delete of the bundle order key.  ``items``
        is [(fence_key, fence_val, proc_key, proc_val), ...] — proc_key
        may be "" (short-run suppression registers later via the delay
        monitor).  The bundle key is the scheduler's outstanding-capacity
        reservation for the whole bundle; deleting it here — in the same
        locked op that writes the winners' proc keys — means the
        reservation converts to proc-key accounting with no window in
        which capacity is either double-counted or leaked.  Losing items
        (fence already held: another node ran that (job, second)) change
        nothing but still count toward the bundle's consumption; the key
        is deleted regardless of the win/lose mix, exactly once.
        Malformed items yield per-item False without aborting the
        bundle.  Leases are validated before any mutation."""
        self._lazy_expire()
        with self._locked(self._bundle_keys(order_key, items)):
            t0 = time.perf_counter_ns()
            any_proc = any(len(it) >= 4 and it[2] for it in items)
            with self._lease_lock:
                for lz in (fence_lease, proc_lease if any_proc else 0):
                    if lz:
                        self._check_lease(lz)
                out = self._claim_bundle_locked(order_key, items,
                                                fence_lease, proc_lease)
            self._op_record("claim_bundle", t0)
            return out

    def claim_bundle_many(self, bundles: Sequence[Sequence],
                          fence_lease: int = 0,
                          proc_lease: int = 0) -> List[List[bool]]:
        """Consume SEVERAL coalesced bundles in one atomic op: ``bundles``
        is [(order_key, items), ...] with claim_bundle's item format; the
        two leases are shared by every bundle (agents pool fence and proc
        keys on shared leases).  Returns claim_bundle's win list per
        bundle, in order.  One catch-up drain that surfaces a backlog of
        due (node, second) bundles — the herd case — settles them all in
        a single store round trip instead of one RPC per bundle.
        Malformed bundles yield an empty win list without aborting the
        batch; leases are validated before any mutation."""
        self._lazy_expire()
        parsed: List[Optional[Tuple[str, Sequence]]] = []
        keys: List[str] = []
        for b in bundles:
            if len(b) < 2 or not isinstance(b[1], (list, tuple)):
                parsed.append(None)
                continue
            order_key, items = b[0], b[1]
            parsed.append((order_key, items))
            keys.extend(self._bundle_keys(order_key, items))
        with self._locked(keys):
            t0 = time.perf_counter_ns()
            any_proc = any(len(it) >= 4 and it[2]
                           for b in parsed if b is not None
                           for it in b[1])
            with self._lease_lock:
                for lz in (fence_lease, proc_lease if any_proc else 0):
                    if lz:
                        self._check_lease(lz)
                out: List[List[bool]] = []
                for b in parsed:
                    if b is None:
                        out.append([])
                        continue
                    out.append(self._claim_bundle_locked(
                        b[0], b[1], fence_lease, proc_lease))
            self._op_record("claim_bundle_many", t0)
            return out

    # ---- leases ----------------------------------------------------------

    def grant(self, ttl: float) -> int:
        with self._lease_lock:
            lid = self._next_lease
            self._next_lease += 1
            self._leases[lid] = Lease(lid, ttl, self._clock() + ttl)
            self._log(["g", lid, ttl, time.time() + ttl])
            return lid

    def keepalive(self, lease_id: int) -> bool:
        with self._lease_lock:
            l = self._leases.get(lease_id)
            # deadline counts even before the sweeper collects: an
            # expired lease must not be revivable (its keys are doomed)
            if l is None or l.deadline <= self._clock():
                return False
            l.deadline = self._clock() + l.ttl
            self._log(["k", lease_id, time.time() + l.ttl])
            return True

    def revoke(self, lease_id: int) -> bool:
        with self._lease_lock:
            l = self._leases.pop(lease_id, None)
            # lease removal logs as "x" (replay deletes attached keys
            # itself); the deletions below log their own "d" records
            if l is not None:
                self._log(["x", lease_id])
        if l is None:
            return False
        self._delete_keys(sorted(l.keys), only_lease=lease_id)
        return True

    def lease_ttl_remaining(self, lease_id: int) -> Optional[float]:
        with self._lease_lock:
            l = self._leases.get(lease_id)
            return None if l is None else l.deadline - self._clock()

    def _expire_leases(self):
        # cheap empty-table fast path: the common steady state for
        # stores carrying no leases.  Followers NEVER expire locally —
        # the leader ships the "x"/"d" records (repl_apply), otherwise
        # the replicas diverge on expiry timing.
        if not self._leases or self._repl_follower:
            return
        now = self._clock()
        with self._lease_lock:
            expired = [l for l in self._leases.values()
                       if l.deadline <= now]
            for l in expired:
                del self._leases[l.id]
                self._log(["x", l.id])
        # key deletion happens OUTSIDE the lease lock through the normal
        # striped path (lock order: stripes before lease) — a doomed
        # key's events and attachments behave exactly as a delete would
        for l in expired:
            self._delete_keys(sorted(l.keys), only_lease=l.id)

    def _delete_keys(self, keys: Sequence[str], only_lease: int = 0):
        """Striped bulk delete.  ``only_lease`` guards the expiry/revoke
        window: between popping a lease and reaching here, a writer can
        have re-created or re-bound one of its keys under a NEW lease —
        that key now belongs to the new owner and must survive (the old
        global lock made this interleaving impossible; the check
        restores its semantics)."""
        if not keys:
            return
        with self._locked(keys):
            for k in keys:
                if only_lease:
                    cur = self._stripes[self._sidx(k)].kv.get(k)
                    if cur is None or cur.lease != only_lease:
                        continue
                self._delete_locked(k)

    # ---- watch -----------------------------------------------------------

    def watch(self, prefix: str, start_rev: int = 0,
              max_backlog: Optional[int] = None,
              events: str = "") -> Watcher:
        """Watch a prefix.  With ``start_rev`` > 0, replay retained events
        with mod_rev >= start_rev first (etcd WithRev) — a reconnecting
        watcher resumes without losing deltas.  Raises
        :class:`CompactedError` if the bounded history no longer reaches
        back that far, and :class:`WatchLost` if the replay itself
        overflows ``max_backlog`` (re-list instead).  ``events="delete"``
        suppresses PUT pushes server-side (etcd's WithFilterPut): the
        filter applies to the replay too.

        Registration holds every stripe lock (plus the event lock), so
        no concurrent mutation can land between the replayed history and
        the live stream: the client sees one strictly ordered stream."""
        with self._locked(all_stripes=True), self._ev_lock:
            w = Watcher(self, prefix, start_rev or self._rev,
                        max_backlog=max_backlog or Watcher.MAX_BACKLOG,
                        events=events)
            if start_rev and start_rev <= self._rev:
                # every revision 1..rev emitted exactly one event, so the
                # replay is complete iff the ring still holds start_rev
                oldest = (self._history[0].kv.mod_rev if self._history
                          else self._rev + 1)
                if start_rev < oldest and oldest > 1:
                    raise CompactedError(
                        f"start_rev {start_rev} compacted "
                        f"(oldest retained {oldest})")
                for ev in self._history:
                    if (ev.kv.mod_rev >= start_rev
                            and ev.kv.key.startswith(prefix)):
                        w._emit(ev)
                if w.lost:   # replay alone overflowed: don't register a
                    raise WatchLost(   # dead watcher, tell the caller
                        f"watch {prefix!r} replay overflowed; re-list")
            self._watchers.append(w)
            return w

    def _remove_watcher(self, w: Watcher):
        with self._ev_lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def _notify(self, ev: Event):
        """Caller holds the event lock: history append and watcher
        fan-out ride the revision assignment, which keeps every watch
        stream revision-ordered across stripes."""
        t0 = time.perf_counter_ns()
        self._history.append(ev)
        # copy: an overflowing watcher cancels itself (removes from the
        # list) from inside _emit
        for w in list(self._watchers):
            if ev.kv.key.startswith(w.prefix):
                w._emit(ev)
        self._op_record("watch_fanout", t0)
