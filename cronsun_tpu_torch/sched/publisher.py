"""Asynchronous, sharded publisher for planned dispatch windows.

The leader's bulk publish is the dispatch plane's store-side cost: at
the 1M x 10k north-star scale a window carries ~90k orders, and r4
measured 2.1 s for the single synchronous ``put_many`` — >50% of the
whole step, serialized INSIDE it.  This module moves the publish off the
step's critical path:

- **overlap**: ``step()`` hands the built window to :meth:`submit` and
  returns; the publish proceeds while the scheduler drains watches and
  plans the NEXT window (the device and the store work concurrently).
- **sharding**: each second's orders are chunked round-robin over N
  *lanes* — one store connection + one single-thread executor each —
  because one TCP connection's put_many was measured at ~43k orders/s
  (the server applies a connection's requests in arrival order).  On a
  single-core host lanes default to 1: the ceiling there is CPU, not
  the connection.
- **failover chunking**: seconds publish strictly oldest-first and the
  high-water mark advances after EACH second lands (reference resume
  semantics: node/node.go:121-141 replays then fires late, never
  never).  A leader that takes over a long missed span therefore
  starts dispatching within one chunk — not after the whole span — and
  a crash mid-catch-up re-plans only the unpublished tail.
- **backpressure**: at most ``max_backlog`` windows may be in flight;
  ``submit`` then blocks, surfacing the plane's true throughput in the
  step latency instead of queueing memory unboundedly.

Failure policy: a chunk retries with backoff a bounded number of times,
then its orders are dropped and counted (``publish_failures``) — the
orders are leased, so nothing the store never saw can leak; the
scheduler's next anti-entropy reconciles capacity.

:class:`WindowBuilder` (below) is the pipeline stage FEEDING this
publisher: it gathers a dispatched plan handle and builds the window's
orders off the step's critical path, so the device plans window N+1
while window N is strung and shipped (see ``SchedulerService.step``).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

from .. import log
from ..core.backoff import PUBLISH, PUBLISH_ATTEMPTS


class OrderPublisher:
    def __init__(self, lanes: Sequence, advance_hwm: Callable[[int], None],
                 chunk: int = 20_000, max_backlog: int = 2,
                 shard_of: Optional[Callable[[str], int]] = None):
        self._lane_conns = list(lanes)
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"pub{i}")
                       for i in range(len(self._lane_conns))]
        self._advance_hwm = advance_hwm
        self.chunk = chunk
        # per-shard publish decoupling: with ``shard_of`` each lane is
        # pinned to ONE store shard and a second's orders are routed
        # by key instead of round-robined — a browned-out shard's
        # writes queue on its own lane, and (because every second's
        # chunks are staged onto the lanes up front, with the
        # write-then-mark barrier applied per second IN ORDER
        # afterwards) the healthy shards' orders of LATER seconds land
        # at healthy latency instead of serializing behind the slow
        # shard's earlier seconds (~2·window_s·delay measured by the
        # brownout_dispatch drill).  None keeps the round-robin path.
        self._shard_of = shard_of
        self.shard_lanes = shard_of is not None
        # shard-lane mode runs a second, ORDERED barrier thread: the
        # _run worker stages each window's chunks the moment it
        # dequeues it, the barrier thread completes windows FIFO and
        # advances the HWM — so one slow shard delays its own lane's
        # writes and the mark, never the other shards' later windows
        self._bq: "queue.Queue | None" = (queue.Queue()
                                          if self.shard_lanes else None)
        self._barrier_thread: "threading.Thread | None" = None
        if self._bq is not None:
            self._barrier_thread = threading.Thread(
                target=self._barrier_run, daemon=True,
                name="order-publish-barrier")
            self._barrier_thread.start()
        self._sem = threading.Semaphore(max_backlog)
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"published_total": 0, "publish_failures": 0,
                      "publish_windows": 0, "publish_abandoned": 0}
        self.last_window_ms = 0.0
        self.published_through = 0   # every second < this is in the store
        # largest key count any single second published — the herd-burst
        # gauge: with coalesced orders a minute-boundary herd stays at
        # <= one key per active node (~10k at 1M x 10k) instead of one
        # per fire (~110k)
        self.max_second_keys = 0
        self._mu = threading.Lock()
        self._idle = threading.Condition(self._mu)
        self._inflight = 0
        self._stopping = False
        # lowest epoch whose publish ultimately failed; the scheduler
        # polls take_failed_epoch() and REWINDS its planning cursor
        # there (late, never lost) — the HWM must never advance past a
        # second whose orders are not actually in the store
        self._failed_epoch: "int | None" = None
        # HWM advances ride a COALESCING background thread: the mark is
        # recovery metadata (a fresh leader resumes planning from it),
        # and its get+CAS against the store was on the publish thread —
        # a browned-out shard hosting the hwm key taxed EVERY landed
        # second's publish by its round trip (measured by the
        # brownout_dispatch drill).  Only the LATEST landed mark is
        # written (intermediates coalesce); a crash before the write
        # re-plans a few already-published seconds, which fences and
        # broadcast dedup absorb — the exact crash contract the
        # synchronous write had between seconds.  flush() still
        # barriers on the mark landing.
        self._hwm_want = 0
        self._hwm_done = 0
        self._hwm_cv = threading.Condition()
        self._hwm_thread = threading.Thread(target=self._hwm_run,
                                            daemon=True,
                                            name="hwm-advance")
        self._hwm_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="order-publisher")
        self._thread.start()

    def _hwm_note(self, value: int):
        with self._hwm_cv:
            if value > self._hwm_want:
                self._hwm_want = value
                self._hwm_cv.notify()

    def _hwm_run(self):
        while True:
            with self._hwm_cv:
                while self._hwm_want <= self._hwm_done:
                    if self._stopping:
                        return
                    self._hwm_cv.wait(0.5)
                v = self._hwm_want
            try:
                self._advance_hwm(v)
            except Exception as e:  # noqa: BLE001 — keep _hwm_done
                # behind so the advance RETRIES (flush()'s contract is
                # 'the mark is written'; marking a failed write done
                # would let a checkpoint/kill drill restore from a mark
                # that never landed).  The lagging HWM itself is only
                # the bounded re-plan window, never a correctness loss.
                log.warnf("hwm advance to %d failed (will retry): %s",
                          v, e)
                with self._hwm_cv:
                    if self._stopping:
                        return
                    self._hwm_cv.wait(0.5)   # pace the retry
                continue
            with self._hwm_cv:
                self._hwm_done = max(self._hwm_done, v)
                self._hwm_cv.notify_all()

    # -- producer side -----------------------------------------------------

    def submit(self, seconds: List[Tuple[int, list]], lease: int,
               hwm: int, covers_from=None) -> float:
        """Queue one window: ``seconds`` = [(epoch, [(key, val), ...])],
        oldest first; ``hwm`` is the mark to advance to once the whole
        window has landed.  ``covers_from`` is the CONTIGUOUS start of
        the planned window (excluding any prepended out-of-band replan
        seconds): a submission whose covers_from is at or before an
        outstanding publish hole is the scheduler's rewound re-plan and
        clears the hole; anything else queued behind a hole is
        abandoned (and extends the hole to its own oldest second) so
        the monotone HWM can never pass unpublished fires.  Returns
        seconds spent blocked on backpressure."""
        t0 = time.perf_counter()
        self._sem.acquire()
        with self._mu:
            self._inflight += 1
        self._q.put((seconds, lease, hwm, covers_from))
        return time.perf_counter() - t0

    def clear_failed_epoch_below(self, epoch: int) -> bool:
        """Clear an outstanding publish hole strictly OLDER than
        ``epoch``.  Called by the scheduler when its catch-up clamp has
        moved the planning cursor past the hole: those seconds are now
        SKIPPED (counted), not re-planned, so no future window can ever
        satisfy ``covers_from <= failed_epoch`` — without this the hole
        abandons every subsequent window forever (a silent, permanent
        dispatch stall only a restart would fix).  Returns True if a
        hole was cleared."""
        with self._mu:
            if self._failed_epoch is not None and self._failed_epoch < epoch:
                self._failed_epoch = None
                return True
            return False

    def record_hole(self, epoch: int):
        """Mark a publish hole for a window that never REACHED submit —
        the pipeline's build stage calls this when a gather/build dies
        so the scheduler's next step rewinds its cursor and re-plans
        the window (late, never lost), exactly as for a failed
        publish."""
        self._mark_failed(epoch)

    @property
    def inflight(self) -> int:
        """Windows submitted but not yet fully published/abandoned."""
        return self._inflight

    def take_failed_epoch(self):
        """The lowest epoch whose orders were dropped after retries, or
        None.  NOT cleared by reading: the mark stands until a window
        COVERING the hole is dequeued for publishing (see _run), so
        stale post-hole windows already in the queue can't slip past
        the check and advance the HWM over unpublished seconds.  The
        caller may observe (and rewind for) the same hole on several
        consecutive steps — the re-planned duplicates are absorbed by
        fences/broadcast dedup."""
        with self._mu:
            return self._failed_epoch

    def flush(self, timeout: float = 120.0) -> bool:
        """Block until every submitted window has been published AND
        the latest landed HWM mark is written (the background advance
        joined — kill drills and checkpoints rely on flush meaning
        'persisted')."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        with self._hwm_cv:
            while self._hwm_done < self._hwm_want:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._hwm_cv.wait(left)
        return True

    def stop(self, timeout: float = 120.0):
        self.flush(timeout)
        self._stopping = True
        self._q.put(None)
        with self._hwm_cv:
            self._hwm_cv.notify_all()
        self._thread.join(timeout=5)
        if self._barrier_thread is not None:
            self._barrier_thread.join(timeout=5)
        self._hwm_thread.join(timeout=5)
        for p in self._pools:
            p.shutdown(wait=False)

    # -- worker side -------------------------------------------------------

    def _send(self, lane_i: int, chunk: list, lease: int) -> int:
        """One chunk; returns orders written (0 = definitively failed)."""
        conn = self._lane_conns[lane_i]
        err = None
        for attempt in range(PUBLISH_ATTEMPTS):
            try:
                conn.put_many(chunk, lease=lease)
                return len(chunk)
            except Exception as e:  # noqa: BLE001 — retry with backoff
                err = e
                PUBLISH.sleep(attempt + 1)
        with self._mu:   # lanes race here; += on a dict entry isn't atomic
            self.stats["publish_failures"] += len(chunk)
        log.errorf("publish chunk of %d failed after retries: %s",
                   len(chunk), err)
        return 0

    def _mark_failed(self, epoch: int):
        with self._mu:
            if self._failed_epoch is None or epoch < self._failed_epoch:
                self._failed_epoch = epoch

    def _stage_sharded(self, seconds, lease) -> List[list]:
        """Route every second's orders by store shard and submit the
        chunks to the per-shard lanes immediately; returns the futures
        grouped per second for the in-order barrier in _run."""
        n = len(self._pools)
        staged: List[list] = []
        for _epoch, orders in seconds:
            futs = []
            if orders:
                buckets: List[list] = [[] for _ in range(n)]
                shard_of = self._shard_of
                for kv in orders:
                    buckets[shard_of(kv[0]) % n].append(kv)
                for lane, bucket in enumerate(buckets):
                    for i in range(0, len(bucket), self.chunk):
                        futs.append(self._pools[lane].submit(
                            self._send, lane,
                            bucket[i:i + self.chunk], lease))
            staged.append(futs)
        return staged

    def _check_hole(self, covers_from) -> bool:
        """True when an outstanding hole shadows further publishing;
        clears the hole when ``covers_from`` proves this window is the
        scheduler's REWOUND re-plan (its contiguous start at/before
        the hole re-covers every second the hole shadowed).  Clearing
        belongs to the thread that OWNS publish ordering — _run on the
        round-robin path, the barrier thread in shard-lane mode (see
        _peek_hole_stale)."""
        with self._mu:
            holed = self._failed_epoch is not None
            if holed and covers_from is not None and \
                    covers_from <= self._failed_epoch:
                self._failed_epoch = None
                holed = False
        return holed

    def _peek_hole_stale(self, covers_from) -> bool:
        """Side-effect-free hole check for the shard-lane STAGING
        thread: True when an outstanding hole shadows this window and
        the window does not cover it.  The staging thread must NOT
        clear the hole for a covering re-plan — stale pre-rewind
        windows may still sit in the barrier queue ahead of it, and a
        clear here would let the barrier publish them past the hole's
        unpublished seconds (the write-then-mark violation).  The
        ORDERED barrier thread clears it when the covering window's
        turn comes."""
        with self._mu:
            return self._failed_epoch is not None and \
                not (covers_from is not None
                     and covers_from <= self._failed_epoch)

    def _abandon(self, seconds):
        """Abandon one window behind an outstanding hole: publishing it
        would advance the monotone HWM past the hole, and a crash
        before the rewound re-publish landed would lose the hole's
        fires forever.  Extends the hole to this window's own oldest
        second (it may carry matured replan fires older than the hole)
        and lets the rewind re-plan everything from there forward."""
        if seconds:
            self._mark_failed(min(ep for ep, _ in seconds))
        log.warnf("publish hole outstanding; abandoning queued "
                  "window of %d seconds for the re-plan", len(seconds))
        with self._mu:
            # a hole episode must be visible from metrics alone:
            # abandoned windows count as windows AND separately
            self.stats["publish_abandoned"] += 1
            self.stats["publish_windows"] += 1
        self.last_window_ms = 0.0
        self._sem.release()
        with self._idle:
            self._inflight -= 1
            self._idle.notify_all()

    def _publish_window(self, seconds, lease, hwm, staged, t0):
        """Publish (or, in shard-lane mode, barrier) one window:
        per-second completion strictly oldest-first, the mark moving
        ONLY once a second's orders are in the store — a crash between
        seconds re-plans the unpublished tail (a rare double fire
        beats silently missing one; fences/broadcast-dedup absorb the
        dup)."""
        n = len(self._pools)
        try:
            for si, (epoch, orders) in enumerate(seconds):
                ok = True
                if len(orders) > self.max_second_keys:
                    self.max_second_keys = len(orders)
                if orders:
                    if staged is not None:
                        futs = staged[si]
                    else:
                        futs = []
                        for ci, i in enumerate(range(0, len(orders),
                                                     self.chunk)):
                            lane = ci % n
                            futs.append(self._pools[lane].submit(
                                self._send, lane,
                                orders[i:i + self.chunk], lease))
                    sent = sum(f.result() for f in futs)
                    with self._mu:
                        self.stats["published_total"] += sent
                    ok = sent == len(orders)
                if not ok:
                    # the write-then-mark contract: the HWM must NOT
                    # move past a second whose orders are not in the
                    # store.  Abandon the rest of the window too (it
                    # would land out of order past the hole) and hand
                    # the epoch back for a re-plan — late, never lost.
                    self._mark_failed(epoch)
                    log.errorf(
                        "publish failed at epoch %d; window "
                        "abandoned for re-plan (%d seconds held "
                        "back)", epoch, len(seconds) - si)
                    break
                self._hwm_note(epoch + 1)
                self.published_through = max(self.published_through,
                                             epoch + 1)
            else:
                if hwm:
                    self._hwm_note(hwm)
                    self.published_through = max(self.published_through,
                                                 hwm)
        except Exception as e:  # noqa: BLE001 — keep publishing
            log.errorf("window publish failed: %s", e)
            if seconds:
                self._mark_failed(seconds[0][0])
        finally:
            self.last_window_ms = (time.perf_counter() - t0) * 1e3
            self.stats["publish_windows"] += 1
            self._sem.release()
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._bq is not None:
                    self._bq.put(None)
                return
            seconds, lease, hwm, covers_from = item
            t0 = time.perf_counter()
            if self._bq is None:
                if self._check_hole(covers_from):
                    self._abandon(seconds)
                    continue
                self._publish_window(seconds, lease, hwm, staged=None,
                                     t0=t0)
            else:
                if self._peek_hole_stale(covers_from):
                    # stale window behind an uncleared hole: abandon at
                    # stage time (cheap); a COVERING re-plan stages
                    # through and the barrier clears the hole in order
                    self._abandon(seconds)
                    continue
                # shard-lane mode: stage this window's chunks onto the
                # per-shard lanes NOW (per-lane FIFO keeps each shard's
                # write order across seconds AND windows) and hand the
                # in-order completion barrier to the barrier thread —
                # window N+1's healthy-shard writes land at healthy
                # latency while window N still waits out a slow
                # shard's legs (the pre-decoupling structural term:
                # the LAST second of every window paid ~2·window_s·
                # delay behind one slow shard)
                staged = self._stage_sharded(seconds, lease)
                self._bq.put((seconds, staged, hwm, covers_from, t0))

    def _barrier_run(self):
        """Ordered completion barrier for shard-lane mode: windows
        complete strictly FIFO, the HWM advances per landed second,
        and a window staged BEFORE a hole surfaced is drained but
        never advances the mark past the hole.  Its landed writes are
        normally re-covered by the rewound re-plan's bundle overwrites
        (the documented re-publish contract); if the hole instead ages
        past max_catchup_s and is SKIPPED (clear_failed_epoch_below),
        the already-landed orders execute late instead of being
        re-planned — leased (bounded life), fence-deduped, and agents
        re-fetch the job at claim time (deleted/paused -> skipped):
        the same late-never-lost posture as every re-publish path."""
        while True:
            item = self._bq.get()
            if item is None:
                return
            seconds, staged, hwm, covers_from, t0 = item
            if self._check_hole(covers_from):
                for futs in staged:
                    for f in futs:
                        try:
                            f.result()
                        except Exception:  # noqa: BLE001 — the send
                            pass           # already counted failures
                self._abandon(seconds)
                continue
            self._publish_window(seconds, lease=0, hwm=hwm,
                                 staged=staged, t0=t0)


class WindowBuilder:
    """The pipelined step's BUILD stage: one worker thread that turns a
    dispatched plan handle into published dispatch orders.

    ``step()`` hands each window over as a handle (gather deferred) and
    returns; the worker gathers the device result, builds the window's
    orders (the vectorized group-by-node build) and submits them to the
    :class:`OrderPublisher` — so the device plans window N+1 while this
    thread strings and ships window N, and the step's critical path is
    watch drain + reconcile + device flush + two async dispatches.

    Ordering: ONE worker, FIFO queue, feeding the publisher's FIFO —
    windows (and the seconds inside them) can never reorder.

    Backpressure: at most ``max_depth`` windows may be queued/in-flight
    in this stage; ``submit`` then blocks the step (counted in
    ``stats``) instead of queueing plans unboundedly — a publisher that
    can't keep up therefore stalls the NEXT plan, visibly, rather than
    racing it."""

    def __init__(self, build_fn: Callable[[object], None],
                 max_depth: int = 2):
        self._build_fn = build_fn
        self.max_depth = max_depth
        self._sem = threading.Semaphore(max_depth)
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"stalls_total": 0, "stall_ms_total": 0.0}
        self._mu = threading.Lock()
        self._idle = threading.Condition(self._mu)
        self._inflight = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="window-builder")
        self._thread.start()

    @property
    def depth(self) -> int:
        """Windows queued or being built in this stage right now."""
        return self._inflight

    def submit(self, item) -> float:
        """Queue one window for build+publish; returns seconds spent
        blocked on this stage's depth cap (0.0 when the pipeline kept
        up)."""
        stall = 0.0
        if not self._sem.acquire(blocking=False):
            t0 = time.perf_counter()
            self._sem.acquire()
            stall = time.perf_counter() - t0
            with self._mu:
                self.stats["stalls_total"] += 1
                self.stats["stall_ms_total"] += stall * 1e3
        with self._mu:
            self._inflight += 1
        self._q.put(item)
        return stall

    def flush(self, timeout: float = 120.0) -> bool:
        """Block until every submitted window has been built and handed
        to the publisher (NOT until published — flush the publisher for
        that)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def stop(self, timeout: float = 120.0):
        self.flush(timeout)
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._build_fn(item)
            except Exception as e:  # noqa: BLE001 — the build_fn owns
                # hole recording; this is the never-die backstop
                log.errorf("window build stage failed: %s", e)
            finally:
                self._sem.release()
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()
