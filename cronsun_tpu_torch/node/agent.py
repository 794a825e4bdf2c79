"""Node agent: a thin watch-and-exec shell.

Where the reference's node runs a full cron engine (node/node.go:445-464),
this agent only:

- registers its identity under a lease and keeps it alive
  (node/node.go:64-119 semantics: re-grant + re-put after lapses);
- watches its dispatch prefix for execution orders from the leader
  scheduler and runs them through the Executor;
- watches the once prefix for run-now triggers (value == own id or "" —
  reference node/node.go:423-442; bypasses locks and the parallels gate);
- fences exclusive executions with a create-if-absent (job, second) lock so
  a double-dispatch (leader failover race) still runs exactly once —
  the lease-fenced safety net the central assignment keeps from the
  reference's lock protocol (job.go:243-271);
- maintains the proc registry (leased running-execution keys,
  proc.go:209-256), writes the execution record + stats, and posts failure
  notices for the noticer (job.go:549-579).

Copy of ``cronsun_tpu/node/agent.py``, with two additions on the bundle
claim path: a bundle whose claim could not settle while the store was
unreachable is re-read and re-handled by :meth:`NodeAgent.poll` after
``redeliver_after`` seconds (the JAX agent re-delivers it only on a
resync after a lost watch), and a member a claim reports lost is read
back and counted won when its fence holds the claim's own nonce
(:meth:`NodeAgent._own_losses_won`).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

from .. import log, trace as _trace
from ..core import Group, Job, Keyspace, Node
from ..core.backoff import REC_FLUSH
from ..core.errors import DuplicateNode
from ..core.models import KIND_ALONE
from ..logsink import JobLogStore, LogRecord
from ..store.memstore import DELETE, MemStore, WatchLost
from .executor import ExecResult, Executor

VERSION = "v0.1.0-tpu"


class _ExecTask:
    __slots__ = ("fn", "finished")

    def __init__(self, fn):
        self.fn = fn
        self.finished = threading.Event()

    def done(self) -> bool:
        return self.finished.is_set()

    def run(self):
        try:
            self.fn()
        finally:
            self.finished.set()


class _ExecPool:
    """Bounded pool of DAEMON worker threads.  The reference spawns a
    goroutine per fire (cron.go:237-244); Python needs bounding under
    dispatch bursts, and the workers must be daemons — process exit must
    never block behind a long-running job command (stdlib
    ThreadPoolExecutor joins its non-daemon workers at exit)."""

    def __init__(self, workers: int, prefix: str):
        import queue
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._workers = workers
        for i in range(workers):
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{prefix}-{i}").start()

    def _worker(self):
        while True:
            task = self._q.get()
            if task is None:
                return
            task.run()

    def enqueue(self, task: _ExecTask):
        self._q.put(task)

    def shutdown(self):
        for _ in range(self._workers):
            self._q.put(None)      # idle workers exit; busy ones are daemons


class NodeAgent:
    def __init__(self, store: MemStore, sink: JobLogStore,
                 node_id: Optional[str] = None,
                 ks: Optional[Keyspace] = None,
                 ttl: float = 10.0, proc_ttl: float = 600.0,
                 lock_ttl: float = 300.0, proc_req: float = 0.0,
                 executor: Optional[Executor] = None,
                 clock: Callable[[], float] = time.time,
                 on_fatal: Optional[Callable] = None,
                 dep_events: bool = True,
                 trace_shift: int = _trace.DEFAULT_SHIFT):
        self.store = store
        self.sink = sink
        self.ks = ks or Keyspace()
        self.id = node_id or _local_id()
        self.ttl = ttl
        self.proc_ttl = proc_ttl
        self.lock_ttl = lock_ttl
        self.proc_req = proc_req   # short-run suppression (proc.go:218-236)
        # workflow DAG edge signal: publish one dep/ completion key per
        # finished round (value = the SCHEDULED epoch + outcome, so every
        # node of a Common fan-out writes the same round idempotently)
        self.dep_events = dep_events
        self.executor = executor or Executor()
        self.clock = clock
        self.on_fatal = on_fatal

        self._lease: Optional[int] = None
        self._proc_lease: Optional[int] = None
        self._procs: Dict[str, str] = {}   # live proc keys -> value
        self._procs_mu = threading.Lock()  # guards _procs + _proc_lease
        self._stop = threading.Event()
        self._threads = []
        self._open_watches()
        self.groups: Dict[str, Group] = {}
        self._load_groups()
        self.running: Dict[str, _ExecTask] = {}
        self._bseen: Dict[tuple, float] = {}   # broadcast (job, sec) dedup
        # executions run on a bounded pool: the reference spawns a
        # goroutine per fire (cron.go:237-244) but an unbounded Python
        # thread per order collapses under a dispatch burst — the pool
        # queues instead (orders run late, never dropped, never early)
        self.max_inflight = 64
        self._pool = None
        # staged (not yet due) orders: one monitor thread scans for due
        # work — no per-order timers, and stop() can atomically drop the
        # backlog under the same lock the monitor enqueues under
        self._staged: Dict[str, Tuple[_ExecTask, int]] = {}
        self._stage_mu = threading.Lock()
        self._stage_monitor: Optional[threading.Thread] = None
        self._fence_mu = threading.Lock()
        self._fence_lease_id: Optional[int] = None
        self._fence_rotate_at = 0.0
        # one-RPC claim support (store.claim collapses the fence +
        # proc-registry + order-consume chain); detected once, legacy
        # multi-RPC chain kept as the fallback for older stores
        self._claim_supported = True
        # claim batcher: concurrent due executions queue their claims
        # here and ONE claim_many round trip settles the whole burst
        # (group-commit dynamics: whatever piles up during the in-flight
        # RPC forms the next batch)
        self._claim_pending: list = []
        self._claim_cv = threading.Condition()
        self._claim_thread: Optional[threading.Thread] = None
        import itertools
        self._claim_seq = itertools.count(1)   # per-attempt fence nonces
        # bundle-claim batcher: concurrent due (node, second) bundles —
        # a catch-up drain surfacing a whole backlog at once, the herd
        # case — group-commit into ONE claim_bundle_many round trip; a
        # lone bundle goes through the plain claim_bundle op (equally
        # one RPC, and the degraded-store ladder stays byte-identical)
        self._bundle_pending: list = []
        self._bundle_cv = threading.Condition()
        self._bundle_thread: Optional[threading.Thread] = None
        self._bundle_many_supported = True
        # bundles whose claim could not settle (store unreachable, or a
        # transport error before the claim): the order stays leased in
        # the store and no watch event brings it back, so poll re-reads
        # each after redeliver_after seconds and re-handles what is
        # still there (the (job, second) fences keep a re-run
        # exactly-once).  The JAX package's agent leaves them to a
        # resync after a lost watch, which may come too late or never.
        self._unclaimed: set = set()
        self._unclaimed_mu = threading.Lock()
        self._redeliver_at: Optional[float] = None
        self.redeliver_after = 2.0
        self.redelivered = 0        # orders re-handled that way
        # consumed-order ACKS buffer here and flush in periodic
        # delete_many batches: order deletion is capacity bookkeeping,
        # not correctness (exactly-once rests on the (job, second)
        # fences), so a slow store must never stall an executor thread
        # on a per-fire delete RPC
        self._ack_buf: list = []
        self._ack_mu = threading.Lock()
        # pop+delete ride one flush mutex (the record flusher's pattern):
        # join_running/stop use _flush_acks as a completion barrier, so a
        # batch the background flusher already popped must not still be
        # in flight when a barrier flush returns empty-handed
        self._ack_flush_mu = threading.Lock()
        self._ack_thread: Optional[threading.Thread] = None
        self.ack_flush_interval = 0.05
        # execution records buffer here and flush in batches over the
        # result-store wire (one bulk call per interval, not one round
        # trip per execution — the reference pays 4 Mongo writes per
        # execution, job_log.go:84-133)
        self._rec_buf: list = []
        self._rec_mu = threading.Lock()
        self._rec_flush_mu = threading.Lock()   # pop+write atomicity
        self._rec_flusher: Optional[threading.Thread] = None
        self.rec_flush_interval = 0.05
        # a failed batch parks in the retry slot (idempotency token
        # pinned) and retries with exponential backoff (0.5 s .. 10 s
        # between attempts, NOT every 50 ms flush tick — fast-failing
        # connects would otherwise burn all attempts in ~1 s) for this
        # many attempts before it is declared lost: ~4-5 minutes of
        # sink outage coverage
        self.rec_flush_max_fails = 30
        self._rec_flush_fails = 0
        # (batch, batch idem token, per-record idem tokens, trace spans)
        self._rec_retry: Optional[Tuple[list, str, list, list]] = None
        self._rec_retry_at = 0.0
        # sink-outage backstop: the live buffer stops growing here
        # (oldest dropped, counted) instead of absorbing the outage in
        # unbounded memory
        self.rec_buf_max = 100_000
        self._rec_dropped = 0
        self._rec_drop_log_at = 0.0
        # per-record idempotency on the degraded (no-create_job_logs)
        # path needs the sink to accept an idem kwarg; resolved lazily
        # from the signature (None = not yet probed) — catching
        # TypeError at the call site would misread a TypeError raised
        # INSIDE a conforming sink as "no idem support" and silently
        # disable dedup forever
        self._sink_takes_idem: Optional[bool] = None
        self._sink_spans_ok: Optional[bool] = None
        # record-plane flush telemetry: flush count, records shipped,
        # and the largest batch one flush carried (the coalescing win
        # the bench reads as records-per-flush)
        self._rec_flush_max_batch = 0
        # delayed proc-registry puts (the ProcReq threshold) ride ONE
        # monitor thread instead of a threading.Timer per execution —
        # a timer thread per order was a measured top cost of the
        # dispatch plane at >1k orders/s
        self._pdelay: Dict[int, Tuple[float, Callable]] = {}
        self._pdelay_mu = threading.Lock()
        self._pdelay_thread: Optional[threading.Thread] = None
        self._pdelay_seq = 0
        # snapshot of the process environment taken once: rebuilding the
        # cron-context env from the live os.environ mapping proxy costs
        # ~70 dict-proxy lookups per execution (measured in the dispatch
        # profile); post-start environment changes don't propagate to
        # jobs, which matches the reference (os/exec inherits the env
        # captured at Cmd construction)
        self._base_env = dict(os.environ)
        # watch-invalidated job cache (the reference keeps every job in
        # memory, maintained by watchJobs, node/node.go:121-141,361-391;
        # here bounded and filled on demand so a 1M-job fleet doesn't
        # cost each agent a gigabyte)
        self._job_cache: Dict[tuple, Job] = {}
        self._job_cache_cap = 65536
        # operator metrics (rendered fleet-wide at /v1/metrics); counters
        # are bumped from concurrent pool workers -> lock the increments
        self.stats = {"orders_consumed_total": 0, "execs_total": 0,
                      "execs_failed_total": 0, "watch_losses_total": 0,
                      "ack_flush_total": 0, "ack_flush_orders_total": 0,
                      "rec_flush_total": 0, "rec_flush_records_total": 0,
                      "rec_dropped_total": 0, "dep_events_total": 0,
                      "dep_event_failures_total": 0,
                      "trace_spans_total": 0, "trace_spans_dropped_total": 0}
        # fire-lifecycle tracing: head-sampled (or failed, or per-job
        # trace:true) executions buffer a span here and ride the record
        # flush — zero extra RPCs on the hot path.  The verdict is the
        # same deterministic trace-id hash the scheduler stamps bundles
        # by; CRONSUN_TRACE=off (or trace_shift < 0) disables stamping.
        self.trace_shift = trace_shift if _trace.armed() else -1
        self._span_buf: list = []          # guarded by _rec_mu
        self._span_buf_max = 10_000
        # SLO counters: per-scope execution latency histogram + failure
        # count over EVERY execution (not the sampled subset — burn
        # rates must be unbiased).  Scopes: "" fleet-wide, "t:<tenant>"
        # per tenant, "c:<group>/<job>" per DAG chain member.  The web
        # tier's SLO engine scrapes these from the leased metrics
        # snapshot and sums them across agents (fixed buckets add).
        self._slo: Dict[str, list] = {}    # scope -> [count, fail,
        self._slo_cap = 256                #           sum_ms, buckets]
        self._stats_mu = threading.Lock()
        # scheduled-second -> exec-start lag samples (the end-to-end
        # dispatch SLA), published as p50/p99 in the metrics snapshot
        self._lag_ring: list = []
        from ..metrics import MetricsPublisher
        self.metrics = MetricsPublisher(
            store, self.ks, "node", self.id, self.metrics_snapshot,
            interval_s=10.0, clock=clock)

    def _open_watches(self):
        self._w_dispatch = self.store.watch(
            self.ks.dispatch + self.id + "/")
        self._w_broadcast = self.store.watch(self.ks.dispatch_all)
        self._w_groups = self.store.watch(self.ks.group)
        self._w_once = self.store.watch(self.ks.once)
        self._w_jobs = self.store.watch(self.ks.cmd)

    # ---- registration (node/node.go:64-119) ------------------------------

    def register(self):
        self._probe_duplicate()
        self._lease = self.store.grant(self.ttl + 2)
        self.store.put(self.ks.node_key(self.id),
                       f"{socket.gethostname()}:{os.getpid()}",
                       lease=self._lease)
        self._ensure_proc_lease()
        node = Node(id=self.id, pid=os.getpid(), ip=self.id,
                    hostname=socket.gethostname(), version=VERSION,
                    up_ts=self.clock(), alived=True)
        self.sink.upsert_node(self.id, node.to_json(), alived=True)

    def _probe_duplicate(self):
        """Duplicate-node guard (reference node.go:51-79): if the node key
        is already registered, refuse to start rather than fight over the
        lease.  The registration value is ``hostname:pid``; the signal-0
        probe only applies when the registration came from THIS machine —
        a same-host dead PID (crashed agent) is taken over.  A different
        host's registration is refused outright while its lease lives
        (node death clears it within ttl+2 s); we cannot probe a remote
        PID, and assuming it dead would run two agents under one identity.
        EPERM from the probe means the process exists (owned by another
        user) — that is a live duplicate, not a stale key."""
        kv = self.store.get(self.ks.node_key(self.id))
        if kv is None:
            return
        host, _, pid_s = kv.value.rpartition(":")
        try:
            pid = int(pid_s)
        except ValueError:
            return          # unparseable legacy value: take over
        me = socket.gethostname()
        if host and host != me:
            raise DuplicateNode(
                f"node {self.id!r} already registered on host {host!r} "
                f"(pid {pid}); its lease has not expired")
        if pid == os.getpid():
            return          # keepalive re-register path: our own key
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return          # stale registration from a dead process
        except PermissionError:
            pass            # exists, different user: live duplicate
        raise DuplicateNode(
            f"node {self.id!r} already registered by live pid {pid}")

    def _ensure_proc_lease(self):
        """Keep the shared proc lease alive; on a lapse grant a fresh one
        and re-attach the proc keys of still-running executions (on a lapse
        the keys die with the old lease and the executing list / capacity
        reconciliation would otherwise lose them).  A healthy lease is
        reused — no spurious re-puts."""
        with self._procs_mu:
            if (self._proc_lease is None
                    or not self.store.keepalive(self._proc_lease)):
                self._repair_proc_lease_locked()

    def _repair_proc_lease_locked(self):
        """Grant a fresh proc lease and re-attach live proc keys.  Caller
        must hold ``_procs_mu``."""
        self._proc_lease = self.store.grant(self.proc_ttl)
        for k, v in self._procs.items():
            self.store.put(k, v, lease=self._proc_lease)

    def keepalive_once(self) -> bool:
        ok = self._lease is not None and self.store.keepalive(self._lease)
        if not ok:
            self.register()     # reference re-registers after a lapse
        else:
            self._ensure_proc_lease()
        self.metrics.maybe_publish()
        return ok

    def _bump(self, counter: str, n: int = 1):
        with self._stats_mu:
            self.stats[counter] += n

    def metrics_snapshot(self) -> dict:
        with self._stats_mu:
            snap = dict(self.stats)
            lags = sorted(self._lag_ring)
        if lags:
            q = lambda p: lags[min(len(lags) - 1, int(p * len(lags)))]
            snap["exec_start_lag_p50_s"] = round(q(0.50), 3)
            snap["exec_start_lag_p99_s"] = round(q(0.99), 3)
        snap["running"] = len(self.running)
        snap["procs_registered"] = len(self._procs)
        snap["rec_flush_max_batch"] = self._rec_flush_max_batch
        with self._rec_mu:
            snap["rec_buf"] = len(self._rec_buf)
            snap["trace_span_buf"] = len(self._span_buf)
        # per-scope SLO counters (nested — the generic /v1/metrics
        # numeric-leaf renderer skips it; the web SLO engine and the
        # exec-latency histogram renderer read it explicitly)
        with self._stats_mu:
            if self._slo:
                snap["slo"] = {
                    s: {"count": e[0], "fail": e[1],
                        "sum_ms": round(e[2], 3), "buckets": list(e[3]),
                        "fbuckets": list(e[4])}
                    for s, e in self._slo.items()}
        return snap

    def _record_flushed(self, n: int):
        with self._stats_mu:
            self.stats["rec_flush_total"] += 1
            self.stats["rec_flush_records_total"] += n
        if n > self._rec_flush_max_batch:
            self._rec_flush_max_batch = n

    def unregister(self):
        if self._lease is not None:
            self.store.revoke(self._lease)
            self._lease = None
        if self._proc_lease is not None:
            self.store.revoke(self._proc_lease)
            self._proc_lease = None
        self.metrics.revoke()   # don't render a gone node for the TTL
        self.sink.set_node_alived(self.id, False)

    # ---- local eligibility (reference IsRunOn, job.go:616-630) -----------

    def _load_groups(self):
        for kv in self.store.get_prefix(self.ks.group):
            self._apply_group(kv.value)

    def _apply_group(self, value: str):
        try:
            g = Group.from_json(value)
        except (json.JSONDecodeError, TypeError):
            return
        self.groups[g.id] = g

    def _poll_groups(self):
        for ev in self._w_groups.drain():
            if ev.type == DELETE:
                self.groups.pop(ev.kv.key[len(self.ks.group):], None)
            else:
                self._apply_group(ev.kv.value)

    def is_run_on(self, job: Job) -> bool:
        """Does any rule place this job on this node?  Include nodes ∪
        include groups − exclude nodes, subtractive exclude (the intended
        semantics; the reference's inner-loop continue is a no-op bug —
        SURVEY.md §7)."""
        for rule in job.rules:
            if self.id in rule.exclude_nids:
                continue
            if self.id in rule.nids:
                return True
            if any(self.id in g.node_ids
                   for gid in rule.gids
                   if (g := self.groups.get(gid)) is not None):
                return True
        return False

    # ---- job lookup ------------------------------------------------------

    def _get_job(self, group: str, job_id: str) -> Optional[Job]:
        cached = self._job_cache.get((group, job_id))
        if cached is not None:
            return cached
        kv = self.store.get(self.ks.job_key(group, job_id))
        if kv is None:
            return None
        try:
            job = Job.from_json(kv.value)
        except (json.JSONDecodeError, TypeError):
            return None
        job.group, job.id = group, job_id
        if len(self._job_cache) >= self._job_cache_cap:
            self._job_cache.clear()        # rare full reset beats LRU math
        self._job_cache[(group, job_id)] = job
        return job

    def _poll_jobs(self):
        """Job watch feeds cache invalidation (drained BEFORE the
        dispatch watch, so an order never runs against a staler view of
        its job than the store had when the order arrived)."""
        for ev in self._w_jobs.drain():
            rest = ev.kv.key[len(self.ks.cmd):]
            if "/" not in rest:
                continue
            key = tuple(rest.split("/", 1))
            if ev.type == DELETE:
                self._job_cache.pop(key, None)
            elif key in self._job_cache:
                try:
                    job = Job.from_json(ev.kv.value)
                    job.group, job.id = key
                    self._job_cache[key] = job
                except (json.JSONDecodeError, TypeError):
                    self._job_cache.pop(key, None)

    # ---- execution -------------------------------------------------------

    def _wait_until(self, epoch_s: int) -> bool:
        """Block until ``epoch_s`` arrives.  The scheduler publishes the
        whole planned window [t+1, t+W] ahead of wall-clock; a job must
        never run before its cron instant (the reference only ever fires
        late — cron.go:212-215).  Returns False if the agent is stopping."""
        while True:
            delay = epoch_s - self.clock()
            if delay <= 0:
                return True
            # bounded naps so injected (virtual) clocks still make progress
            if self._stop.wait(min(delay, 0.05)):
                return False

    def _acquire_alone_lock(self, job: Job):
        """Fleet-wide running lock for KindAlone: held under a lease with
        keepalive for the execution's lifetime, released on completion
        (reference job.go:87-123).  A still-running Alone job blocks the
        next fire everywhere.  Returns (lease, stop_event) or None if the
        lock is already live."""
        # TTL is a crash-safety net only (keepalive holds the lock while we
        # live); sized from the cost estimate like the reference's lockTtl
        # (job.go:194-233).
        ttl = max(5.0, min(self.lock_ttl, 2.0 * job.avg_time + 5.0))
        lease = self.store.grant(ttl)
        if not self.store.put_if_absent(
                self.ks.alone_lock_key(job.id), self.id, lease=lease):
            self.store.revoke(lease)
            return None
        stop = threading.Event()

        def ka_loop():
            # transient store errors (RPC timeout, reconnecting TCP) must
            # not kill the keepalive — the lock would expire mid-run and a
            # second Alone execution could overlap
            while not stop.wait(max(0.5, ttl / 3)):
                try:
                    if not self.store.keepalive(lease):
                        return   # lease definitively gone
                except Exception as e:  # noqa: BLE001
                    log.warnf("alone-lock keepalive for %s failed "
                              "(retrying): %s", job.id, e)
        threading.Thread(target=ka_loop, daemon=True,
                         name=f"alone-ka-{job.id}").start()
        return lease, stop

    def _execute(self, job: Job, epoch_s: int, fenced: bool,
                 use_gate: bool = True, order_key: Optional[str] = None,
                 pre: Optional[tuple] = None,
                 tr: Optional[tuple] = None):
        """Run one fire.  ``pre`` = (proc_registered, alone) marks an
        execution whose (job, second) fence — and KindAlone lifetime
        lock — were already settled by a bundle claim (_run_bundle): the
        fence/claim section is skipped, the rest (proc lifecycle,
        executor, record) is identical.  ``tr`` = (tb, recv, claim)
        carries the trace-plane stamps collected upstream (any may be
        None); this path adds its own claim stamp when it settles the
        fence itself."""
        if not self._wait_until(epoch_s):
            return
        # the user-visible SLA: scheduled second -> execution start.
        # Orders arrive AHEAD of time (the planner publishes whole
        # windows) and are held to their instant, so this lag is pure
        # plane latency: late watch delivery, claim round trip, local
        # queueing.  Reference per-fire latency is a goroutine spawn
        # (cron.go:237-244); this is the number that must stay bounded.
        lag = max(0.0, self.clock() - epoch_s)
        with self._stats_mu:
            self._lag_ring.append(lag)
            del self._lag_ring[:-512]
        alone = None
        order_done = [False]

        def consume_order():
            if order_key is not None and not order_done[0]:
                order_done[0] = True
                # buffered ack: a slow store must not stall this
                # executor thread on a per-fire delete RPC
                self._ack(order_key)
                self._bump("orders_consumed_total")

        try:
            proc_key = self.ks.proc_key(self.id, job.group, job.id,
                                        f"{epoch_s}-{os.getpid()}")
            proc_val = json.dumps({"time": self.clock()})
            proc_registered = False
            if pre is not None:
                # bundle claim already won the fence (and holds any
                # Alone lock); adopt its proc/alone state and skip
                # straight to the proc lifecycle + run
                proc_registered, alone = pre
            if pre is None and fenced and job.kind == KIND_ALONE:
                # lifetime lock FIRST: a skip because the previous run is
                # still live must not consume the (job, second) fence
                alone = self._acquire_alone_lock(job)
                if alone is None:
                    return  # previous Alone run still live fleet-wide
            if pre is None and fenced and job.exclusive:
                # one-RPC claim: fence + proc registration + order
                # consume collapse into a single store round trip (the
                # per-execution chain was the dispatch plane's measured
                # bottleneck).  The proc key rides the claim only when
                # the job is EXPECTED to outlive proc_req (cost
                # estimate); a mispredicted long run still registers via
                # the delay timer below, exactly the reference's ProcReq
                # threshold semantics (proc.go:218-236).
                with_proc = self.proc_req <= 0 or \
                    job.avg_time >= self.proc_req
                won = self._claim(job, epoch_s, order_key,
                                  proc_key if with_proc else "", proc_val)
                if order_key is not None:
                    order_done[0] = True    # claim consumed it, win or lose
                    self._bump("orders_consumed_total")
                if not won:
                    return  # another node already ran this (job, second)
                if self.trace_shift >= 0:
                    tr = ((tr[0], tr[1]) if tr else (None, None)) \
                        + (self.clock(),)
                if with_proc:
                    proc_registered = True
                    with self._procs_mu:
                        self._procs[proc_key] = proc_val
            finished = [False]
            pdelay_token = None

            def put_proc():
                """Register the running execution.  With proc_req > 0 this
                runs from a delay timer so sub-threshold jobs never touch
                the store (reference proc.go:218-236); the dispatch order
                key is consumed in the same breath — until then it is the
                scheduler's outstanding-capacity reservation."""
                with self._procs_mu:
                    if finished[0]:
                        return
                    self._procs[proc_key] = proc_val
                    try:
                        self.store.put(proc_key, proc_val,
                                       lease=self._proc_lease or 0)
                    except KeyError:
                        # proc lease expired under us — repair + re-attach
                        self._repair_proc_lease_locked()
                consume_order()

            if proc_registered:
                pass                    # claim already wrote the proc key
            elif self.proc_req > 0:
                pdelay_token = self._schedule_proc_put(put_proc)
            else:
                put_proc()
            try:
                res = self.executor.run_job(
                    job_id=job.id, command=job.command, user=job.user,
                    timeout=job.timeout, retry=job.retry,
                    interval=job.interval,
                    parallels=job.parallels if use_gate else 0,
                    # cron-context environment: jobs learn which second
                    # they were scheduled FOR (begin_ts in the log is
                    # when they actually ran — under load the two can
                    # differ, and scripts that write period-stamped
                    # artifacts need the scheduled one)
                    env={**self._base_env,
                         "CRONSUN_NODE": self.id,
                         "CRONSUN_JOB_ID": job.id,
                         "CRONSUN_JOB_GROUP": job.group,
                         "CRONSUN_JOB_NAME": job.name,
                         "CRONSUN_SCHEDULED_TS": str(epoch_s)})
            finally:
                if pdelay_token is not None:
                    self._cancel_proc_put(pdelay_token)
                with self._procs_mu:
                    finished[0] = True
                    if self._procs.pop(proc_key, None) is not None:
                        try:
                            self.store.delete(proc_key)
                        except Exception as e:  # noqa: BLE001
                            # registry cleanup is bookkeeping — the
                            # leased key ages out; a degraded store
                            # must not destroy a FINISHED execution's
                            # record (and span) below
                            log.warnf("proc delete for %s failed "
                                      "(lease will expire it): %s",
                                      proc_key, e)
        finally:
            if alone is not None:
                lease, stop = alone
                stop.set()
                try:
                    self.store.revoke(lease)  # deletes the alone lock
                except Exception as e:  # noqa: BLE001 — TTL cleans up
                    log.warnf("alone lock revoke failed (lease will "
                              "expire it): %s", e)
            consume_order()                # consume the order regardless
        self._record(job, res, epoch_s, tr=tr)
        self._update_avg_time(job, res)

    _FENCE_GRACE = 60.0

    def _fence_lease(self) -> int:
        """Shared periodically-rotated fence lease (see _fence)."""
        with self._fence_mu:
            now = self.clock()
            if self._fence_lease_id is None or now >= self._fence_rotate_at:
                self._fence_lease_id = self.store.grant(
                    self.lock_ttl + self._FENCE_GRACE)
                self._fence_rotate_at = now + self.lock_ttl / 2
            return self._fence_lease_id

    def _rotate_fence_lease(self) -> int:
        with self._fence_mu:
            self._fence_lease_id = self.store.grant(
                self.lock_ttl + self._FENCE_GRACE)
            self._fence_rotate_at = self.clock() + self.lock_ttl / 2
            return self._fence_lease_id

    def _claim(self, job: Job, epoch_s: int, order_key: Optional[str],
               proc_key: str, proc_val: str) -> bool:
        """Execution claim: (job, second) fence + optional proc
        registration + order-key consume, atomic server-side.  Claims
        from concurrent executions funnel through a batcher so a burst
        of due orders costs ONE claim_many round trip, not one RPC per
        execution.  Falls back to the legacy multi-RPC chain on stores
        that predate the ops."""
        fence_key = self.ks.lock_key(job.id, epoch_s)
        # Fence VALUE is a per-attempt nonce (node id + unique suffix),
        # not the bare node id: after an INDETERMINATE claim (reply lost
        # on reconnect, batcher timeout) the fallback must distinguish
        # "my claim actually applied" (fence holds MY nonce -> won) from
        # "someone else won" and from "a previous attempt of mine on
        # this (job, second) won" — a bare-node-id owner check would
        # misread all three and either skip a won execution fleet-wide
        # or double-run on a re-delivered order.
        nonce = f"{self.id}@{os.getpid()}-{next(self._claim_seq)}"
        if self._claim_supported:
            item = (fence_key, nonce, order_key or "", proc_key,
                    proc_val)
            ev = threading.Event()
            slot = [None]
            with self._claim_cv:
                self._claim_pending.append((item, ev, slot))
                if self._claim_thread is None or \
                        not self._claim_thread.is_alive():
                    self._claim_thread = threading.Thread(
                        target=self._claim_flush_loop, daemon=True,
                        name=f"claims-{self.id}")
                    self._claim_thread.start()
                self._claim_cv.notify()
            ev.wait(timeout=30)
            if slot[0] is not None:
                return slot[0]
            # indeterminate: the RPC may or may not have applied.  Read
            # the fence back before falling to the legacy chain —
            # waiting out the store client's auto-heal (~0.2 s backoff):
            # a bare get here races the reconnect and would misread
            # "asked 50 ms too early" as "fence absent".
            kv = None
            for _ in range(12):
                try:
                    kv = self.store.get(fence_key)
                    break
                except Exception:  # noqa: BLE001 — still healing
                    time.sleep(0.5)
            else:
                return False    # store unreachable: do NOT run unfenced
            if kv is not None:
                if kv.value == nonce:
                    return True        # our claim DID apply (incl. its
                                       # proc put + order consume)
                if order_key is not None:
                    try:               # lost to another attempt: the
                        self.store.delete(order_key)   # claim may not
                    except Exception:  # noqa: BLE001  # have consumed it
                        pass
                return False
            # fence absent: the claim never applied — legacy chain
        won = self._fence(job.id, epoch_s, value=nonce)
        if not won:
            # TOCTOU on the indeterminate path: an in-flight claim_many
            # can apply BETWEEN the fence read-back above (absent) and
            # this put_if_absent (exists) — the existing fence may be
            # OUR OWN nonce (unique per attempt), which is a win, not a
            # loss
            try:
                kv = self.store.get(fence_key)
                won = kv is not None and kv.value == nonce
            except Exception:  # noqa: BLE001 — stay with the loss
                pass
        if order_key is not None:
            self.store.delete(order_key)
        if won and proc_key:
            with self._procs_mu:
                try:
                    self.store.put(proc_key, proc_val,
                                   lease=self._proc_lease or 0)
                except KeyError:
                    self._repair_proc_lease_locked()
                    self.store.put(proc_key, proc_val,
                                   lease=self._proc_lease or 0)
        return won

    def _claim_flush_loop(self):
        """Group-commit loop: settle every pending claim in one
        claim_many RPC; claims arriving during the in-flight RPC form
        the next batch."""
        while True:
            with self._claim_cv:
                while not self._claim_pending:
                    if self._stop.is_set():
                        return
                    self._claim_cv.wait(timeout=0.5)
                batch, self._claim_pending = self._claim_pending, []
            results = None
            try:
                results = self._claim_batch_rpc([b[0] for b in batch])
            except Exception as e:  # noqa: BLE001
                if "unknown op" in str(e):
                    log.warnf("store lacks claim_many; using the legacy "
                              "fence chain")
                    self._claim_supported = False
                else:
                    log.errorf("claim batch of %d failed (callers retry "
                               "via the legacy chain): %s", len(batch), e)
            for i, (_item, ev, slot) in enumerate(batch):
                slot[0] = results[i] if results is not None else None
                ev.set()

    def _claim_batch_rpc(self, items):
        fence_lease = self._fence_lease()
        with self._procs_mu:
            proc_lease = self._proc_lease or 0
        try:
            return self.store.claim_many(items, fence_lease, proc_lease)
        except KeyError:
            # a lease expired under us (suspended VM, clock jump):
            # rotate/repair both, retry once
            fence_lease = self._rotate_fence_lease()
            with self._procs_mu:
                self._repair_proc_lease_locked()
                proc_lease = self._proc_lease or 0
            return self.store.claim_many(items, fence_lease, proc_lease)

    # ---- buffered order acks --------------------------------------------

    def _ack(self, key: str):
        """Queue a consumed order key for the periodic delete_many
        flush.  The order key is the scheduler's outstanding-capacity
        reservation — deleting it is bookkeeping the plane can do
        lazily; a run's exactly-once never depends on it."""
        with self._ack_mu:
            self._ack_buf.append(key)
            if self._ack_thread is None or not self._ack_thread.is_alive():
                self._ack_thread = threading.Thread(
                    target=self._ack_flush_loop, daemon=True,
                    name=f"ackflush-{self.id}")
                self._ack_thread.start()

    def _ack_flush_loop(self):
        while not self._stop.wait(self.ack_flush_interval):
            self._flush_acks()

    def _flush_acks(self):
        with self._ack_flush_mu:
            self._flush_acks_locked()

    def _flush_acks_locked(self):
        with self._ack_mu:
            batch, self._ack_buf = self._ack_buf, []
        if not batch:
            return
        try:
            if hasattr(self.store, "delete_many"):
                self.store.delete_many(batch)
            else:                       # minimal store: per-key deletes,
                for k in batch:         # still off the exec path
                    self.store.delete(k)
        except Exception as e:  # noqa: BLE001
            # order keys are leased: on a store hiccup they age out
            # server-side, so a failed ack batch is dropped, not
            # retried into a backlog that outlives its usefulness
            log.warnf("order-ack flush of %d failed (keys age out): %s",
                      len(batch), e)
            return
        with self._stats_mu:
            self.stats["ack_flush_total"] += 1
            self.stats["ack_flush_orders_total"] += len(batch)

    def _fence(self, job_id: str, epoch_s: int,
               value: Optional[str] = None) -> bool:
        """(job, second) create-if-absent fence.  Fence keys ride a
        SHARED periodically re-granted lease — the reference pools its
        proc keys on one shared lease the same way (proc.go:60-123) —
        instead of one grant+revoke round trip pair per execution.  A
        batch's keys live between lock_ttl/2 + grace and lock_ttl +
        grace, comfortably beyond the scheduler's max re-dispatch
        horizon (max_catchup_s)."""
        lease = self._fence_lease()
        key = self.ks.lock_key(job_id, epoch_s)
        val = value if value is not None else self.id
        try:
            return self.store.put_if_absent(key, val, lease=lease)
        except KeyError:
            # lease expired under us (suspended VM, clock jump): rotate
            lease = self._rotate_fence_lease()
            return self.store.put_if_absent(key, val, lease=lease)

    def _update_avg_time(self, job: Job, res: ExecResult):
        """Close the cost loop: fold the measured runtime into the job's
        EWMA and persist it CAS-style (reference job.go:581-589,
        job_log.go:85-86).  The resulting watch event flows the new cost
        into the planner's waterfill."""
        if res.skipped:
            return
        dur = max(0.0, res.end_ts - res.begin_ts)
        # skip uninformative updates: a runtime within 10% of the current
        # EWMA would move the planner's cost estimate by nothing worth a
        # get+CAS round trip pair per execution.  Applies at avg_time==0
        # too — an instant job (dur < 0.1 s) must NOT pay a CAS per fire
        # forever (each CAS also churns the job watch fleet-wide: every
        # agent invalidates its cache and the scheduler re-applies the
        # job), and the planner floors its cost at 1.0 regardless.
        if abs(dur - job.avg_time) <= 0.1 * max(1.0, job.avg_time):
            return
        key = self.ks.job_key(job.group, job.id)
        for _ in range(3):
            kv = self.store.get(key)
            if kv is None:
                return
            try:
                cur = Job.from_json(kv.value)
            except (json.JSONDecodeError, TypeError):
                return
            cur.group, cur.id = job.group, job.id
            cur.update_avg_time(dur)
            if self.store.put_if_mod_rev(key, cur.to_json(), kv.mod_rev):
                return

    def _record(self, job: Job, res: ExecResult, epoch_s: int = 0,
                tr: Optional[tuple] = None):
        if res.skipped:
            return
        self._bump("execs_total")
        if not res.success:
            self._bump("execs_failed_total")
        self._slo_observe(job, res)
        if self.dep_events and epoch_s:
            # the workflow DAG edge signal: last-write-wins per job, the
            # value carries the SCHEDULED round so N Common nodes
            # completing one round write one idempotent value (the
            # scheduler's fold is a monotone max on it).  Best-effort —
            # a store outage here must not fail the execution path; the
            # round re-announces on the job's next completion.
            try:
                self.store.put(
                    self.ks.dep_key(job.group, job.id),
                    f"{int(epoch_s)}|{'ok' if res.success else 'fail'}")
                self._bump("dep_events_total")
            except Exception as e:  # noqa: BLE001 — degraded, not down
                self._bump("dep_event_failures_total")
                log.warnf("dep completion event for %s/%s failed: %s",
                          job.group, job.id, e)
        rec = LogRecord(
            job_id=job.id, job_group=job.group, name=job.name, node=self.id,
            user=job.user, command=job.command,
            output=res.output if res.success
            else f"{res.output}\n[error] {res.error}".strip(),
            success=res.success, begin_ts=res.begin_ts, end_ts=res.end_ts)
        span = self._trace_span(job, res, epoch_s, tr)
        # batch the result-store write: records buffer here and a
        # flusher writes whole batches per interval (create_job_logs —
        # one round trip and one sink transaction per batch, not per
        # execution)
        with self._rec_mu:
            self._rec_buf.append(rec)
            if span is not None:
                self._span_buf.append(span)
                if len(self._span_buf) > self._span_buf_max:
                    drop = len(self._span_buf) - self._span_buf_max
                    del self._span_buf[:drop]
                    self._bump("trace_spans_dropped_total", drop)
            # trim in 4096-record chunks: a per-append del of the list
            # head is an O(buffer) memmove inside _rec_mu on every
            # record once the cap pins — chunking amortizes it away
            if len(self._rec_buf) > self.rec_buf_max + 4096:
                drop = len(self._rec_buf) - self.rec_buf_max
                del self._rec_buf[:drop]
                # rate-limited: at dispatch-plane rates a per-record
                # error line (~8k/s measured) would make the log pipe
                # the next bottleneck of the outage
                self._rec_dropped += drop
                self._bump("rec_dropped_total", drop)
                now = self.clock()
                if now >= self._rec_drop_log_at:
                    self._rec_drop_log_at = now + 5.0
                    log.errorf("record buffer over %d during sink "
                               "outage; %d dropped so far",
                               self.rec_buf_max, self._rec_dropped)
            if self._rec_flusher is None or not self._rec_flusher.is_alive():
                self._rec_flusher = threading.Thread(
                    target=self._rec_flush_loop, daemon=True,
                    name=f"recflush-{self.id}")
                self._rec_flusher.start()
        if not res.success and job.fail_notify:
            msg = {"subject": f"[cronsun] job [{job.name}] fail",
                   "body": f"job: {job.group}/{job.id}\nnode: {self.id}\n"
                           f"output: {res.output}\nerror: {res.error}",
                   "to": job.to}
            self.store.put(self.ks.noticer_key(self.id),
                           json.dumps(msg, separators=(",", ":")))

    def _trace_span(self, job: Job, res: ExecResult, epoch_s: int,
                    tr: Optional[tuple]) -> Optional[dict]:
        """Build this execution's trace span, or None when the fire is
        not sampled.  Head-sampling re-derives the scheduler's verdict
        from the same deterministic hash; failed executions and
        ``trace: true`` jobs sample regardless (tail capture — their
        scheduler stages may be absent when the head said no)."""
        if self.trace_shift < 0 or not epoch_s:
            return None
        tid = _trace.trace_id(job.id, epoch_s)
        if not (getattr(job, "trace", False)
                or not res.success
                or _trace.head_sampled(tid, self.trace_shift)):
            return None
        ts = {"start": res.begin_ts, "end": res.end_ts}
        if tr is not None:
            for name, v in zip(("b", "recv", "claim"), tr):
                if v is not None:
                    ts[name] = v
        span = {"tid": str(tid), "job": job.id, "grp": job.group,
                "sec": int(epoch_s), "node": self.id,
                "ok": bool(res.success), "ts": ts}
        if job.tenant:
            span["ten"] = job.tenant
        self._bump("trace_spans_total")
        return span

    def _slo_observe(self, job: Job, res: ExecResult):
        """Per-scope SLO counters over EVERY execution: latency
        histogram (fixed fleet-wide buckets) + failure count + failure
        latency histogram, keyed "" / "t:<tenant>" / "c:<group>/<job>"
        (chain scope only for DAG members — bounded cardinality).  The
        failure buckets let the burn-rate engine count slow SUCCESSES
        exactly (bad = failed OR slow; without them a fast failure and
        a slow success are indistinguishable in the joint)."""
        import bisect
        lat_ms = max(0.0, (res.end_ts - res.begin_ts)) * 1e3
        bi = bisect.bisect_left(_trace.BUCKETS_MS, lat_ms)
        scopes = [""]
        if job.tenant:
            scopes.append("t:" + job.tenant)
        if job.deps is not None:
            scopes.append(f"c:{job.group}/{job.id}")
        with self._stats_mu:
            for s in scopes:
                ent = self._slo.get(s)
                if ent is None:
                    if len(self._slo) >= self._slo_cap:
                        continue       # bounded; global "" always fits
                    ent = self._slo[s] = [
                        0, 0, 0.0, [0] * (len(_trace.BUCKETS_MS) + 1),
                        [0] * (len(_trace.BUCKETS_MS) + 1)]
                ent[0] += 1
                if not res.success:
                    ent[1] += 1
                    ent[4][bi] += 1
                ent[2] += lat_ms
                ent[3][bi] += 1

    def _schedule_proc_put(self, fn) -> int:
        """Register a ProcReq-delayed proc put on the shared monitor
        thread; returns a token for :meth:`_cancel_proc_put`.  The fn
        itself is idempotent-safe (it checks the execution's finished
        flag under the procs lock), so the cancel race is harmless."""
        with self._pdelay_mu:
            self._pdelay_seq += 1
            token = self._pdelay_seq
            self._pdelay[token] = (self.clock() + self.proc_req, fn)
            if self._pdelay_thread is None or \
                    not self._pdelay_thread.is_alive():
                self._pdelay_thread = threading.Thread(
                    target=self._pdelay_loop, daemon=True,
                    name=f"procdelay-{self.id}")
                self._pdelay_thread.start()
        return token

    def _cancel_proc_put(self, token: int):
        with self._pdelay_mu:
            self._pdelay.pop(token, None)

    def _pdelay_loop(self):
        while True:
            with self._pdelay_mu:
                if self._stop.is_set() or not self._pdelay:
                    # clear the handle under the lock before exiting so a
                    # concurrent _schedule_proc_put spawns a fresh one
                    self._pdelay_thread = None
                    return
                now = self.clock()
                fns = [self._pdelay.pop(t)[1]
                       for t in [t for t, (ts, _f) in self._pdelay.items()
                                 if ts <= now]]
            for f in fns:
                try:
                    f()
                except Exception as e:  # noqa: BLE001
                    log.warnf("delayed proc put failed: %s", e)
            time.sleep(0.1)

    def _rec_flush_loop(self):
        """Drain the record buffer every ``rec_flush_interval``; exits
        once the agent is stopping and the buffer is empty (stop() does
        a final synchronous flush)."""
        while True:
            if self._stop.wait(self.rec_flush_interval):
                return
            self._flush_records()

    def _sink_takes_spans(self) -> bool:
        """Does the sink's bulk create accept the trace-span sidecar?
        Resolved once from the signature (the _sink_idem_ok contract:
        never from a caught TypeError)."""
        if self._sink_spans_ok is None:
            try:
                import inspect
                fn = getattr(self.sink, "create_job_logs", None)
                if fn is None:
                    self._sink_spans_ok = False
                else:
                    params = inspect.signature(fn).parameters
                    self._sink_spans_ok = "spans" in params or any(
                        p.kind == p.VAR_KEYWORD for p in params.values())
            except (TypeError, ValueError):
                self._sink_spans_ok = False
        return self._sink_spans_ok

    def _send_records(self, batch: list, idem: str,
                      toks: Optional[list] = None,
                      spans: Optional[list] = None) -> bool:
        """One write attempt.  On a mid-batch failure of the per-record
        path the already-written head is removed from ``batch`` (and
        ``toks``) in place, so a caller that re-buffers retries only
        the unwritten tail (re-sending the head would duplicate
        job-log rows).  ``toks`` are the per-record idempotency tokens
        minted when the batch first formed: they stay pinned across
        EVERY retry of the same logical records, so a record whose
        first per-record attempt committed with the reply lost dedups
        server-side on the re-send instead of double-inserting (the
        token contract of logsink/serve.py) — the same guarantee the
        bulk path gets from the batch-level ``idem``."""
        written = 0
        if spans:
            # record-flush stamp: when this attempt ships the batch —
            # re-stamped per retry so the stage measures the time the
            # records actually became visible, outages included
            fts = self.clock()
            for sp in spans:
                sp["ts"]["flush"] = fts
        try:
            if hasattr(self.sink, "create_job_logs"):
                if spans and self._sink_takes_spans():
                    self.sink.create_job_logs(batch, idem=idem,
                                              spans=spans)
                else:
                    self.sink.create_job_logs(batch, idem=idem)
            else:                   # minimal sink: per-record
                use_idem = toks is not None and self._sink_idem_ok()
                for k, r in enumerate(batch):
                    if use_idem:
                        self.sink.create_job_log(r, idem=toks[k])
                    else:
                        self.sink.create_job_log(r)
                    written += 1
            return True
        except Exception as e:  # noqa: BLE001 — sink client already
            del batch[:written]  # retried once; caller decides the rest
            if toks is not None:
                del toks[:written]
            log.warnf("record write failed (%d records unwritten): %s",
                      len(batch), e)
            return False

    def _sink_idem_ok(self) -> bool:
        """Does the sink's per-record create accept an ``idem`` kwarg?
        Resolved once from the signature, never from a caught
        TypeError (which could equally come from inside the sink)."""
        if self._sink_takes_idem is None:
            try:
                import inspect
                params = inspect.signature(
                    self.sink.create_job_log).parameters
                self._sink_takes_idem = "idem" in params or any(
                    p.kind == p.VAR_KEYWORD for p in params.values())
            except (TypeError, ValueError):  # builtins, odd callables
                self._sink_takes_idem = False
        return self._sink_takes_idem

    def _flush_records(self, final: bool = False, force: bool = False):
        # pop AND write under one flush mutex: join_running()/stop() use
        # this as a completion barrier, so a batch the background
        # flusher popped must not still be in flight when a barrier
        # flush returns empty-handed
        with self._rec_flush_mu:
            # Batching widened the blast radius of a sink hiccup from one
            # record to a whole flush interval, so a failed batch parks in
            # a retry slot — SEPARATE from the live buffer, with its
            # idempotency token pinned, so (a) an applied-but-reply-lost
            # bulk write dedups server-side on the retry instead of
            # double-inserting, and (b) records appended since never ride
            # a token the server may already have settled.  Only after
            # ``rec_flush_max_fails`` consecutive failures (or at
            # shutdown, when no retry can happen) is the batch dropped,
            # the way the reference tolerates a Mongo outage
            # (job_log.go:84).
            if self._rec_retry is not None:
                # ``force`` (join_running's visibility barrier) attempts
                # NOW even inside the backoff window — the sink may have
                # healed, and the barrier contract says records must be
                # visible on return whenever writing is possible at all
                early = self.clock() < self._rec_retry_at
                if not (final or force) and early:
                    return   # between backoff attempts; fresh waits too
                batch, idem, toks, spans = self._rec_retry
                if self._send_records(batch, idem, toks, spans):
                    self._record_flushed(len(batch))
                    self._rec_retry = None
                    self._rec_flush_fails = 0
                elif force and not final and early:
                    # a forced barrier attempt INSIDE the backoff window
                    # is extra-schedule: it must not burn the retry
                    # budget (a caller polling join_running during a
                    # sink outage would otherwise exhaust
                    # rec_flush_max_fails in seconds and drop the batch
                    # far earlier than the backoff intends)
                    return
                else:
                    self._rec_flush_fails += 1
                    if final or \
                            self._rec_flush_fails >= self.rec_flush_max_fails:
                        log.errorf(
                            "record flush failed (%d records dropped "
                            "after %d attempts)", len(batch),
                            self._rec_flush_fails)
                        self._bump("rec_dropped_total", len(batch))
                        self._rec_retry = None
                        self._rec_flush_fails = 0
                    else:
                        self._rec_retry_at = self.clock() + \
                            REC_FLUSH.delay(self._rec_flush_fails)
                        log.warnf("record flush failed (%d records held "
                                  "for retry %d/%d)", len(batch),
                                  self._rec_flush_fails,
                                  self.rec_flush_max_fails)
                        return   # sink still down; fresh records wait
            with self._rec_mu:
                batch, self._rec_buf = self._rec_buf, []
                spans, self._span_buf = self._span_buf, []
            if not batch and not spans:
                return
            # batch token + per-record tokens minted ONCE per logical
            # batch: both stay pinned in the retry slot so every
            # re-send (bulk or per-record degraded path) dedups
            # server-side.  Spans ride the same batch (and retry slot);
            # their ingest is last-write-wins per (trace, node), so a
            # replayed batch re-merges identical values.
            idem = uuid.uuid4().hex
            toks = [f"{idem}.{i}" for i in range(len(batch))]
            sent = len(batch)
            if self._send_records(batch, idem, toks, spans):
                self._record_flushed(sent)
            elif final:
                log.errorf("record flush failed (%d records dropped "
                           "at shutdown)", len(batch))
                self._bump("rec_dropped_total", len(batch))
            elif batch or spans:
                self._rec_retry = (batch, idem, toks, spans)
                self._rec_retry_at = self.clock() + REC_FLUSH.delay(1)

    # ---- event processing (synchronous; threads call these) --------------

    def poll(self, wait: float = 0.0) -> int:
        """Drain watchers, spawn executions.  Returns orders handled."""
        n = 0
        deadline = self.clock() + wait
        while True:
            try:
                self._poll_groups()
                self._poll_jobs()
                n += self._poll_dispatch()
                n += self._poll_broadcast()
                n += self._poll_once()
                n += self._redeliver_unclaimed()
            except WatchLost as e:
                log.warnf("agent watch lost (%s); resynchronizing", e)
                self._bump("watch_losses_total")
                n += self.resync_watches()
            if self.clock() >= deadline:
                break
            time.sleep(0.01)
        return n

    def resync_watches(self) -> int:
        """Rebuild all watch streams after a loss and reconcile from the
        store's current contents: groups reload; still-live dispatch
        orders and broadcasts re-run (exclusive runs are fenced by the
        (job, second) store lock; Common runs by the in-memory _bseen
        dedup — either way the retry is exactly-once).  Pending
        once-triggers are NOT re-run: we cannot know whether the previous
        stream delivered them and run-now has no fence; at-most-once is
        the safe reading."""
        for w in (self._w_dispatch, self._w_broadcast, self._w_groups,
                  self._w_once, self._w_jobs):
            try:
                w.close()
            except Exception:   # noqa: BLE001 — already-dead watchers
                pass
        self._open_watches()
        self.groups.clear()
        self._load_groups()
        self._job_cache.clear()    # invalidations inside the gap are lost
        n = 0
        for kv in self.store.get_prefix(self.ks.dispatch + self.id + "/"):
            n += self._handle_dispatch_kv(kv.key, kv.value,
                                          order_key=kv.key)
        for kv in self.store.get_prefix(self.ks.dispatch_all):
            n += self._handle_broadcast_kv(kv.key)
        return n

    def _hold_unclaimed(self, order_key: str):
        """Park a bundle whose claim could not settle for
        :meth:`_redeliver_unclaimed`."""
        with self._unclaimed_mu:
            self._unclaimed.add(order_key)
            if self._redeliver_at is None:
                self._redeliver_at = time.monotonic() + self.redeliver_after

    def _redeliver_unclaimed(self) -> int:
        """Re-handle the parked bundles still in the store, once their
        wait is over; a failed read parks them again."""
        with self._unclaimed_mu:
            if self._redeliver_at is None or \
                    time.monotonic() < self._redeliver_at:
                return 0
            keys, self._unclaimed = sorted(self._unclaimed), set()
            self._redeliver_at = None
        try:
            if hasattr(self.store, "get_many"):
                kvs = self.store.get_many(keys)
            else:
                kvs = [self.store.get(k) for k in keys]
        except Exception as e:  # noqa: BLE001 — still unreachable
            log.warnf("re-reading %d unclaimed orders failed: %s",
                      len(keys), e)
            for k in keys:
                self._hold_unclaimed(k)
            return 0
        n = 0
        for kv in kvs:
            if kv is None:
                continue        # consumed, or aged out with its lease
            self.redelivered += 1
            n += self._handle_dispatch_kv(kv.key, kv.value,
                                          order_key=kv.key)
        return n

    def _handle_dispatch_kv(self, key: str, value: str,
                            order_key: Optional[str] = None) -> int:
        rest = key[len(self.ks.dispatch) + len(self.id) + 1:]
        parts = rest.split("/")
        if len(parts) == 1:
            # coalesced (node, second) bundle: value = the job list.
            # "<epoch>" plain, or the partitioned scheduler's
            # "<epoch>.<partition>" form (the suffix scopes the
            # reservation to its publishing partition; the epoch is
            # what matters here).  A re-delivery (hole-rewind
            # overwrite, resync re-list) is absorbed by the
            # per-(job, second) fences at claim time.
            parsed = Keyspace.split_bundle_epoch(parts[0])
            if parsed is not None:
                return self._handle_bundle(key, parsed[0], value)
            return 0
        if len(parts) != 3:
            return 0
        # legacy per-(node, second, job) order — rollout tolerance for
        # windows published by a pre-coalescing scheduler
        epoch_s, group, job_id = int(parts[0]), parts[1], parts[2]
        job = self._get_job(group, job_id)
        if job is None or job.pause:
            self._ack(key)
            return 0
        # the order key stays in the store until the execution's proc
        # key exists — the scheduler counts it as an outstanding
        # capacity reservation in the meantime
        tr = (None, self.clock(), None) if self.trace_shift >= 0 else None
        self._spawn(job, epoch_s, fenced=True, order_key=order_key,
                    tr=tr)
        return 1

    def _handle_bundle(self, key: str, epoch_s: int, value: str) -> int:
        """Stage one coalesced (node, second) order for its instant.
        The bundle rides ONE staged task; at due time it settles every
        member's fence in one claim_bundle RPC and fans the winners out
        to the exec pool (_run_bundle)."""
        try:
            entries = json.loads(value)
        except (json.JSONDecodeError, TypeError):
            entries = None
        pairs = []
        tb = None
        if isinstance(entries, list):
            for e in entries:
                if isinstance(e, str) and "/" in e:
                    group, _, job_id = e.partition("/")
                    pairs.append((group, job_id))
                elif isinstance(e, dict):
                    # trace header the scheduler appends to a bundle
                    # with >= 1 sampled member (order-build wall time);
                    # spanless legacy bundles simply lack it
                    t = e.get("tb")
                    if isinstance(t, (int, float)):
                        tb = float(t)
        if not pairs:
            self._ack(key)           # malformed/empty: release the
            return 0                 # capacity reservation
        recv = self.clock() if self.trace_shift >= 0 else None
        NodeAgent._spawn_seq += 1
        name = f"bundle-{epoch_s}-{NodeAgent._spawn_seq}"

        def run():
            try:
                self._run_bundle(key, epoch_s, pairs, tb=tb, recv=recv)
            except Exception as e:  # noqa: BLE001 — log, don't die silent
                log.errorf("bundle %s failed: %s", name, e)
                self._hold_unclaimed(key)
            finally:
                self.running.pop(name, None)

        task = _ExecTask(run)
        self.running[name] = task
        self._stage_task(name, task, epoch_s)
        return len(pairs)

    def _run_bundle(self, order_key: str, epoch_s: int, pairs: list,
                    tb: Optional[float] = None,
                    recv: Optional[float] = None):
        """Consume one coalesced order: resolve the bundle's jobs (one
        get_many), settle KindAlone lifetime locks per job (lock FIRST —
        a skip because the previous run is still live must not consume
        the (job, second) fence), then claim every member's fence + the
        winners' proc keys + the bundle key's capacity reservation in
        ONE claim_bundle RPC, and hand the winners to the exec pool.
        Per-job exactly-once is unchanged: it still rests on the
        (job, second) create-if-absent fence, so a duplicate bundle
        delivery (hole-rewind overwrite, resync re-list, leader
        failover) re-claims and loses."""
        if not self._wait_until(epoch_s):
            return
        self._prefetch_pairs(pairs)
        runnable = []   # [job, alone, with_proc, proc_key, proc_val]
        items = []      # parallel (fence_key, nonce, proc_key, proc_val)
        try:
            for group, job_id in pairs:
                job = self._get_job(group, job_id)
                if job is None or job.pause:
                    continue
                alone = None
                if job.kind == KIND_ALONE:
                    alone = self._acquire_alone_lock(job)
                    if alone is None:
                        continue    # previous Alone run still live
                nonce = f"{self.id}@{os.getpid()}-{next(self._claim_seq)}"
                with_proc = self.proc_req <= 0 or \
                    job.avg_time >= self.proc_req
                proc_key = self.ks.proc_key(self.id, job.group, job.id,
                                            f"{epoch_s}-{os.getpid()}")
                proc_val = json.dumps({"time": self.clock()})
                items.append((self.ks.lock_key(job.id, epoch_s), nonce,
                              proc_key if with_proc else "", proc_val))
                runnable.append([job, alone, with_proc, proc_key,
                                 proc_val])
            if not items:
                # nothing claimable (paused/missing/Alone-skipped):
                # release the capacity reservation via the ack flusher
                self._ack(order_key)
                return
            wins = self._claim_bundle(order_key, items)
            if wins is None:
                # store unreachable: do NOT run unfenced.  Stop the
                # Alone keepalives so the locks expire server-side; the
                # leased bundle key is re-read and re-handled later.
                for ent in runnable:
                    if ent[1] is not None:
                        ent[1][1].set()
                        ent[1] = None
                self._hold_unclaimed(order_key)
                return
            self._bump("orders_consumed_total", len(items))
            # fence settled for the whole bundle: the claim-lag stamp
            # every member's span shares
            claim_ts = self.clock() if self.trace_shift >= 0 else None
            for won, ent in zip(wins, runnable):
                job, alone, with_proc, proc_key, proc_val = ent
                if not won:
                    # another node (or an earlier duplicate) ran this
                    # (job, second)
                    if alone is not None:
                        lease, stop = alone
                        stop.set()
                        ent[1] = None
                        self.store.revoke(lease)
                    continue
                if with_proc:
                    with self._procs_mu:
                        self._procs[proc_key] = proc_val
                ent[1] = None   # the execution owns the lock from here
                self._spawn(job, epoch_s, fenced=True,
                            pre=(with_proc, alone),
                            tr=(tb, recv, claim_ts))
        except BaseException:
            # an escaping error (a transport hiccup mid-acquire, a
            # degraded-path claim failure) must not leak a live Alone
            # keepalive — the lock would outlive this bundle and block
            # the job fleet-wide until the agent restarts.  Release
            # every lock not yet handed to an execution; revoke may
            # fail (store down) but the stopped keepalive lets the
            # lease expire.
            for ent in runnable:
                if ent[1] is not None:
                    lease, stop = ent[1]
                    stop.set()
                    try:
                        self.store.revoke(lease)
                    except Exception:  # noqa: BLE001 — TTL cleans up
                        pass
            raise

    def _claim_bundle(self, order_key: str, items: list):
        """One-RPC bundle consume with the degraded-store ladder:

        - ``claim_bundle`` op (normal path; expired shared leases are
          rotated/repaired and retried once), group-committed: several
          bundles due at once — a catch-up backlog — ride ONE
          ``claim_bundle_many`` round trip (``_claim_bundle_rpc``);
        - unknown op (a store predating the format): per-item legacy
          fences, then the reservation delete — N+1 RPCs, correct;
        - transport error (INDETERMINATE — the claim may have applied
          with the reply lost): read the fences back by nonce exactly
          like _claim's recovery — our nonce means the claim DID apply
          (incl. its proc puts and the order delete); another value is
          a loss; absent falls to a legacy fence with the SAME nonce.

        Returns per-item wins, or None when the store is unreachable
        (callers must not run unfenced)."""
        try:
            wins = self._claim_bundle_rpc(order_key, items)
        except Exception as e:  # noqa: BLE001 — degrade, never unfenced
            unsupported = isinstance(e, AttributeError) or \
                "unknown op" in str(e)
            if unsupported:
                log.warnf("store lacks claim_bundle; using per-item "
                          "fences")
                wins = [self._fence_item(it) for it in items]
                try:
                    self.store.delete(order_key)
                except Exception:  # noqa: BLE001 — leased key ages out
                    pass
                return wins
        else:
            return self._own_losses_won(items, wins)
        # indeterminate: read back, waiting out the client's auto-heal
        kvs = None
        for _ in range(12):
            try:
                if hasattr(self.store, "get_many"):
                    kvs = self.store.get_many([it[0] for it in items])
                else:
                    kvs = [self.store.get(it[0]) for it in items]
                break
            except Exception:  # noqa: BLE001 — still healing
                time.sleep(0.5)
        if kvs is None:
            return None     # store unreachable
        wins = []
        for it, kv in zip(items, kvs):
            if kv is not None:
                wins.append(kv.value == it[1])
            elif self._fence_item(it):
                wins.append(True)
            else:
                # the in-flight claim can still apply between the
                # read-back and the fence put: a loss to OUR OWN nonce
                # is the claim's win
                try:
                    kv2 = self.store.get(it[0])
                    wins.append(kv2 is not None and kv2.value == it[1])
                except Exception:  # noqa: BLE001 — stay with the loss
                    wins.append(False)
        try:
            self.store.delete(order_key)
        except Exception:  # noqa: BLE001 — leased key ages out
            pass
        return wins

    def _own_losses_won(self, items: list, wins: list) -> list:
        """A member the claim reports lost may hold OUR nonce: the wire
        delivered a duplicated request's reply (the first copy applied,
        fence, proc key and all; the second lost to it).  The lost
        fences are read back once, and our nonce is a win.  The JAX
        package's agent takes the reply as it comes, and the fire is
        lost with its proc key left behind."""
        lost = [i for i, won in enumerate(wins) if not won]
        if not lost:
            return wins
        keys = [items[i][0] for i in lost]
        try:
            if hasattr(self.store, "get_many"):
                kvs = self.store.get_many(keys)
            else:
                kvs = [self.store.get(k) for k in keys]
        except Exception:  # noqa: BLE001 — stay with the losses
            return wins
        wins = list(wins)
        for i, kv in zip(lost, kvs):
            wins[i] = kv is not None and kv.value == items[i][1]
        return wins

    def _claim_bundle_rpc(self, order_key: str, items: list):
        """One LOGICAL claim_bundle round trip.  Concurrent callers
        (pool workers draining a backlog of due bundles) group-commit:
        whatever piles up during the in-flight RPC settles in one
        ``claim_bundle_many`` call.  A lone bundle uses the plain
        ``claim_bundle`` op — equally one RPC, and single-bundle error
        behavior (the degraded ladder's contract) stays byte-identical.
        Wire errors propagate to the caller's ladder."""
        if not (self._bundle_many_supported
                and hasattr(self.store, "claim_bundle_many")):
            return self._claim_bundle_direct(order_key, items)
        done = threading.Event()
        slot = [None, None]             # [wins, exception]
        with self._bundle_cv:
            self._bundle_pending.append((order_key, items, done, slot))
            if self._bundle_thread is None or \
                    not self._bundle_thread.is_alive():
                self._bundle_thread = threading.Thread(
                    target=self._bundle_flush_loop, daemon=True,
                    name=f"bundles-{self.id}")
                self._bundle_thread.start()
            self._bundle_cv.notify()
        if not done.wait(timeout=30):
            # indeterminate: the caller's read-back recovery decides
            raise RuntimeError("bundle claim batch timed out")
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

    def _claim_bundle_direct(self, order_key: str, items: list):
        fence_lease = self._fence_lease()
        with self._procs_mu:
            proc_lease = self._proc_lease or 0
        try:
            return self.store.claim_bundle(order_key, items,
                                           fence_lease, proc_lease)
        except KeyError:
            fence_lease = self._rotate_fence_lease()
            with self._procs_mu:
                self._repair_proc_lease_locked()
                proc_lease = self._proc_lease or 0
            return self.store.claim_bundle(order_key, items,
                                           fence_lease, proc_lease)

    def _bundle_flush_loop(self):
        """Group-commit loop for bundle claims: every pending bundle
        settles in one claim_bundle_many RPC; bundles arriving during
        the in-flight RPC form the next batch."""
        while True:
            with self._bundle_cv:
                while not self._bundle_pending:
                    if self._stop.is_set():
                        return
                    self._bundle_cv.wait(timeout=0.5)
                batch, self._bundle_pending = self._bundle_pending, []
            if len(batch) == 1:
                order_key, items, done, slot = batch[0]
                try:
                    slot[0] = self._claim_bundle_direct(order_key, items)
                except Exception as e:  # noqa: BLE001 — caller's ladder
                    slot[1] = e
                done.set()
                continue
            try:
                results = self._bundle_many_rpc(
                    [(ok, its) for ok, its, _d, _s in batch])
                for res, (_ok, _its, done, slot) in zip(results, batch):
                    slot[0] = res
                    done.set()
            except Exception as e:  # noqa: BLE001
                if "unknown op" in str(e):
                    # server predates claim_bundle_many: settle this
                    # batch one RPC each and stop batching
                    log.warnf("store lacks claim_bundle_many; settling "
                              "bundles one RPC each")
                    self._bundle_many_supported = False
                    for order_key, its, done, slot in batch:
                        try:
                            slot[0] = self._claim_bundle_direct(order_key,
                                                                its)
                        except Exception as e2:  # noqa: BLE001
                            slot[1] = e2
                        done.set()
                else:
                    for _ok, _its, done, slot in batch:
                        slot[1] = e     # each caller's ladder recovers
                        done.set()

    def _bundle_many_rpc(self, bundles: list):
        fence_lease = self._fence_lease()
        with self._procs_mu:
            proc_lease = self._proc_lease or 0
        try:
            return self.store.claim_bundle_many(bundles, fence_lease,
                                                proc_lease)
        except KeyError:
            # a shared lease expired under us (suspended VM, clock
            # jump): rotate/repair both, retry once
            fence_lease = self._rotate_fence_lease()
            with self._procs_mu:
                self._repair_proc_lease_locked()
                proc_lease = self._proc_lease or 0
            return self.store.claim_bundle_many(bundles, fence_lease,
                                                proc_lease)

    def _fence_item(self, item) -> bool:
        """Legacy per-item settle for a bundle member: fence
        put_if_absent under the shared rotating lease, plus the winner's
        proc put — the degraded path when claim_bundle is unavailable."""
        fence_key, nonce, proc_key, proc_val = item
        try:
            won = self.store.put_if_absent(fence_key, nonce,
                                           lease=self._fence_lease())
        except KeyError:
            won = self.store.put_if_absent(fence_key, nonce,
                                           lease=self._rotate_fence_lease())
        if won and proc_key:
            with self._procs_mu:
                try:
                    self.store.put(proc_key, proc_val,
                                   lease=self._proc_lease or 0)
                except KeyError:
                    self._repair_proc_lease_locked()
                    self.store.put(proc_key, proc_val,
                                   lease=self._proc_lease or 0)
        return won

    def _prefetch_jobs(self, keys):
        """Batch-fill the job cache for a drained burst of order keys:
        cold jobs cost ONE get_many round trip per drain, not one
        synchronous get (plus a reply-wait thread handoff) per order —
        a measured top cost of the dispatch plane."""
        pairs = []
        for rest in keys:
            parts = rest.split("/")
            if len(parts) == 3:
                pairs.append((parts[1], parts[2]))
        self._prefetch_pairs(pairs)

    def _prefetch_pairs(self, pairs):
        """Batch-fill the job cache for explicit (group, job_id) pairs —
        the bundle consumer's one-get_many-per-bundle fill."""
        want = []
        seen = set()
        for gk in pairs:
            if gk not in seen and gk not in self._job_cache:
                seen.add(gk)
                want.append(gk)
        if not want or not hasattr(self.store, "get_many"):
            return
        try:
            kvs = self.store.get_many(
                [self.ks.job_key(g, j) for g, j in want])
        except Exception as e:  # noqa: BLE001 — per-order gets still work
            log.warnf("job prefetch failed (%s); falling back to "
                      "per-order fetches", e)
            return
        if len(self._job_cache) + len(want) > self._job_cache_cap:
            self._job_cache.clear()
        for (group, job_id), kv in zip(want, kvs):
            if kv is None:
                continue
            try:
                job = Job.from_json(kv.value)
            except (json.JSONDecodeError, TypeError):
                continue
            job.group, job.id = group, job_id
            self._job_cache[(group, job_id)] = job

    def _poll_dispatch(self) -> int:
        n = 0
        evs = [ev for ev in self._w_dispatch.drain() if ev.type != DELETE]
        if len(evs) > 1:
            off = len(self.ks.dispatch) + len(self.id) + 1
            self._prefetch_jobs(ev.kv.key[off:] for ev in evs)
        for ev in evs:
            n += self._handle_dispatch_kv(ev.kv.key, ev.kv.value,
                                          order_key=ev.kv.key)
        return n

    def _handle_broadcast_kv(self, key: str) -> int:
        rest = key[len(self.ks.dispatch_all):]
        parts = rest.split("/")
        if len(parts) != 3:
            return 0
        epoch_s, group, job_id = int(parts[0]), parts[1], parts[2]
        # Common runs have no store fence; this in-memory (job, second)
        # dedup keeps the resync re-list (and any stream re-delivery)
        # from double-running a broadcast this agent already took
        if (job_id, epoch_s) in self._bseen:
            return 0
        job = self._get_job(group, job_id)
        if job is None or job.pause or not self.is_run_on(job):
            return 0
        self._bseen[(job_id, epoch_s)] = self.clock()
        if len(self._bseen) > 8192:     # prune half-hour-old entries
            cut = self.clock() - 1800
            for k2 in [k2 for k2, ts in self._bseen.items() if ts < cut]:
                del self._bseen[k2]
        tr = (None, self.clock(), None) if self.trace_shift >= 0 else None
        self._spawn(job, epoch_s, fenced=True, tr=tr)
        return 1

    def _poll_broadcast(self) -> int:
        """Common-kind fan-out: one order per (second, job) for the whole
        fleet; this node runs it iff it is eligible (local IsRunOn).  The
        key is shared — never deleted by a consumer; its lease GCs it."""
        n = 0
        evs = [ev for ev in self._w_broadcast.drain() if ev.type != DELETE]
        if len(evs) > 1:
            off = len(self.ks.dispatch_all)
            self._prefetch_jobs(ev.kv.key[off:] for ev in evs)
        for ev in evs:
            n += self._handle_broadcast_kv(ev.kv.key)
        return n

    def _poll_once(self) -> int:
        n = 0
        for ev in self._w_once.drain():
            if ev.type == DELETE:
                continue
            if ev.kv.value not in ("", self.id):
                continue
            rest = ev.kv.key[len(self.ks.once):]
            if "/" not in rest:
                continue
            group, job_id = rest.split("/", 1)
            job = self._get_job(group, job_id)
            if job is None:
                continue
            # run-now bypasses locks and the parallels gate
            # (reference job.go:472-482) — and the exec pool: it must
            # start immediately even with a full order backlog
            self._spawn(job, int(self.clock()), fenced=False,
                        use_gate=False, immediate=True)
            n += 1
        return n

    _spawn_seq = 0

    def _ensure_pool(self) -> _ExecPool:
        if self._pool is None:
            self._pool = _ExecPool(self.max_inflight, f"exec-{self.id}")
        return self._pool

    def _spawn(self, job: Job, epoch_s: int, fenced: bool,
               use_gate: bool = True, order_key: Optional[str] = None,
               immediate: bool = False, pre: Optional[tuple] = None,
               tr: Optional[tuple] = None):
        NodeAgent._spawn_seq += 1
        name = f"exec-{job.id}-{epoch_s}-{NodeAgent._spawn_seq}"

        def run():
            try:
                self._execute(job, epoch_s, fenced, use_gate, order_key,
                              pre=pre, tr=tr)
            except Exception as e:  # noqa: BLE001 — log, don't die silent
                log.errorf("execution %s failed: %s", name, e)
            finally:
                # self-prune: a long-running agent must not accumulate one
                # finished task record per execution
                self.running.pop(name, None)

        task = _ExecTask(run)
        self.running[name] = task
        if immediate:
            # run-now bypasses the pool entirely: a backlog of queued or
            # long-running work must not delay an operator's trigger
            # (reference go job.RunWithRecovery(), node/node.go:423-442)
            t = threading.Thread(target=task.run, daemon=True, name=name)
            t.start()
            return
        self._stage_task(name, task, epoch_s)

    def _stage_task(self, name: str, task: _ExecTask, epoch_s: int):
        # future-epoch orders (the scheduler publishes whole windows
        # ahead of wall-clock) must not occupy pool workers sleeping in
        # _wait_until — they'd starve due work behind them; stage until
        # due.  One monitor thread scans the backlog with bounded naps
        # (injected virtual clocks still make progress, and K staged
        # orders cost zero extra threads); the stage lock makes stop()
        # vs due-enqueue atomic, so a stopping agent can never enqueue
        # into (or resurrect) a shut-down pool.
        with self._stage_mu:
            if self._stop.is_set():
                self.running.pop(name, None)
                task.finished.set()
                return
            if epoch_s - self.clock() <= 0.02:
                self._ensure_pool().enqueue(task)
                return
            self._staged[name] = (task, epoch_s)
            if self._stage_monitor is None or \
                    not self._stage_monitor.is_alive():
                self._stage_monitor = threading.Thread(
                    target=self._stage_loop, daemon=True,
                    name=f"stage-{self.id}")
                self._stage_monitor.start()

    def _stage_loop(self):
        while True:
            with self._stage_mu:
                if self._stop.is_set() or not self._staged:
                    # clear the handle UNDER the lock before exiting: a
                    # concurrent _stage serialized behind us must see
                    # "no monitor" and spawn a fresh one, not skip on an
                    # is_alive() thread that has already decided to die
                    self._stage_monitor = None
                    return
                now = self.clock()
                for name, (task, epoch_s) in list(self._staged.items()):
                    if epoch_s - now <= 0.02:
                        self._staged.pop(name)
                        self._ensure_pool().enqueue(task)
            time.sleep(0.1)


    def join_running(self, timeout: float = 10.0):
        deadline = time.monotonic() + timeout
        while True:
            tasks = list(self.running.items())
            if not tasks:
                break
            for name, t in tasks:
                t.finished.wait(timeout=max(0.0,
                                            deadline - time.monotonic()))
                if t.done():
                    self.running.pop(name, None)
            if time.monotonic() >= deadline:
                break
            # re-snapshot: a bundle task that just finished fans its
            # member executions out to the pool — the barrier must cover
            # work spawned while it waited, not just the first snapshot
        # joined executions' records must be visible in the sink — and
        # their consumed order keys gone from the store — once this
        # returns (callers treat join as the completion barrier); force
        # past any retry backoff — the sink may have healed
        self._flush_acks()
        self._flush_records(force=True)

    # ---- background loop -------------------------------------------------

    def start(self):
        self.register()

        def keepalive_loop():
            # a transient store failure must not permanently kill the node
            # (the lease would expire and the fleet would mark it dead) —
            # but losing the identity to ANOTHER live agent is fatal: keep
            # running and this process ghost-executes orders meant for the
            # replacement
            while not self._stop.wait(max(1.0, self.ttl / 3)):
                try:
                    self.keepalive_once()
                except DuplicateNode as e:
                    log.errorf("node identity lost to a live replacement; "
                               "shutting down: %s", e)
                    self._stop.set()
                    if self.on_fatal is not None:
                        self.on_fatal(e)
                    return
                except Exception as e:  # noqa: BLE001
                    log.warnf("keepalive failed (retrying): %s", e)

        def poll_loop():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001
                    log.warnf("poll failed (retrying): %s", e)
                    time.sleep(0.5)
                time.sleep(0.05)

        for fn in (keepalive_loop, poll_loop):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"agent-{fn.__name__}")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        # drop staged future orders FIRST: their leases/fences belong to
        # a node that is going away, and join_running must not wait on
        # work that was never due.  Under the stage lock, so the monitor
        # cannot concurrently enqueue one of them.
        with self._stage_mu:
            for name, (task, _epoch) in list(self._staged.items()):
                self._staged.pop(name, None)
                self.running.pop(name, None)
                task.finished.set()
        with self._claim_cv:       # wake the claim flusher so it drains
            self._claim_cv.notify_all()   # pending claims, then exits
        with self._bundle_cv:      # likewise the bundle-claim flusher
            self._bundle_cv.notify_all()
        for t in self._threads:
            t.join(timeout=3)
        self._threads.clear()
        self.join_running()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        # final synchronous drains; anything the store/sink won't take
        # now is lost with the process — order keys age out by lease,
        # records are logged at error level, not "retry"
        self._flush_acks()
        self._flush_records(final=True)
        self.unregister()


def _local_id() -> str:
    """Node identity: first non-loopback IPv4, like the reference
    (utils/local_ip.go:10-31); falls back to hostname."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return socket.gethostname()
