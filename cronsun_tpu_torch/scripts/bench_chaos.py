"""Chaos drills of the PyTorch port: scripted fault scenarios gated by global
invariants, the counterpart of ``scripts/bench_chaos.py`` on the port's
``SchedulerService`` (its planner on the card, or on the CPU when asked).

Every drill assembles a REAL fleet in-process — TCP store server(s)
and a TCP result store behind :class:`FaultProxy` instances, wire
clients, agents, scheduler(s) — injects a named fault scenario from a
seeded, deterministic schedule, lets the system settle, and
machine-checks the global invariants (cronsun_tpu_torch/chaos/invariants.py):
exactly-once, zero acked-record loss, clean fixpoint, bounded
recovery.  Time is compressed the way tests/test_integration.py does
it: the scheduler is stepped over synthetic past epochs, so a
30-second scenario runs in a few wall seconds while leases, backoff
ladders and fault windows ride real time.

    python -m cronsun_tpu_torch.scripts.bench_chaos --drill smoke --seed 7
    python -m cronsun_tpu_torch.scripts.bench_chaos --drill all \
        --json chaos.json [--device cpu]

Drills:

  smoke            seeded delay/dup/reorder on the store wire +
                   reply-lost injections on both clients; tier-1 gate
  leader_kill9     kill -9 the scheduler leader during a herd second;
                   standby takes over; zero duplicate/lost fires,
                   bounded recovery
  shard_partition  one store shard of two severed mid-drain, then
                   healed: publish hole + rewind + redelivery converge
  logd_flap        the result store flaps (sever bursts) across the
                   rec-flush retry budget: pinned idem tokens keep the
                   sink exactly equal to the acked count
  brownout         one store shard slow (not dead) under read load:
                   without breakers the healthy shard's reads stall
                   behind it;
                   with the breaker they are bounded (<= 2x baseline)
  ckpt_race        checkpoint save racing a store partition: saves
                   either land or fail LOUDLY, invariants hold
  agent_kill       kill -9 an agent mid-execution: fence consumed, no
                   double fire, fsck NAMES the fence-without-record
  replica_leader_kill  kill -9 the store REPLICA LEADER (repl/) under
                   live dispatch + a quorum-acked probe writer: a
                   follower promotes within a bounded window, clients
                   rotate, exactly-once holds, and ZERO acked records
                   are lost; run with replicated=False the same drill
                   FAILS (acked probes vanish with the leader), which
                   proves it measures the replication plane

The fault schedule is deterministic under --seed: the smoke drill
asserts byte-identical schedules across two constructions, and every
hook decision is a pure hash (chaos/hooks.det01).

Drills, flags and JSON keys are the JAX script's, plus ``--device`` (every
drill's schedulers plan on it; default the card).  Before the first fleet,
:func:`warm_device` builds the kernels and initialises the card, so no
drill's first plan pays for either while its leases ride real time.

Where the harness differs from the JAX script's, it drives paths the
JAX script left to timing, each of which failed its drills now and then
under load:

- :meth:`Fleet.drive` goes on from a publish hole that shows only once the
  cursor has passed ``end`` (the scheduler re-plans it on a later step);
- the smoke drills arm their store reply-lost faults on every claim op
  (``CLAIM_OPS``: the bundle group commit too);
- :meth:`Fleet.close` stops the threads of killed schedulers and agents,
  which would otherwise hold a scheduler's planner tensors on the card
  and go on retrying a killed agent's flushes through later runs.

The port's agent (:class:`NodeAgent`) differs from the JAX one in one
way the drills see: a bundle whose claim could not settle while the
store was faulted is re-read and re-handled by the agent itself
(``redeliver_after``), where the JAX agent leaves it leased until a
resync.  :func:`run_drills` reports, in each drill's ``info``, how many
orders its agents re-handled that way as ``agent_redeliveries``.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

os.environ.setdefault("CRONSUN_CHAOS", "1")     # drills inject faults

from ..chaos.faultproxy import FaultProxy, FaultSchedule   # noqa: E402
from ..chaos.hooks import hooks                            # noqa: E402
from ..chaos import invariants                             # noqa: E402
from ..core import Job, JobRule, Keyspace                  # noqa: E402
from ..core.models import KIND_INTERVAL                    # noqa: E402
from ..device import resolve_device                        # noqa: E402
from ..logsink.serve import LogSinkServer, RemoteJobLogStore  # noqa: E402
from ..node.agent import NodeAgent                         # noqa: E402
from ..node.executor import ExecResult                     # noqa: E402
from ..store.memstore import MemStore                      # noqa: E402
from ..store.remote import RemoteStore, StoreServer        # noqa: E402
from ..store.sharded import ShardedStore                   # noqa: E402

KS = Keyspace()
T0 = 1_760_000_000          # synthetic drill epoch (past wall-clock)
# the store ops of the agents' claim ladders: per-order fences
# (claim_many) and bundles, one (claim_bundle) or several due together
# in one group commit (claim_bundle_many, whose share of the claims
# grows with the agents' poll lag)
CLAIM_OPS = ("claim_many", "claim_bundle", "claim_bundle_many")


def warm_device(device=None):
    """Build the kernels and initialise ``device`` (a CUDA context, one
    allocation): launches nothing, and returns the resolved device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch
        from ..ops import _build
        _build.build()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return dev


def pctl(xs, q):
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class RecordingExecutor:
    """Instant-exec executor that records every run into a shared
    fleet ledger as (job_id, scheduled_second) — the exactly-once
    evidence — and can BLOCK designated jobs (the kill -9 mid-execution
    drill needs a run provably in flight)."""

    def __init__(self, ledger, mu, block_jobs=(), clock=time.time):
        self.ledger = ledger
        self.mu = mu
        self.block_jobs = set(block_jobs)
        self.blocked = threading.Event()     # a blocked run has started
        self.release = threading.Event()     # let blocked runs finish
        self.clock = clock

    def run_job(self, job_id="", command="", user="", timeout=0, retry=0,
                interval=0, parallels=0, env=None, sleep=time.sleep):
        sched_ts = int((env or {}).get("CRONSUN_SCHEDULED_TS", "0") or 0)
        with self.mu:
            self.ledger.append((job_id, sched_ts))
        if job_id in self.block_jobs:
            self.blocked.set()
            self.release.wait(timeout=30)
        now = self.clock()
        return ExecResult(True, "ok", now, now, exit_code=0)


class Fleet:
    """One drill's world: proxied store shard(s) + proxied logd + N
    in-process agents + one or more schedulers, driven over synthetic
    seconds."""

    # orders the agents of every closed fleet re-read after a failed claim
    agent_redeliveries = 0

    def __init__(self, seed=0, n_jobs=10, n_agents=2, store_shards=1,
                 n_scheds=1, lease_ttl=2.0, dispatch_ttl=300.0,
                 shard_deadline=0.0, window_s=2, agent_ttl=10.0,
                 proc_ttl=600.0, block_jobs=(), checkpoint_dir=None,
                 client_timeout=8.0, backend="py", trace_shift=-1,
                 sched_shard_deadline=None, publish_lanes=0,
                 partitions=1, repl=None, repl_members=3,
                 promote_after=1.5, device=None):
        self.seed = seed
        self.n_jobs = n_jobs
        self.partitions = partitions
        self.client_timeout = client_timeout
        self.shard_deadline = shard_deadline
        # the scheduler's client can arm a DIFFERENT deadline than the
        # agents': a publisher behind an open breaker fail-fasts its
        # window writes and the plan cursor rewinds forever, so the
        # brownout-dispatch drill arms agents only (publishes wait out
        # the slow shard; its orders are late, not lost)
        self.sched_shard_deadline = shard_deadline \
            if sched_shard_deadline is None else sched_shard_deadline
        self.backend = backend
        self.ks = KS
        self.ledger = []
        self.ledger_mu = threading.Lock()
        self.step_errors = 0        # faulted-window step/poll failures
        # publishers whose flush timed out (quiesce_publishers), and the
        # last drive()'s clock: when its cursor passed ``end`` and the
        # seconds its trailing quiesce and re-plan took after that
        self.flush_timeouts = []
        self.end_passed_at = None
        self.quiesce_s = 0.0
        self.agent_ttl = agent_ttl
        self._last_ka = 0.0         # drive()'s keepalive cadence anchor
        self._clients = []

        # store shards, each behind its own proxy (schedule seeds are
        # derived so a multi-shard drill is still one-seed determined).
        # ``backend="native"`` runs the C++ stored/logd servers instead
        # of the in-process Python ones — the FaultProxy is protocol-
        # level, so every drill works unchanged against either
        # (native_available() gates it).
        self.repl = repl                # None | "async" | "quorum"
        self.repl_mgrs = []
        self.repl_group = []
        if repl:
            # REPLICATED store plane (repl/): one shard served by a
            # leader + (repl_members - 1) followers shipping the WAL
            # record stream; clients are ReplicaGroupStores that rotate
            # on leader loss.  The drill's fault is the leader kill
            # itself, so no FaultProxy fronts the group.
            if backend != "py" or store_shards != 1:
                raise RuntimeError("repl drills need the Python backend "
                                   "and a single store shard")
            from ..repl import ReplManager
            self.store_srvs = [StoreServer(MemStore())
                               for _ in range(repl_members)]
            self.repl_group = [f"127.0.0.1:{s.port}"
                               for s in self.store_srvs]
            for i, srv in enumerate(self.store_srvs):
                m = ReplManager(srv.store, self.repl_group[i],
                                self.repl_group, ack_mode=repl,
                                promote_after=promote_after)
                srv.attach_repl(m)
                srv.start()
                self.repl_mgrs.append(m)
            for m in self.repl_mgrs:
                m.start()
            self.store_scheds = []
            self.store_proxies = []
        elif backend == "native":
            from ..store.native import NativeStoreServer
            from ..logsink.native import \
                find_binary as _logd_bin
            from ..store.native import \
                find_binary as _stored_bin
            sb, lb = _stored_bin(), _logd_bin()
            if not sb or not lb:
                raise RuntimeError(
                    "native backends requested but cronsun-stored/"
                    "cronsun-logd binaries are unavailable")
            self.store_srvs = [NativeStoreServer(binary=sb)
                               for _ in range(store_shards)]
        else:
            self.store_srvs = [StoreServer(MemStore()).start()
                               for _ in range(store_shards)]
        if not repl:
            self.store_scheds = [FaultSchedule(seed * 1000 + i)
                                 for i in range(store_shards)]
            self.store_proxies = [
                FaultProxy(("127.0.0.1", srv.port), sch,
                           name=f"store-proxy-{i}").start()
                for i, (srv, sch) in enumerate(zip(self.store_srvs,
                                                   self.store_scheds))]
        # result store behind a proxy
        if backend == "native":
            from ..logsink.native import NativeLogSinkServer
            self.logd = NativeLogSinkServer()
        else:
            self.logd = LogSinkServer().start()
        self.logd_sched = FaultSchedule(seed * 1000 + 99)
        self.logd_proxy = FaultProxy(("127.0.0.1", self.logd.port),
                                     self.logd_sched,
                                     name="logd-proxy").start()

        # agents (each its own wire clients, like separate processes)
        self.agents = []
        self.dead_agents = []
        for i in range(n_agents):
            ex = RecordingExecutor(self.ledger, self.ledger_mu,
                                   block_jobs=block_jobs)
            a = NodeAgent(self.store_client(), self.sink_client(),
                          node_id=f"node-{i}", ttl=agent_ttl,
                          proc_ttl=proc_ttl, lock_ttl=120.0,
                          proc_req=0.0, executor=ex,
                          trace_shift=trace_shift)
            a.register()
            self.agents.append(a)

        # scheduler(s): leader + warm standbys
        from ..sched import SchedulerService
        cap = 256
        while cap < n_jobs + 8:
            cap *= 2
        self.scheds = []
        self.dead_scheds = []
        # partitioned fleets run n_scheds instances (leader + warm
        # standbys) PER PARTITION; partitions=1 keeps today's shape
        for part in range(partitions):
            for i in range(n_scheds):
                nid = (f"sched-{i}" if partitions == 1
                       else f"sched-p{part}-{i}")
                self.scheds.append(SchedulerService(
                    self.store_client(deadline=self.sched_shard_deadline),
                    job_capacity=cap, node_capacity=64,
                    window_s=window_s, lease_ttl=lease_ttl,
                    dispatch_ttl=dispatch_ttl, node_id=nid,
                    checkpoint_dir=checkpoint_dir,
                    trace_shift=trace_shift,
                    publish_lanes=publish_lanes,
                    partitions=partitions, partition=part,
                    device=device))

        # auditor connections (never faulted mid-drill: audits run
        # after heal)
        self.audit_store = self.store_client()
        self.audit_sink = self.sink_client()

    # -- client factories --------------------------------------------------

    def store_client(self, deadline=None):
        if self.repl:
            from ..repl import ReplicaGroupStore
            c = ReplicaGroupStore(list(self.repl_group),
                                  timeout=self.client_timeout)
            self._clients.append(c)
            return c
        conns = [RemoteStore("127.0.0.1", p.port,
                             timeout=self.client_timeout)
                 for p in self.store_proxies]
        if len(conns) == 1:
            c = conns[0]
        else:
            c = ShardedStore(conns, shard_deadline=self.shard_deadline
                             if deadline is None else deadline)
        self._clients.append(c)
        return c

    def sink_client(self):
        c = RemoteJobLogStore("127.0.0.1", self.logd_proxy.port,
                              timeout=self.client_timeout)
        self._clients.append(c)
        return c

    # -- workload ----------------------------------------------------------

    def put_jobs(self, prefix="cj", n=None, nids=None):
        n = self.n_jobs if n is None else n
        nids = nids or [a.id for a in self.agents]
        ids = []
        for i in range(n):
            job = Job(id=f"{prefix}{i:04d}", name=f"{prefix}{i}",
                      command="true", kind=KIND_INTERVAL,
                      rules=[JobRule(timer="* * * * * *", nids=nids)])
            job.check()
            self.audit_store.put(self.ks.job_key(job.group, job.id),
                                 job.to_json())
            ids.append(job.id)
        # the job watch is ASYNC: wait until every scheduler's mirror
        # holds every job before driving, or the first window races the
        # wire and "loses" fires that were simply not yet registered
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            for sc in self.live_scheds():
                sc.drain_watches()
            if all(sc.rows.rules_of("default", jid)
                   for sc in self.live_scheds() for jid in ids
                   if sc.owns_job(jid)):
                break
            time.sleep(0.02)
        return ids

    # -- drive/settle ------------------------------------------------------

    def keepalive_agents(self):
        """Run the agents' lease keepalives at the production cadence
        (``ttl / 3`` — agent.start()'s keepalive_loop).  Drills drive
        ``poll()`` by hand and never start that thread, so without this
        any drill whose WALL time outruns ``agent_ttl`` watches every
        node lease expire mid-drill: the node keys vanish, the
        scheduler marks the whole fleet dead and silently stops
        publishing (total dispatch starvation in the paced
        brownout_dispatch drill, the only drill long enough to hit
        it).  Exceptions are swallowed exactly like the production
        loop's: a faulted store must not kill liveness, and the
        composite keepalive already treats a degraded shard's leg as
        its own bounded loss."""
        now = time.monotonic()
        if now - self._last_ka < max(1.0, self.agent_ttl / 3):
            return
        self._last_ka = now
        for a in self.live_agents():
            try:
                a.keepalive_once()
            except Exception:  # noqa: BLE001 — faulted plane
                pass

    def live_scheds(self):
        return [s for s in self.scheds if s not in self.dead_scheds]

    def live_agents(self):
        return [a for a in self.agents if a not in self.dead_agents]

    def drive(self, t, end, on_second=None, stall_timeout=30.0):
        """Step schedulers over synthetic seconds [t, end); agents
        consume as orders land.  When no scheduler leads (failover in
        progress) real time passes until one wins.  Returns the final
        plan cursor (every second below it was planned).

        Past ``end`` the publishers are flushed first: a window still in
        flight may yet fail to land (a store severed under it), and its
        publish hole is re-planned only by a later step.  While one is
        outstanding the drive goes on from the hole, where the
        scheduler's next step rewinds its cursor (the production loop's
        path: late, never lost).  ``end_passed_at`` is the moment the
        cursor first passed ``end`` (where the JAX harness's drive
        returns) and ``quiesce_s`` the seconds from there to the
        return."""
        stall_t0 = time.monotonic()
        redrive_until = None
        self.end_passed_at, self.quiesce_s = None, 0.0
        while True:
            if t >= end:
                if self.end_passed_at is None:
                    self.end_passed_at = time.monotonic()
                self.quiesce_publishers()
                hole = self.publish_hole()
                if hole is None:
                    self.quiesce_s = time.monotonic() - self.end_passed_at
                    return t
                if redrive_until is None:
                    redrive_until = time.monotonic() + stall_timeout
                elif time.monotonic() > redrive_until:
                    raise RuntimeError(
                        f"publish hole at epoch {hole} still open after "
                        f"{stall_timeout:.0f}s of re-planning")
                t = hole
            # a partitioned store makes steps/polls THROW — the
            # production loops catch and keep going (sched/service.py
            # start(); the agents' poll loop likewise), so the drill
            # drives the same way
            for sc in self.live_scheds():
                try:
                    sc.step(now=t)
                except Exception:  # noqa: BLE001 — faulted plane
                    self.step_errors += 1
            self.keepalive_agents()
            for a in self.live_agents():
                try:
                    a.poll()
                except Exception:  # noqa: BLE001 — faulted plane
                    self.step_errors += 1
            if on_second is not None:
                # BEFORE the join: kill-style callbacks need to act
                # while executions are provably in flight
                on_second(t)
            for a in self.live_agents():
                try:
                    a.join_running(timeout=2.0)   # settle() fully joins
                except Exception:  # noqa: BLE001 — faulted plane
                    self.step_errors += 1
            # per-PARTITION cursors: the drive only advances once every
            # partition has a leader past t (a killed partition's slice
            # must be re-planned by its standby, not outrun by the
            # healthy partitions); unpartitioned fleets reduce to the
            # max over schedulers
            by_part = {}
            for sc in self.live_scheds():
                if sc._next_epoch is not None:
                    p = getattr(sc, "partition", 0)
                    by_part[p] = max(by_part.get(p, 0), sc._next_epoch)
            nt = min(by_part.values()) \
                if len(by_part) >= self.partitions else None
            if nt is None or nt <= t:
                if time.monotonic() - stall_t0 > stall_timeout:
                    raise RuntimeError(
                        f"drive stalled at epoch {t} (no leader for "
                        f"{stall_timeout:.0f}s)")
                time.sleep(0.05)     # waiting out a lease (failover)
                continue
            stall_t0 = time.monotonic()
            t = nt

    def publish_hole(self):
        """The lowest publish hole a live scheduler holds (a window whose
        orders were dropped after retries), or None."""
        holes = [sc.publisher.take_failed_epoch()
                 for sc in self.live_scheds()]
        holes = [h for h in holes if h is not None]
        return min(holes) if holes else None

    def quiesce_publishers(self, timeout=30.0):
        """Flush every live scheduler's async build/publish pipeline so
        submitted windows LAND (and the HWM persists).  Kill drills run
        this before the kill: a real kill -9 almost always falls
        between landed windows, and the coverage gate is about
        takeover correctness, not about windows that provably never
        reached the store (those are the bounded failover gap).

        Returns the publishers whose flush timed out, one dict each
        (also kept in ``flush_timeouts``): the scheduler, the ``stage``
        that had not landed (``build``: a window still in the pipelined
        step's builder; ``windows``: windows in flight; ``hwm``: the
        high-water mark not yet written), the publisher's counts, and
        where each of its threads stood (``stacks``)."""
        out = []
        for sc in self.live_scheds():
            t_end = time.monotonic() + timeout
            try:
                builder = getattr(sc, "_builder", None)
                stage = None
                if builder is not None and not builder.flush(timeout):
                    stage = "build"   # pipelined step: gather/build
                pub = sc.publisher
                if stage is None and not pub.flush(
                        timeout=max(0.0, t_end - time.monotonic())):
                    stage = "windows" if pub.inflight else "hwm"
            except Exception:  # noqa: BLE001 — a dead/partitioned
                continue       # publisher's windows are the drill's point
            if stage is not None:
                out.append({"sched": sc.node_id, "stage": stage,
                            "timeout_s": timeout,
                            "inflight": pub.inflight,
                            "hwm_done": pub._hwm_done,
                            "hwm_want": pub._hwm_want,
                            "stacks": _publisher_stacks(pub)})
        self.flush_timeouts += out
        return out

    def settle(self, timeout=30.0):
        """Let the fleet converge to a fixpoint: the async publisher
        lands its queued windows, agents drain every published order,
        executions finish, acks and records flush."""
        self.quiesce_publishers(timeout)
        deadline = time.monotonic() + timeout
        stable = 0
        while time.monotonic() < deadline:
            self.keepalive_agents()
            for a in self.live_agents():
                try:
                    a.poll()
                    a.join_running()
                except Exception:  # noqa: BLE001 — still healing
                    pass
            try:
                left = self.audit_store.count_prefix(self.ks.dispatch)
                procs = self.audit_store.count_prefix(self.ks.proc)
            except Exception:  # noqa: BLE001 — still healing
                time.sleep(0.2)
                continue
            if left == 0 and procs == 0:
                # two consecutive clean reads: one clean read can race
                # a publisher lane that has not flushed yet
                stable += 1
                if stable >= 2:
                    break
            else:
                stable = 0
            time.sleep(0.1)
        for a in self.live_agents():
            a._flush_acks()
            a._flush_records(force=True)
        # retry slot may still hold a batch (sink was down): give the
        # ladder a couple of beats to land it
        for _ in range(40):
            if all(a._rec_retry is None and not a._rec_buf
                   for a in self.live_agents()):
                break
            time.sleep(0.25)
            for a in self.live_agents():
                a._flush_records(force=True)

    # -- kill switches -----------------------------------------------------

    def kill_sched(self, sc):
        """kill -9 semantics: the process vanishes — EVERY socket dies
        (main client AND the publisher's lane connections, which would
        otherwise keep publishing queued windows from beyond the
        grave), leases live on server-side until TTL, nothing is
        flushed or revoked."""
        self.dead_scheds.append(sc)
        for conn in getattr(sc.publisher, "_lane_conns", []):
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — dying anyway
                pass
        sc.store.close()

    def _reap(self, sc):
        """Stop a killed scheduler's threads, which would otherwise hold
        it, and its planner's tensors on the card, for the rest of the
        process: a killed process's die with it.  Its sockets are already
        closed but for its anti-entropy listing client, which would go on
        reconnecting to the stopped store; nothing of this reaches the
        store."""
        for stop in (lambda: sc._builder.stop(timeout=1.0),
                     lambda: sc.publisher.stop(timeout=1.0),
                     lambda: sc._dispatch_pool.shutdown(wait=True),
                     lambda: sc._ae_store is not None and
                     sc._ae_store.close()):
            try:
                stop()
            except Exception:  # noqa: BLE001 — dead already
                pass

    @staticmethod
    def _reap_agent(a):
        """Stop a killed agent's threads (its flushers would otherwise
        retry against the closed sink for minutes): what ``stop()`` does,
        without its final flushes and deregistration, which a killed
        process never makes."""
        a._stop.set()
        with a._stage_mu:
            for name, (task, _epoch) in list(a._staged.items()):
                a._staged.pop(name, None)
                a.running.pop(name, None)
                task.finished.set()
        for cv in (a._claim_cv, a._bundle_cv):
            with cv:
                cv.notify_all()
        for t in a._threads + [a._rec_flusher, a._ack_thread,
                               a._claim_thread, a._bundle_thread,
                               a._pdelay_thread, a._stage_monitor]:
            if t is not None:
                t.join(timeout=3)
        if a._pool is not None:
            a._pool.shutdown()
            a._pool = None

    def kill_store_leader(self):
        """kill -9 the replica-group LEADER: the server severs every
        established connection mid-flight (followers' pulls, clients'
        ops and watches) with no flush and no repl goodbye — exactly a
        dead process as the survivors see it."""
        for srv in self.store_srvs:
            if srv.repl is not None and srv.repl.role() == "leader":
                srv.kill()
                return srv
        raise RuntimeError("no replica leader alive to kill")

    def kill_agent(self, a):
        self.dead_agents.append(a)
        a.store.close()
        a.sink.close()

    # -- audits ------------------------------------------------------------

    def flushed_totals(self):
        flushed = dropped = 0
        for a in self.agents:       # dead agents' acked counts included
            flushed += a.stats["rec_flush_records_total"]
            dropped += a.stats["rec_dropped_total"]
        return flushed, dropped

    def audit(self, expect_jobs=None, planned_range=None,
              allow_unacked_extra=False, fixpoint=True):
        """The drill gate: exactly-once + acked records (+ optional
        full-coverage and fixpoint).  Returns (findings, info)."""
        with self.ledger_mu:
            ledger = list(self.ledger)
        findings = invariants.check_exactly_once(ledger)
        flushed, dropped = self.flushed_totals()
        # audits run after heal, but a just-expired fault window can
        # leave the auditor's connection mid-reconnect: retry briefly
        sink_total = None
        for _ in range(20):
            try:
                sink_total = self.audit_sink.stat_overall()["total"]
                break
            except Exception:  # noqa: BLE001 — healing
                time.sleep(0.25)
        if sink_total is None:
            sink_total = self.audit_sink.stat_overall()["total"]
        findings += invariants.check_acked_records(
            flushed, dropped, sink_total,
            allow_unacked_extra=allow_unacked_extra)
        if fixpoint:
            findings += invariants.check_fixpoint(self.audit_store,
                                                  self.ks)
        missing = 0
        if expect_jobs is not None and planned_range is not None:
            lo, hi = planned_range
            have = set(ledger)
            for jid in expect_jobs:
                for sec in range(lo, hi):
                    if (jid, sec) not in have:
                        missing += 1
                        findings.append(invariants.Finding(
                            "lost_fire", f"{jid}@{sec}",
                            "planned (job, second) never executed"))
        info = {"executions": len(ledger), "flushed": flushed,
                "dropped": dropped, "sink_total": sink_total,
                "lost_fires": missing}
        return findings, info

    # -- teardown ----------------------------------------------------------

    def close(self):
        Fleet.agent_redeliveries += sum(a.redelivered for a in self.agents)
        hooks.reset()
        for sch in self.store_scheds + [self.logd_sched]:
            sch.clear()
        for a in self.agents:
            if a not in self.dead_agents:
                try:
                    a.stop()
                except Exception:  # noqa: BLE001
                    pass
        for sc in self.scheds:
            if sc not in self.dead_scheds:
                try:
                    sc.stop()
                except Exception:  # noqa: BLE001
                    pass
        for sc in self.dead_scheds:
            self._reap(sc)
        for a in self.dead_agents:
            self._reap_agent(a)
        for c in self._clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        for p in self.store_proxies + [self.logd_proxy]:
            p.stop()
        for s in self.store_srvs:
            s.stop()
        self.logd.stop()


def _publisher_stacks(pub, depth=8):
    """The innermost ``depth`` frames of each of ``pub``'s threads (its
    publish loop, its high-water-mark writer and its lanes' workers), by
    thread name: where a flush that timed out was held."""
    import traceback
    threads = [pub._thread, pub._hwm_thread, pub._barrier_thread] + [
        t for pool in pub._pools for t in getattr(pool, "_threads", ())]
    frames = sys._current_frames()
    out = {}
    for t in threads:
        f = frames.get(getattr(t, "ident", None))
        if f is not None:
            out[t.name] = [
                f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno} {fs.name}"
                for fs in traceback.extract_stack(f)[-depth:]]
    return out


def _findings_json(findings):
    return [{"code": f.code, "key": f.key, "detail": f.detail}
            for f in findings]


# ---------------------------------------------------------------------------
# drills
# ---------------------------------------------------------------------------

def drill_smoke(seed=7, seconds=3, on_log=print, device=None):
    """Tier-1 gate: a short seeded drill — wire-level delay/dup/reorder
    on the store, deterministic reply-lost injections on both clients'
    hot retry ladders — ends with zero invariant violations, and the
    fault schedule is byte-identical across constructions."""
    # determinism: same seed -> byte-identical schedule, twice
    def mk():
        s = FaultSchedule(seed)
        s.add("delay", prob=0.2, ms=15)
        s.add("dup", prob=0.10)
        s.add("reorder", prob=0.05)
        return s
    deterministic = mk().schedule_bytes() == mk().schedule_bytes()

    fleet = Fleet(seed=seed, n_jobs=10, n_agents=2, device=device)
    try:
        # the proxy wire faults (benign but real: slow lines, duplicated
        # and swapped frames)
        for sch in fleet.store_scheds:
            sch.add("delay", prob=0.2, ms=15)
            sch.add("dup", prob=0.10)
            sch.add("reorder", prob=0.05)
        # deterministic reply-lost hits on the two ladders built for it
        # (CLAIM_OPS: the bundle ladder's group commit included)
        hooks.arm("store.rpc", "reply_lost", ops=CLAIM_OPS, count=2,
                  seed=seed)
        hooks.arm("logsink.rpc", "reply_lost", ops="create_job_logs",
                  count=2, seed=seed)
        jobs = fleet.put_jobs()
        end = fleet.drive(T0, T0 + seconds)
        fleet.settle()
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        info.update(injected=hooks.snapshot(),
                    proxy_stats=[p.stats for p in fleet.store_proxies],
                    schedule_deterministic=deterministic)
        if not deterministic:
            findings.append(invariants.Finding(
                "schedule_nondeterministic", "",
                "same seed produced different fault schedules"))
        on_log(f"smoke: {info['executions']} execs, "
               f"{len(findings)} finding(s), injected={info['injected']}")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def native_available() -> bool:
    """Both native server binaries present (built on demand)?"""
    try:
        from ..logsink.native import find_binary as lb
        from ..store.native import find_binary as sb
        return bool(sb()) and bool(lb())
    except Exception:  # noqa: BLE001 — no toolchain
        return False


def drill_native_smoke(seed=31, seconds=3, on_log=print, device=None):
    """The smoke drill's fault set against the NATIVE stored/logd
    backends: the FaultProxy is protocol-level, so the same wire-level
    delay/dup/reorder and client reply-lost injections exercise the C++
    servers' outbox/claim/WAL paths instead of the Python memstore's.
    Skips cleanly (no findings, info.skipped) when the binaries are
    unavailable — a missing toolchain is not an invariant violation."""
    if not native_available():
        on_log("native_smoke: SKIPPED (cronsun-stored/cronsun-logd "
               "unavailable)")
        return {"findings": [],
                "info": {"skipped": "native binaries unavailable"}}
    fleet = Fleet(seed=seed, n_jobs=10, n_agents=2, backend="native",
                  device=device)
    try:
        for sch in fleet.store_scheds:
            sch.add("delay", prob=0.2, ms=15)
            sch.add("dup", prob=0.10)
            sch.add("reorder", prob=0.05)
        hooks.arm("store.rpc", "reply_lost", ops=CLAIM_OPS, count=2,
                  seed=seed)
        hooks.arm("logsink.rpc", "reply_lost", ops="create_job_logs",
                  count=2, seed=seed)
        jobs = fleet.put_jobs()
        end = fleet.drive(T0, T0 + seconds)
        fleet.settle()
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        info.update(backend="native", injected=hooks.snapshot(),
                    proxy_stats=[p.stats for p in fleet.store_proxies])
        on_log(f"native_smoke: {info['executions']} execs, "
               f"{len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_leader_kill9(seed=11, on_log=print, device=None):
    """Kill -9 the leading scheduler DURING a herd second; the warm
    standby must take over within a bounded window and the union of
    both leaders' dispatches must cover every planned (job, second)
    exactly once."""
    fleet = Fleet(seed=seed, n_jobs=40, n_agents=2, n_scheds=2,
                  lease_ttl=2.0, device=device)
    try:
        jobs = fleet.put_jobs()
        mid = fleet.drive(T0, T0 + 3)
        # let in-flight windows LAND (the HWM persists) — a kill that
        # eats a never-landed window is the bounded failover gap, not
        # the lost-fire invariant this drill gates
        fleet.quiesce_publishers()
        leader = next(s for s in fleet.scheds if s.is_leader)
        on_log(f"killing leader {leader.node_id} at epoch {mid}")
        t_kill = time.monotonic()
        fleet.kill_sched(leader)
        end = fleet.drive(mid, mid + 4)
        standby = next(s for s in fleet.live_scheds() if s.is_leader)
        recovery_s = time.monotonic() - t_kill
        fleet.settle()
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end),
                                     allow_unacked_extra=False)
        # bounded recovery: lease expiry + a couple of steps
        bound = 2.0 * 3 + 10
        if recovery_s > bound:
            findings.append(invariants.Finding(
                "recovery_unbounded", "",
                f"takeover took {recovery_s:.1f}s (> {bound:.0f}s)"))
        info.update(recovery_s=round(recovery_s, 3),
                    takeover_by=standby.node_id,
                    resigns=sum(s.stats["lease_resigns_total"]
                                for s in fleet.scheds))
        on_log(f"leader_kill9: recovery {recovery_s:.2f}s, "
               f"{info['executions']} execs, {len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_partition_leader_kill(seed=41, on_log=print, device=None):
    """Partitioned scheduler plane: a 2-partition mini-fleet
    — two independent leaders (plus a warm standby each) ticking
    disjoint job-space slices against one store — loses ONE partition
    leader to kill -9 mid-window.  Its standby must take that
    partition over within a bounded window, the OTHER partition must
    keep dispatching throughout, and the fleet-wide audit must show
    every planned (job, second) executed exactly once — the
    exactly-once invariant holds ACROSS partitions, not per leader."""
    from ..sched.partition import job_partition
    fleet = Fleet(seed=seed, n_jobs=32, n_agents=2, n_scheds=2,
                  partitions=2, lease_ttl=2.0, device=device)
    try:
        jobs = fleet.put_jobs()
        split = {p: [j for j in jobs if job_partition(j, 2) == p]
                 for p in (0, 1)}
        if not split[0] or not split[1]:
            raise RuntimeError("seed produced an empty partition slice")
        # topology pinned once, by the first scheduler up
        pm = fleet.audit_store.get(KS.partmap)
        assert pm is not None and json.loads(pm.value)["p"] == 2
        mid = fleet.drive(T0, T0 + 3)
        fleet.quiesce_publishers()
        victim = next(s for s in fleet.live_scheds()
                      if s.is_leader and s.partition == 0)
        survivor = next(s for s in fleet.live_scheds()
                        if s.is_leader and s.partition == 1)
        on_log(f"killing partition-0 leader {victim.node_id} at "
               f"epoch {mid} (partition 1 led by {survivor.node_id})")
        t_kill = time.monotonic()
        fleet.kill_sched(victim)
        end = fleet.drive(mid, mid + 4, stall_timeout=60.0)
        takeover = next(s for s in fleet.live_scheds()
                        if s.is_leader and s.partition == 0)
        recovery_s = time.monotonic() - t_kill
        fleet.settle()
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end),
                                     allow_unacked_extra=False)
        bound = 2.0 * 3 + 10
        if recovery_s > bound:
            findings.append(invariants.Finding(
                "recovery_unbounded", "",
                f"partition takeover took {recovery_s:.1f}s "
                f"(> {bound:.0f}s)"))
        # the healthy partition must never have stalled: its leader
        # kept the SAME lease the whole drill
        if survivor not in fleet.live_scheds() or not survivor.is_leader:
            findings.append(invariants.Finding(
                "healthy_partition_stalled", "",
                "partition 1 lost leadership during partition 0's "
                "failover"))
        info.update(recovery_s=round(recovery_s, 3),
                    takeover_by=takeover.node_id,
                    slice_sizes={p: len(v) for p, v in split.items()},
                    resigns=sum(s.stats["lease_resigns_total"]
                                for s in fleet.scheds))
        on_log(f"partition_leader_kill: recovery {recovery_s:.2f}s, "
               f"{info['executions']} execs, {len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_shard_partition(seed=13, on_log=print, device=None):
    """One store shard of two severed for ~2.5 s mid-drain, then
    healed: publishes to it hole-and-rewind, claims ladder through
    indeterminacy, and after heal every planned fire lands exactly
    once with a clean fixpoint."""
    fleet = Fleet(seed=seed, n_jobs=24, n_agents=2, store_shards=2,
                  device=device)
    try:
        jobs = fleet.put_jobs()
        mid = fleet.drive(T0, T0 + 2)
        on_log(f"severing store shard 1 at epoch {mid}")
        el = fleet.store_proxies[1].elapsed()
        rid = fleet.store_scheds[1].add("sever", start=el, end=el + 2.5)
        t_fault = time.monotonic()
        end = fleet.drive(mid, mid + 5, stall_timeout=60.0)
        fleet.store_scheds[1].remove(rid)
        fleet.settle(timeout=45.0)
        recovery_s = time.monotonic() - t_fault
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        info.update(partition_s=2.5, recovery_s=round(recovery_s, 3),
                    proxy_stats=[p.stats for p in fleet.store_proxies])
        on_log(f"shard_partition: {info['executions']} execs, "
               f"{len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_logd_flap(seed=17, on_log=print, device=None):
    """The result store flaps — repeated short severs — while agents
    execute: the rec-flush ladder (pinned idem tokens, 0.5-10 s
    backoff) must deliver EXACTLY the acked set once the sink heals:
    no drop (the flap fits the 30-attempt budget), no duplicate (the
    tokens dedup every applied-but-unacked re-send)."""
    fleet = Fleet(seed=seed, n_jobs=16, n_agents=2, device=device)
    try:
        jobs = fleet.put_jobs()
        # three sever bursts over the drill: 0.6 s down, 0.6 s up
        el = fleet.logd_proxy.elapsed()
        last_end = 0.0
        for i in range(3):
            fleet.logd_sched.add("sever", start=el + 0.2 + 1.2 * i,
                                 end=el + 0.8 + 1.2 * i)
            last_end = el + 0.8 + 1.2 * i
        end = fleet.drive(T0, T0 + 5)
        # a fast drive can finish before the LAST burst has even
        # started: wait the whole scripted window out before settling
        while fleet.logd_proxy.elapsed() < last_end + 0.3:
            time.sleep(0.1)
        fleet.settle(timeout=45.0)
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        info.update(proxy_stats=fleet.logd_proxy.stats)
        on_log(f"logd_flap: {info['executions']} execs, sink "
               f"{info['sink_total']} == acked {info['flushed']}, "
               f"{len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_brownout(seed=19, reads=150, delay_ms=250.0,
                   deadline_s=0.08, on_log=print, device=None):
    """THE brownout measurement (acceptance gate): shard 1 of 2 answers
    slowly (alive, not dead) while a dashboard-style reader scans a
    fanned prefix.  Without a breaker every read stalls behind the
    slow shard; with per-shard breakers the healthy shard's reads are
    bounded — p99 <= 2x the healthy baseline — and the skipped shard
    is counted loudly in shard_degraded stats."""
    fleet = Fleet(seed=seed, n_jobs=12, n_agents=2, store_shards=2,
                  device=device)
    try:
        fleet.put_jobs()    # populate cmd/ across both shards

        def measure(client, n):
            # the dashboard read shape: partial-tolerant prefix scan
            # (web's _degraded_prefix); plain clients fall back to the
            # strict scan
            read = getattr(client, "get_prefix_degraded", None) or \
                client.get_prefix
            lat = []
            for _ in range(n):
                t0 = time.perf_counter()
                read(KS.cmd)
                lat.append((time.perf_counter() - t0) * 1e3)
            return lat

        plain = fleet.store_client()                    # breaker OFF
        hard = ShardedStore(
            [RemoteStore("127.0.0.1", p.port, timeout=8.0)
             for p in fleet.store_proxies],
            shard_deadline=deadline_s, breaker_cooldown=2.0)
        fleet._clients.append(hard)

        base = measure(plain, reads)
        baseline_p99 = pctl(base, 0.99)

        el = fleet.store_proxies[1].elapsed()
        rid = fleet.store_scheds[1].add("delay", start=el, ms=delay_ms,
                                        direction="s2c")
        degraded = measure(plain, max(20, reads // 4))  # breaker-off stall
        measure(hard, 8)    # steady-state: let the breaker trip (its
        # fail_threshold slow calls are the detection cost, paid once
        # per brownout episode, not per read)
        hardened = measure(hard, reads)                 # breaker path
        fleet.store_scheds[1].remove(rid)

        res = {
            "baseline_p99_ms": round(baseline_p99, 2),
            "degraded_p99_ms": round(pctl(degraded, 0.99), 2),
            "hardened_p99_ms": round(pctl(hardened, 0.99), 2),
            "hardened_p50_ms": round(pctl(hardened, 0.50), 2),
            "delay_ms": delay_ms,
            "breaker": hard.breaker_snapshot(),
        }
        findings = []
        # the stall must be real (else the drill measured nothing) ...
        if res["degraded_p99_ms"] < delay_ms * 0.8:
            findings.append(invariants.Finding(
                "brownout_not_induced", "",
                f"breaker-off p99 {res['degraded_p99_ms']}ms never stalled "
                f"behind the {delay_ms}ms shard"))
        # ... and the breaker must bound it (the acceptance criterion;
        # floor the bound for sub-ms baselines on fast hosts)
        bound = max(2.0 * baseline_p99, 20.0)
        if res["hardened_p99_ms"] > bound:
            findings.append(invariants.Finding(
                "brownout_unbounded", "",
                f"breaker-on p99 {res['hardened_p99_ms']}ms exceeds "
                f"{bound:.1f}ms (2x baseline)"))
        if not any(b["degraded_reads_total"] > 0
                   for b in res["breaker"]):
            findings.append(invariants.Finding(
                "degraded_not_counted", "",
                "no shard_degraded stat was recorded for the skipped "
                "shard"))
        on_log(f"brownout: baseline p99 {res['baseline_p99_ms']}ms, "
               f"stalled {res['degraded_p99_ms']}ms, hardened "
               f"{res['hardened_p99_ms']}ms, {len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": res}
    finally:
        fleet.close()


def drill_brownout_dispatch(seed=37, delay_ms=250.0, deadline_s=0.08,
                            on_log=print, device=None):
    """Brownout under LIVE DISPATCH LOAD (the read-plane drill above
    measures dashboards, this one measures FIRES): one of two store shards answers 250 ms late while the
    scheduler keeps publishing and both agents keep claiming.  With
    the per-shard breakers armed, fires whose keys avoid the degraded
    shard must stay within 2x the healthy baseline, exactly-once must
    hold fleet-wide, and the trace plane's waterfalls of the SLOW
    fires are the drill's diagnostic artifact (which stage ate the
    brownout)."""
    from .. import trace as _trace
    from ..store.sharded import shard_index
    # publish_lanes=0: the production default against a sharded store
    # is PER-SHARD publish lanes — orders
    # route to one lane per shard and every second's chunks stage onto
    # the lanes up front, so a browned-out shard's writes queue on ITS
    # lane only and never serialize ahead of the healthy shard's later
    # seconds (one shared lane would add ~2·window_s·delay)
    fleet = Fleet(seed=seed, n_jobs=24, n_agents=2, store_shards=2,
                  shard_deadline=deadline_s, sched_shard_deadline=0.0,
                  trace_shift=0, publish_lanes=0, device=device)
    try:
        # Pin each job to the agent whose SHARD its fence routes to:
        # node-X runs only jobs whose whole key family (fence by job,
        # bundle/proc by node) lives on one shard, so "fires that
        # avoid the degraded shard" is a property of the LAYOUT, not
        # luck — the gate's population.  (A mixed bundle claims both
        # shards in one claim_bundle and every member rides the slow
        # sub-claim; production fleets see both shapes, the gate needs
        # the separable one.)
        node_shard = {a.id: shard_index(
            KS.dispatch_bundle_key(a.id, 0), 2) for a in fleet.agents}
        by_shard = {s: [a for a, sh in node_shard.items() if sh == s]
                    for s in (0, 1)}
        healthy_ids, degraded_ids = [], []
        i = 0
        while len(healthy_ids) < 10 or len(degraded_ids) < 10:
            jid = f"bd{i:04d}"
            i += 1
            s = shard_index(KS.lock_key(jid, 0), 2)
            tgt = healthy_ids if s == 0 else degraded_ids
            if len(tgt) >= 10:
                continue
            # prefer a node on the same shard; fall back to any agent
            nodes = by_shard[s] or [a.id for a in fleet.agents]
            job = Job(id=jid, name=jid, command="true",
                      kind=KIND_INTERVAL,
                      rules=[JobRule(timer="* * * * * *",
                                     nids=[nodes[0]])])
            job.check()
            fleet.audit_store.put(KS.job_key(job.group, job.id),
                                  job.to_json())
            tgt.append(jid)
        jobs = healthy_ids + degraded_ids
        deadline_reg = time.monotonic() + 10.0
        while time.monotonic() < deadline_reg:
            for sc in fleet.live_scheds():
                sc.drain_watches()
            if all(sc.rows.rules_of("default", jid)
                   for sc in fleet.live_scheds() for jid in jobs):
                break
            time.sleep(0.02)
        sink = fleet.logd.sink

        def fire_lats(lo, hi):
            """Per-fire dispatch latency (order BUILT -> exec start;
            wall stamps stay valid over synthetic seconds) keyed by
            (job, sec), from the trace plane."""
            out = {}
            for jid in jobs:
                for sec in range(lo, hi):
                    for sp in sink.trace_get(jid, sec):
                        ts = sp.get("ts", {})
                        a = ts.get("b") or ts.get("recv")
                        if a and ts.get("start"):
                            out[(jid, sec)] = (ts["start"] - a) * 1e3
            return out

        # healthy baseline
        mid = fleet.drive(T0, T0 + 3)
        fleet.settle(timeout=30.0)
        base = fire_lats(T0 + 1, mid)
        base_p99 = pctl(list(base.values()), 0.99)

        # 250 ms brownout on shard 1, dispatch still live underneath.
        # The faulted window drives at ~real time (the rest of the
        # drill free-runs synthetic seconds): each second's window
        # pays the slow shard's 250 ms on its publish lane, so
        # free-running 5 synthetic seconds in 1 wall second would
        # measure an artificial publisher backlog no real-time fleet
        # has — pacing keeps the lane caught up, which is the claim
        # under test (healthy fires, not publisher head-of-line).
        el = fleet.store_proxies[1].elapsed()
        rid = fleet.store_scheds[1].add("delay", start=el, ms=delay_ms,
                                        direction="s2c")
        # The faulted segment drives its OWN loop: agents pump on one
        # background thread EACH — continuously, like the separate
        # processes they are in production — while the scheduler steps
        # at a real-time-ish pace (>= the publish plane's per-window
        # cost on the slow shard).  drive()'s lock-step phases (serial
        # polls, join_running between polls) quantized every receipt
        # to the loop's phase boundaries, which the slow shard
        # stretches via the scheduler's composite keepalive/grant legs
        # — the gate then measured the drill loop (~1 s floor), not
        # the plane; the same harness-artifact class as the silent
        # node-lease expiry this drill already fixed.
        stop_pump = threading.Event()

        def pump(a):
            while not stop_pump.is_set():
                try:
                    a.poll()
                except Exception:  # noqa: BLE001 — faulted plane
                    pass
                time.sleep(0.05)
        pumps = [threading.Thread(target=pump, args=(a,), daemon=True)
                 for a in fleet.live_agents()]
        for th in pumps:
            th.start()
        t = mid
        stall_t0 = time.monotonic()
        try:
            while t < mid + 7:
                for sc in fleet.live_scheds():
                    try:
                        sc.step(now=t)
                    except Exception:  # noqa: BLE001 — faulted plane
                        fleet.step_errors += 1
                fleet.keepalive_agents()
                pace_until = time.monotonic() + max(
                    0.8, delay_ms / 1e3 * 5)
                while time.monotonic() < pace_until:
                    time.sleep(0.05)
                epochs = [sc._next_epoch for sc in fleet.live_scheds()
                          if sc._next_epoch is not None]
                nt = max(epochs) if epochs else None
                if nt is None or nt <= t:
                    if time.monotonic() - stall_t0 > 120.0:
                        raise RuntimeError(
                            f"faulted drive stalled at epoch {t}")
                    continue
                stall_t0 = time.monotonic()
                t = nt
        finally:
            stop_pump.set()
            for th in pumps:
                th.join(timeout=5.0)
        end = t
        fleet.store_scheds[1].remove(rid)
        time.sleep(1.0)        # breaker cooldown probe closes shard 1
        for a in fleet.live_agents():
            try:
                # re-list leftover bundles the fail-fast claims left
                # leased (the redelivery half of the breaker contract)
                a.resync_watches()
            except Exception:  # noqa: BLE001 — still healing
                pass
        # a publish timing out right at the fault boundary leaves a
        # HOLE at the tail window; two healed seconds let the rewind
        # re-plan it (late, never lost — the production loop's path)
        end = fleet.drive(end, end + 2, stall_timeout=60.0)
        fleet.settle(timeout=45.0)
        # the staged per-shard lanes retry slow-shard chunks to
        # COMPLETION (late, never lost), so a re-published bundle can
        # land inside settle's convergence window after the agents'
        # last event for it: one post-settle resync sweep re-lists and
        # consumes the stragglers (redelivery-by-resync is the leased
        # order contract), then settle re-converges
        for a in fleet.live_agents():
            try:
                a.resync_watches()
            except Exception:  # noqa: BLE001 — still healing
                pass
        fleet.settle(timeout=20.0)

        lats = fire_lats(mid + 1, end)
        # the gate covers the fault's STEADY interior: the first
        # faulted second is the breaker's detection episode
        # (fail_threshold slow calls per shard client) and the last
        # window's publish is truncated mid-flight when the drive
        # stops pacing — both are reported in the full ``lats`` set,
        # neither is the sustained-brownout claim under test
        steady = {k: v for k, v in lats.items()
                  if mid + 1 < k[1] < end - 2}
        healthy_lats = [v for (jid, _s), v in steady.items()
                        if jid in set(healthy_ids)]
        degraded_lats = [v for (jid, _s), v in steady.items()
                         if jid in set(degraded_ids)]
        # coverage gate over the HEALTHY population only: the degraded
        # shard's fires are late (post-heal redelivery) or consumed by
        # a fence their interrupted claim already burned — the
        # at-most-once brownout contract; counted, not failed
        findings, info = fleet.audit(expect_jobs=healthy_ids,
                                     planned_range=(T0 + 1, end))
        # DEGRADED-shard residue is leased, not leaked: a proc key
        # whose post-exec delete was refused by the open breaker
        # (expires at proc_ttl), or a slow-lane re-publish that landed
        # at the settle boundary after its members' fences were
        # consumed (expires at the dispatch lease) — count both, fail
        # on neither; healthy-shard leftovers still fail the gate
        residual = [f for f in findings
                    if f.code in ("orphan_proc", "leaked_reservation")
                    and shard_index(f.key, 2) == 1]
        findings = [f for f in findings if f not in residual]
        with fleet.ledger_mu:
            ran = {(j, s) for j, s in fleet.ledger}
        degraded_missing = sum(
            1 for jid in degraded_ids for sec in range(mid + 1, end)
            if (jid, sec) not in ran)
        res = {
            "baseline_fire_p99_ms": round(base_p99, 2),
            "healthy_fire_p99_ms": round(pctl(healthy_lats, 0.99), 2),
            "degraded_fire_p99_ms": round(pctl(degraded_lats, 0.99), 2),
            "healthy_fires": len(healthy_lats),
            "degraded_fires": len(degraded_lats),
            "degraded_fires_missing_in_window": degraded_missing,
            "degraded_proc_residue": len(residual),
            "delay_ms": delay_ms,
            "node_shards": node_shard,
        }
        info.update(res)
        if not healthy_lats:
            findings.append(invariants.Finding(
                "no_healthy_fires", "",
                "no fire avoided the degraded shard (seed layout?)"))
        # the bound: 2x the healthy baseline, floored at 1.5x the
        # injected delay.  With per-shard publish lanes a window's
        # seconds do not serialize their healthy-shard writes behind the
        # slow shard's earlier legs (one shared lane would put ~2 x
        # window_s x delay on a window's last second).  What remains is
        # the step thread's composite dispatch-lease grant (one slow leg
        # per window, the drill arms no scheduler-side breaker on
        # purpose) plus the proxied connection stacking one delayed
        # reply — ~1.5x delay covers both.  Couplings the gate catches:
        # a synchronous HWM get+CAS on the publish path, composite lease
        # grants failing whole on one open breaker, cleanup RPCs
        # destroying finished executions' records, and a silent
        # node-lease expiry in the harness — each lands well over this
        # bound (or starves dispatch outright).
        bound = max(2.0 * base_p99, 1.5 * delay_ms)
        if healthy_lats and res["healthy_fire_p99_ms"] > bound:
            findings.append(invariants.Finding(
                "brownout_dispatch_unbounded", "",
                f"healthy-shard fire p99 {res['healthy_fire_p99_ms']}ms "
                f"exceeds {bound:.1f}ms (max(2x baseline "
                f"{res['baseline_fire_p99_ms']}ms, 1.5x delay)) — "
                "per-shard publish decoupling did not contain the "
                "brownout"))
        # diagnostic artifact: the slowest fires' waterfalls name the
        # stage that ate the brownout
        slowest = sorted(lats.items(), key=lambda kv: -kv[1])[:3]
        slowest += sorted(
            ((k, v) for k, v in lats.items() if k[0] in set(healthy_ids)),
            key=lambda kv: -kv[1])[:3]
        waterfalls = []
        for (jid, sec), ms in slowest:
            wf = _trace.assemble(jid, sec, sink.trace_get(jid, sec))
            if wf:
                stages = wf["nodes"][0]["stages"]
                # drills run over SYNTHETIC seconds: the sched stage
                # (wall "b" vs synthetic second) is meaningless here
                stages.pop("sched", None)
                waterfalls.append({"job": jid, "sec": sec,
                                   "fire_ms": round(ms, 1),
                                   "stages": stages})
                on_log(f"  slow fire {jid}@{sec}: {round(ms, 1)}ms "
                       f"stages={stages}")
        info["slow_waterfalls"] = waterfalls
        on_log(f"brownout_dispatch: baseline p99 "
               f"{res['baseline_fire_p99_ms']}ms, healthy-shard p99 "
               f"{res['healthy_fire_p99_ms']}ms, degraded-shard p99 "
               f"{res['degraded_fire_p99_ms']}ms, "
               f"{len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_ckpt_race(seed=23, on_log=print, device=None):
    """Checkpoint save racing a store partition: saves land or fail
    LOUDLY (no torn/adopted state), the scheduler keeps dispatching
    exactly-once afterwards, and a post-heal save succeeds."""
    ckpt_dir = tempfile.mkdtemp(prefix="chaos-ckpt-")
    fleet = Fleet(seed=seed, n_jobs=16, n_agents=2,
                  checkpoint_dir=ckpt_dir, device=device)
    try:
        jobs = fleet.put_jobs()
        mid = fleet.drive(T0, T0 + 2)
        sc = fleet.scheds[0]
        el = fleet.store_proxies[0].elapsed()
        rid = fleet.store_scheds[0].add("sever", start=el + 0.1,
                                        end=el + 1.6)
        saves = {"ok": 0, "err": 0}

        def try_save():
            try:
                sc.checkpoint_save()
                saves["ok"] += 1
            except Exception as e:  # noqa: BLE001 — loud failure IS
                saves["err"] += 1   # the accepted outcome mid-partition
                on_log(f"save during partition failed loudly: {e}")
        th = threading.Thread(target=try_save)
        time.sleep(0.2)              # inside the sever window
        th.start()
        th.join(timeout=60)
        fleet.store_scheds[0].remove(rid)
        time.sleep(0.3)
        end = fleet.drive(mid, mid + 3, stall_timeout=60.0)
        try:
            sc.checkpoint_save()     # post-heal save must land
            saves["ok"] += 1
        except Exception as e:  # noqa: BLE001
            saves["err"] += 1
            on_log(f"post-heal save failed: {e}")
        fleet.settle(timeout=45.0)
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        if saves["ok"] < 1:
            findings.append(invariants.Finding(
                "ckpt_never_landed", "",
                f"no checkpoint save succeeded after heal ({saves})"))
        info.update(saves=saves,
                    ckpt_stats={k: v for k, v in sc.stats.items()
                                if "checkpoint" in k})
        on_log(f"ckpt_race: saves={saves}, {len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()
        import shutil
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def drill_agent_kill(seed=29, on_log=print, device=None):
    """Kill -9 an agent while an execution is provably in flight: its
    fence is consumed so nobody double-fires, its leased keys age out
    (clean fixpoint), the acked-record ledger shows no LOSS — and
    fsck NAMES the crashed run as a fence-without-record finding."""
    victim_job = "vk0000"
    fleet = Fleet(seed=seed, n_jobs=8, n_agents=2, dispatch_ttl=3.0,
                  agent_ttl=2.0, proc_ttl=2.0,
                  block_jobs=(victim_job,), device=device)
    try:
        jobs = fleet.put_jobs()
        jobs += fleet.put_jobs(prefix="vk", n=1)
        end = fleet.drive(T0, T0 + 3)
        fleet.quiesce_publishers()
        # poll until the victim job is provably IN FLIGHT somewhere,
        # then kill that agent mid-execution
        killed = None
        deadline = time.monotonic() + 20.0
        while killed is None and time.monotonic() < deadline:
            for a in fleet.live_agents():
                try:
                    a.poll()
                except Exception:  # noqa: BLE001 — churn
                    pass
            for a in fleet.live_agents():
                if a.executor.blocked.wait(timeout=0.1):
                    on_log(f"killing agent {a.id} mid-execution")
                    fleet.kill_agent(a)
                    killed = a
                    # victim's thread dies into closed sockets; the
                    # SURVIVOR's blocked runs (other seconds of the
                    # same job) complete normally from here on
                    for b in fleet.agents:
                        b.executor.release.set()
                    break
        if killed is None:
            raise RuntimeError("victim job never started — drill bug")
        end = fleet.drive(end, end + 2)
        time.sleep(3.5)              # victim's leased keys age out
        fleet.settle(timeout=45.0)
        findings, info = fleet.audit(allow_unacked_extra=True)
        # the offline audit must NAME the crashed run
        fsck_findings = invariants.fsck(
            fleet.audit_store, sink=fleet.audit_sink, ks=fleet.ks,
            stale_order_s=60.0)
        named = [f for f in fsck_findings
                 if f.code == "fence_without_record"
                 and f.key == victim_job]
        if not named:
            findings.append(invariants.Finding(
                "fsck_blind", victim_job,
                "fsck failed to name the fence-without-record left by "
                "the killed agent"))
        info.update(fsck=[str(f) for f in fsck_findings],
                    killed=[a.id for a in fleet.dead_agents],
                    planned_end=end)
        on_log(f"agent_kill: {info['executions']} execs, fsck named "
               f"{len(named)} crashed run(s), {len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def drill_replica_leader_kill(seed=43, replicated=True, on_log=print,
                              device=None):
    """Kill -9 the store replica-group LEADER (replication plane,
    repl/) while dispatch is live AND a probe writer is collecting
    quorum-acked puts: a follower must promote within a bounded
    window, every client (scheduler, agents, probes) must rotate to
    it, exactly-once must hold across the failover, and EVERY probe
    the old leader acked must still be readable afterwards — zero
    acked-record loss, the ``--repl-ack quorum`` contract.

    ``replicated=False`` runs the control experiment: the same
    topology with replication disabled (a plain single-copy store
    plus a cold standby that promotes EMPTY).  Acked probes vanish
    with the killed leader, so the drill FAILS — proving the gate
    measures the replication plane, not the harness."""
    if not replicated:
        return _replica_kill_unreplicated(seed, on_log)
    from ..repl import NotLeaderError  # noqa: F401 — plane up
    promote_after = 1.5
    fleet = Fleet(seed=seed, n_jobs=16, n_agents=2, lease_ttl=2.0,
                  repl="quorum", repl_members=3,
                  promote_after=promote_after, device=device)
    try:
        jobs = fleet.put_jobs()
        mid = fleet.drive(T0, T0 + 3)
        fleet.quiesce_publishers()
        # quorum-acked probe writer: every put that RETURNS was acked
        # by the leader only after >= 1 follower held it — the ledger
        # of writes the failover is not allowed to lose
        probe_cli = fleet.store_client()
        acked, stop_probe = [], threading.Event()

        def probe():
            i = 0
            while not stop_probe.is_set():
                key = f"/chaos/probe/{i:05d}"
                try:
                    probe_cli.put(key, str(i))
                    acked.append(key)
                except Exception:  # noqa: BLE001 — unacked: may or may
                    pass           # not have applied; not in the ledger
                i += 1
                time.sleep(0.01)
        th = threading.Thread(target=probe, daemon=True)
        th.start()
        time.sleep(0.4)              # probes provably in flight
        leader_mgr = next(m for m in fleet.repl_mgrs
                          if m.role() == "leader")
        on_log(f"killing replica leader {leader_mgr.self_addr} "
               f"(epoch {leader_mgr.store.repl_epoch()}) at epoch {mid}")
        t_kill = time.monotonic()
        fleet.flush_timeouts = []
        fleet.kill_store_leader()
        end = fleet.drive(mid, mid + 4, stall_timeout=90.0)
        # the JAX harness's drive returns as the cursor passes its end:
        # that is the recovery; the trailing quiesce is clocked apart
        recovery_s = fleet.end_passed_at - t_kill
        quiesce_s = fleet.quiesce_s
        stop_probe.set()
        th.join(timeout=15)
        fleet.settle(timeout=45.0)
        findings, info = fleet.audit(expect_jobs=jobs,
                                     planned_range=(T0 + 1, end))
        # ZERO acked-record loss: every quorum-acked probe must read
        # back from the promoted group
        lost = [k for k in list(acked)
                if fleet.audit_store.get(k) is None]
        for k in lost[:10]:
            findings.append(invariants.Finding(
                "acked_record_lost", k,
                "quorum-acked write missing after leader failover"))
        if len(lost) > 10:
            findings.append(invariants.Finding(
                "acked_record_lost", "...",
                f"{len(lost) - 10} further acked probes missing"))
        survivors = [m for m in fleet.repl_mgrs
                     if m is not leader_mgr and m.role() == "leader"]
        if not survivors:
            findings.append(invariants.Finding(
                "no_promotion", "",
                "no follower promoted after the leader kill"))
        # bounded takeover: grace + discovery sweeps + client rotation
        bound = promote_after * 3 + 10
        if recovery_s > bound:
            findings.append(invariants.Finding(
                "recovery_unbounded", "",
                f"replica takeover took {recovery_s:.1f}s "
                f"(> {bound:.0f}s)"))
        # a publisher that has not landed its windows or its mark within
        # the flush's timeout after the failover is a finding of its own
        for ft in fleet.flush_timeouts:
            findings.append(invariants.Finding(
                "publish_flush_timeout", ft["sched"],
                f"publisher flush timed out after {ft['timeout_s']:.0f}s "
                f"at stage {ft['stage']} ({ft['inflight']} windows in "
                f"flight, hwm {ft['hwm_done']} of {ft['hwm_want']})"))
        info.update(
            recovery_s=round(recovery_s, 3), quiesce_s=round(quiesce_s, 3),
            flush_timeouts=list(fleet.flush_timeouts),
            acked_probes=len(acked), lost_probes=len(lost),
            promoted=[m.self_addr for m in survivors],
            epoch=max(m.store.repl_epoch() for m in fleet.repl_mgrs))
        on_log(f"replica_leader_kill: recovery {recovery_s:.2f}s "
               f"(quiesce {quiesce_s:.2f}s), "
               f"{info['acked_probes']} acked probes ({len(lost)} "
               f"lost), {info['executions']} execs, "
               f"{len(findings)} finding(s)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        fleet.close()


def _replica_kill_unreplicated(seed, on_log):
    """The control arm: same kill, NO replication.  A plain
    single-copy store acks every write locally; the standby next to it
    never ships a record, so when the leader dies and the standby
    promotes (empty), every acked probe is gone.  The returned
    findings are EXPECTED — tests assert they are non-empty."""
    from ..repl import ReplManager, ReplicaGroupStore
    s0, s1 = MemStore(), MemStore()
    srv0, srv1 = StoreServer(s0), StoreServer(s1)
    group = [f"127.0.0.1:{srv0.port}", f"127.0.0.1:{srv1.port}"]
    # the standby is a repl follower in a group whose member 0 does
    # NOT speak the replication plane: it can promote, it just never
    # receives a record — the misconfigured-standby scenario
    m1 = ReplManager(s1, group[1], group, promote_after=1.0,
                     initial_role="follower")
    srv1.attach_repl(m1)
    srv0.start()
    srv1.start()
    m1.start()
    cli = None
    try:
        cli = ReplicaGroupStore(group, timeout=8.0)
        acked = []
        for i in range(50):
            key = f"/chaos/probe/{i:05d}"
            cli.put(key, str(i))     # acked single-copy, instantly
            acked.append(key)
        on_log(f"killing unreplicated store {group[0]} with "
               f"{len(acked)} acked probes on it alone")
        srv0.kill()
        deadline = time.monotonic() + 20.0
        while m1.role() != "leader" and time.monotonic() < deadline:
            time.sleep(0.1)
        findings = []
        if m1.role() != "leader":
            findings.append(invariants.Finding(
                "no_promotion", "", "standby never promoted"))
        lost = []
        for k in acked:
            try:
                if cli.get(k) is None:
                    lost.append(k)
            except Exception:  # noqa: BLE001 — unreachable = lost too
                lost.append(k)
        for k in lost[:5]:
            findings.append(invariants.Finding(
                "acked_record_lost", k,
                "acked write missing after failover (replication "
                "disabled: single-copy durability)"))
        if len(lost) > 5:
            findings.append(invariants.Finding(
                "acked_record_lost", "...",
                f"{len(lost) - 5} further acked probes missing"))
        info = {"acked_probes": len(acked), "lost_probes": len(lost),
                "replicated": False}
        on_log(f"replica_leader_kill[unreplicated]: {len(lost)}/"
               f"{len(acked)} acked probes lost, "
               f"{len(findings)} finding(s) (failure EXPECTED)")
        return {"findings": _findings_json(findings), "info": info}
    finally:
        if cli is not None:
            cli.close()
        srv1.stop()
        try:
            srv0.stop()
        except Exception:  # noqa: BLE001 — already killed
            pass


DRILLS = {
    "smoke": drill_smoke,
    "native_smoke": drill_native_smoke,
    "leader_kill9": drill_leader_kill9,
    "partition_leader_kill": drill_partition_leader_kill,
    "shard_partition": drill_shard_partition,
    "logd_flap": drill_logd_flap,
    "brownout": drill_brownout,
    "brownout_dispatch": drill_brownout_dispatch,
    "ckpt_race": drill_ckpt_race,
    "agent_kill": drill_agent_kill,
    "replica_leader_kill": drill_replica_leader_kill,
}


def run_drills(names, seed=None, on_log=print, device=None):
    device = warm_device(device)
    out = {}
    violations = 0
    for name in names:
        fn = DRILLS[name]
        on_log(f"=== drill {name} ===")
        t0 = time.monotonic()
        redelivered = Fleet.agent_redeliveries
        kw = {"device": device}
        if seed is not None:
            kw["seed"] = seed
        try:
            res = fn(on_log=on_log, **kw)
        except Exception as e:  # noqa: BLE001 — a crashed drill is a
            res = {"findings": [{"code": "drill_crashed", "key": name,
                                 "detail": repr(e)}],   # failed gate
                   "info": {}}
            on_log(f"drill {name} CRASHED: {e!r}")
        res["wall_s"] = round(time.monotonic() - t0, 2)
        res["info"]["agent_redeliveries"] = \
            Fleet.agent_redeliveries - redelivered
        out[name] = res
        violations += len(res["findings"])
    out["total_findings"] = violations
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drill", default="smoke",
                    help="drill name or 'all' "
                         f"({', '.join(DRILLS)})")
    ap.add_argument("--seed", type=int, default=None,
                    help="override each drill's default seed")
    ap.add_argument("--json", default=None,
                    help="write results JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device of the schedulers' planners "
                         "(default: the card; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    names = list(DRILLS) if args.drill == "all" else \
        [d.strip() for d in args.drill.split(",")]
    for n in names:
        if n not in DRILLS:
            ap.error(f"unknown drill {n!r}")
    res = run_drills(names, seed=args.seed, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps({k: (v if k == "total_findings"
                          else {"findings": v["findings"],
                                "wall_s": v["wall_s"]})
                      for k, v in res.items()}, indent=2))
    return 1 if res["total_findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
