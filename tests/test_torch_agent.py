"""The port's node agent, ``cronsun_tpu_torch.node.agent.NodeAgent``, beside
the JAX package's, on the CPU.

A JAX store server, a JAX result store and a JAX ``SchedulerService`` drive
two agents as separate processes would see them (each over its own
package's wire clients): ``node-j`` is the JAX package's ``NodeAgent`` and
``node-p`` the port's.  Every exclusive job has a twin: ``a<i>`` pinned to
``node-j`` and ``b<i>`` to ``node-p``, with the same timer; Common jobs
run on both.  What one agent executes, records and traces must be what
the other does for the twin jobs: the same (job, second) set, the same
records in the sink, the same stats, and the same trace stage keys of a
sampled fire.  Node death and a lost watch run alike too.
"""

import json
import threading
import time
from collections import Counter

import pytest

from cronsun_tpu import trace as jax_trace
from cronsun_tpu.core import Job, JobRule, Keyspace
from cronsun_tpu.core.models import KIND_COMMON, KIND_INTERVAL
from cronsun_tpu.logsink.serve import LogSinkServer
from cronsun_tpu.logsink.serve import RemoteJobLogStore as JaxSinkClient
from cronsun_tpu.node.agent import NodeAgent as JaxAgent
from cronsun_tpu.node.executor import ExecResult as JaxExecResult
from cronsun_tpu.sched import SchedulerService as JaxScheduler
from cronsun_tpu.store.memstore import MemStore
from cronsun_tpu.store.remote import RemoteStore as JaxRemote
from cronsun_tpu.store.remote import StoreServer
from cronsun_tpu_torch.logsink.serve import RemoteJobLogStore as PortSinkClient
from cronsun_tpu_torch.node.agent import NodeAgent as PortAgent
from cronsun_tpu_torch.node.executor import ExecResult as PortExecResult
from cronsun_tpu_torch.store.remote import RemoteStore as PortRemote
from torch_parity import one_torch_thread, time_limit  # noqa: F401

KS = Keyspace()
T0 = 1_760_000_000
N_TWINS = 5
N_COMMON = 2
AGENTS = {"node-j": (JaxAgent, JaxRemote, JaxSinkClient, JaxExecResult),
          "node-p": (PortAgent, PortRemote, PortSinkClient,
                     PortExecResult)}


class Recorder:
    """Instant executor recording (job, scheduled second) per run."""

    def __init__(self, result_cls):
        self.result_cls = result_cls
        self.ledger = []
        self.mu = threading.Lock()

    def run_job(self, job_id="", command="", user="", timeout=0, retry=0,
                interval=0, parallels=0, env=None, sleep=time.sleep):
        sec = int((env or {}).get("CRONSUN_SCHEDULED_TS", "0") or 0)
        with self.mu:
            self.ledger.append((job_id, sec))
        now = time.time()
        return self.result_cls(True, "ok", now, now, exit_code=0)


class MixedFleet:
    """A JAX store, result store and scheduler; one agent of each
    package.  The agents are polled by hand, so nothing runs their lease
    keepalives: their node leases outlast the test instead (ttl 600 s)."""

    def __init__(self, jobs):
        self.srv = StoreServer(MemStore()).start()
        self.logd = LogSinkServer().start()
        self.admin = JaxRemote("127.0.0.1", self.srv.port, timeout=10)
        self.agents, self.recorders, self.dead = {}, {}, set()
        for nid, (agent_cls, store_cls, sink_cls, res_cls) in \
                AGENTS.items():
            rec = Recorder(res_cls)
            a = agent_cls(store_cls("127.0.0.1", self.srv.port, timeout=10),
                          sink_cls("127.0.0.1", self.logd.port, timeout=10),
                          node_id=nid, ttl=600.0, lock_ttl=120.0,
                          proc_req=0.0, trace_shift=0, executor=rec)
            a.register()
            self.agents[nid], self.recorders[nid] = a, rec
        for job in jobs:
            job.check()
            self.admin.put(KS.job_key(job.group, job.id), job.to_json())
        self.sched = JaxScheduler(
            JaxRemote("127.0.0.1", self.srv.port, timeout=10),
            job_capacity=256, node_capacity=64, window_s=2, lease_ttl=30.0,
            dispatch_ttl=300.0, node_id="sched-0", trace_shift=0)
        ids = [j.id for j in jobs]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            self.sched.drain_watches()
            if all(self.sched.rows.rules_of("default", i) for i in ids):
                break
            time.sleep(0.02)

    def live(self):
        return [a for n, a in self.agents.items() if n not in self.dead]

    def drive(self, t, end):
        """Step the scheduler over synthetic seconds [t, end) with the
        agents consuming; returns the plan cursor."""
        while t < end:
            self.sched.step(now=t)
            for a in self.live():
                a.poll()
            for a in self.live():
                a.join_running(timeout=5.0)
            t = max(t + 1, self.sched._next_epoch or t)
        return t

    def settle(self):
        self.sched._builder.flush()
        self.sched.publisher.flush(timeout=30)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            for a in self.live():
                a.poll()
                a.join_running()
            if self.admin.count_prefix(KS.dispatch) == 0 and \
                    self.admin.count_prefix(KS.proc) == 0:
                break
            time.sleep(0.1)
        for a in self.live():
            a._flush_acks()
            a._flush_records(force=True)

    def kill(self, nid):
        """The agent stops: its node lease is revoked, its node key
        gone, as a process that exits cleanly."""
        self.agents[nid].stop()
        self.dead.add(nid)

    def close(self):
        for nid, a in self.agents.items():
            if nid not in self.dead:
                a.stop()
            a.store.close()
            a.sink.close()
        self.sched.stop()
        self.sched.store.close()
        self.admin.close()
        self.logd.stop()
        self.srv.stop()


def twin_jobs():
    jobs = []
    for i in range(N_TWINS):
        for prefix, nid in (("a", "node-j"), ("b", "node-p")):
            jobs.append(Job(id=f"{prefix}{i:02d}", name=f"{prefix}{i:02d}",
                            command="true", kind=KIND_INTERVAL,
                            trace=i == 0,
                            rules=[JobRule(timer="* * * * * *",
                                           nids=[nid])]))
    for i in range(N_COMMON):
        jobs.append(Job(id=f"c{i:02d}", name=f"c{i:02d}", command="true",
                        kind=KIND_COMMON,
                        rules=[JobRule(timer="* * * * * *",
                                       nids=list(AGENTS))]))
    return jobs


def by_twin(ledger, prefix):
    return {(j[1:], s) for j, s in ledger if j.startswith(prefix)}


def test_the_port_agent_runs_records_and_traces_what_the_jax_agent_does():
    with time_limit(180, "mixed fleet"):
        fleet = MixedFleet(twin_jobs())
        try:
            end = fleet.drive(T0, T0 + 6)
            fleet.settle()
            led_j = fleet.recorders["node-j"].ledger
            led_p = fleet.recorders["node-p"].ledger
            sink = fleet.agents["node-j"].sink
            recs = {n: Counter((r.job_id[1:] if r.job_id[0] in "ab"
                                else r.job_id, r.success, r.output)
                               for r in sink.query_logs(
                                   node=n, page_size=1000)[0])
                    for n in AGENTS}
            stages = {}
            for prefix in ("a", "b"):
                stages[prefix] = [
                    (sec, sorted(jax_trace.stage_durations(
                        sec, sp["ts"])))
                    for sec in range(T0 + 1, end)
                    for sp in sink.trace_get(f"{prefix}00", sec)]
            stats = {n: a.stats for n, a in fleet.agents.items()}
        finally:
            fleet.close()
    want = {(f"{i:02d}", s) for i in range(N_TWINS)
            for s in range(T0 + 1, end)}
    assert by_twin(led_j, "a") == by_twin(led_p, "b") == want
    assert not by_twin(led_j, "b") and not by_twin(led_p, "a")
    assert by_twin(led_j, "c") == by_twin(led_p, "c") != set()
    assert len(led_j) == len(set(led_j)) and len(led_p) == len(set(led_p))
    assert recs["node-p"] == recs["node-j"]
    assert sum(recs["node-p"].values()) == len(led_p)
    assert stages["b"] == stages["a"] and len(stages["a"]) == end - T0 - 1
    assert set(stages["a"][0][1]) >= {"claim", "queue", "run", "record"}
    assert set(stats["node-p"]) == set(stats["node-j"])
    for k in ("orders_consumed_total", "execs_total",
              "rec_flush_records_total", "trace_spans_total"):
        assert stats["node-p"][k] == stats["node-j"][k] > 0, k


def shared_jobs(n=6):
    return [Job(id=f"e{i:02d}", name=f"e{i:02d}", command="true",
                kind=KIND_INTERVAL,
                rules=[JobRule(timer="* * * * * *", nids=list(AGENTS))])
            for i in range(n)]


def run_node_death(victim):
    """Exclusive jobs eligible on both nodes; ``victim`` stops after a
    few seconds.  Returns (every (job, second) run, the seconds the
    survivor ran alone, the window the death fell in)."""
    fleet = MixedFleet(shared_jobs())
    try:
        mid = fleet.drive(T0, T0 + 3)
        fleet.settle()
        fleet.kill(victim)
        # the scheduler learns of the death from its node watch before
        # it plans the next window (orders planned earlier for a node
        # that then dies are the failover gap, not this test's subject)
        assert fleet.admin.get(KS.node_key(victim)) is None
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            fleet.sched.drain_watches()
            time.sleep(0.02)
        end = fleet.drive(mid, mid + 4)
        fleet.settle()
        ledgers = {n: list(r.ledger) for n, r in fleet.recorders.items()}
    finally:
        fleet.close()
    survivor = next(n for n in AGENTS if n != victim)
    after = {e for e in ledgers[survivor] if e[1] >= mid}
    every = ledgers["node-j"] + ledgers["node-p"]
    return every, after, (mid, end), ledgers[victim]


def test_node_death_moves_every_fire_to_the_survivor_in_either_package():
    """The port agent dies beside a JAX one, then the other way round.
    Either way no (job, second) runs twice, the dead agent runs nothing
    past its death, and from the second window after it every due
    (job, second) runs on the survivor: the window already planned when
    the agent died (the pipelined step plans one ahead) may hold orders
    for it, which its lease takes with it."""
    with time_limit(240, "node death"):
        runs = {v: run_node_death(v) for v in AGENTS}
    for victim, (every, after, (mid, end), dead_led) in runs.items():
        assert len(every) == len(set(every)), victim
        assert all(s < mid for _, s in dead_led), victim
        want = {(f"e{i:02d}", s) for i in range(6)
                for s in list(range(T0 + 1, mid)) + list(range(mid + 2, end))}
        assert want <= set(every), (victim, sorted(want - set(every)))
        assert {e for e in after if e[1] >= mid + 2} == \
            {e for e in want if e[1] >= mid + 2}, victim


def test_a_lost_dispatch_watch_resyncs_alike():
    """Both agents' dispatch watches are lost while orders are published:
    each re-lists on its next poll, runs every missed order once, and
    counts one loss."""
    with time_limit(180, "watch loss"):
        fleet = MixedFleet(twin_jobs())
        try:
            mid = fleet.drive(T0, T0 + 3)
            fleet.settle()
            for a in fleet.agents.values():
                a._w_dispatch._mark_lost()
            fleet.sched.step(now=mid)       # orders land, unwatched
            fleet.sched._builder.flush()
            fleet.sched.publisher.flush(timeout=30)
            end = fleet.drive(mid, mid + 3)
            fleet.settle()
            led = {n: list(r.ledger) for n, r in fleet.recorders.items()}
            losses = {n: a.stats["watch_losses_total"]
                      for n, a in fleet.agents.items()}
        finally:
            fleet.close()
    want = {(f"{i:02d}", s) for i in range(N_TWINS)
            for s in range(T0 + 1, end)}
    got_j, got_p = by_twin(led["node-j"], "a"), by_twin(led["node-p"], "b")
    assert got_j == got_p, (sorted(want - got_j), sorted(want - got_p))
    assert got_j == want, (sorted(want - got_j), mid, end)
    assert losses == {"node-j": 1, "node-p": 1}


class RefusingWrites:
    """An agent's store client whose claim and fence writes raise while
    ``on`` (a store that takes no writes, as the agent sees it); every
    other call goes through."""

    OPS = ("claim_bundle", "claim_bundle_many", "put_if_absent")

    def __init__(self, inner):
        self.inner, self.on, self.refused = inner, False, 0

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in self.OPS:
            return attr

        def call(*a, **k):
            if self.on:
                self.refused += 1
                raise ConnectionError(f"{name} refused")
            return attr(*a, **k)
        return call


def test_a_bundle_whose_claim_failed_is_re_handled_by_the_port_agent():
    """Both agents' claims are refused for two planned seconds, then the
    store heals.  The port agent re-reads the bundles it could not claim
    and runs each of their (job, second)s once; the JAX agent leaves
    them leased in the store until a resync (here an explicit one), so
    without it those fires would be lost."""
    with time_limit(120, "refused claims"):
        fleet = MixedFleet(twin_jobs())
        try:
            mid = fleet.drive(T0, T0 + 2)
            fleet.settle()
            gates = {}
            for nid, a in fleet.agents.items():
                gates[nid] = a.store = RefusingWrites(a.store)
                gates[nid].on = True
            end = fleet.drive(mid, mid + 2)
            fleet.sched._builder.flush()
            fleet.sched.publisher.flush(timeout=30)
            for _ in range(3):      # the landed bundles' claims fail
                for a in fleet.live():
                    a.poll()
                    a.join_running()
            for g in gates.values():
                g.on = False
            port = fleet.agents["node-p"]
            want = {(f"{i:02d}", s) for i in range(N_TWINS)
                    for s in range(T0 + 1, end)}
            deadline = time.monotonic() + port.redeliver_after + 8
            while time.monotonic() < deadline:
                for a in fleet.live():
                    a.poll()
                    a.join_running()
                if want <= by_twin(fleet.recorders["node-p"].ledger, "b"):
                    break
                time.sleep(0.1)
            led_j = list(fleet.recorders["node-j"].ledger)
            led_p = list(fleet.recorders["node-p"].ledger)
            left = {nid: fleet.admin.count_prefix(KS.dispatch + nid + "/")
                    for nid in AGENTS}
            jax_agent = fleet.agents["node-j"]
            jax_agent.resync_watches()
            jax_agent.join_running()
            led_j_resynced = list(fleet.recorders["node-j"].ledger)
        finally:
            fleet.close()
    assert all(g.refused > 0 for g in gates.values())
    assert port.redelivered > 0
    got_p = {e for e in by_twin(led_p, "b") if e[1] < end}
    assert got_p == want, sorted(want - got_p)
    missed_j = want - by_twin(led_j, "a")
    assert missed_j and left["node-j"] > 0, (missed_j, left)
    assert left["node-p"] == 0
    assert want <= by_twin(led_j_resynced, "a")
    for led in (led_p, led_j_resynced):
        assert len(led) == len(set(led))


class DuplicatedClaims:
    """An agent's store client that sends every bundle claim twice and
    returns the second copy's reply, as a wire that duplicates a request
    line and delivers the duplicate's reply: the first copy applies
    (fences, proc keys, the order's delete), the second reports every
    member lost to it."""

    def __init__(self, inner):
        self.inner, self.doubled = inner, 0

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in ("claim_bundle", "claim_bundle_many"):
            return attr

        def call(*a, **k):
            attr(*a, **k)
            self.doubled += 1
            return attr(*a, **k)
        return call


def test_a_claim_lost_to_its_own_nonce_runs_in_the_port_agent():
    """Both agents' bundle claims come back as a duplicate's reply (every
    member lost to the claim's own first copy).  The port agent reads
    the lost fences back, finds its own nonce and runs each (job,
    second) once; the JAX agent runs none of them and leaves their proc
    keys behind."""
    with time_limit(120, "duplicated claims"):
        fleet = MixedFleet(twin_jobs())
        try:
            gates = {}
            for nid, a in fleet.agents.items():
                gates[nid] = a.store = DuplicatedClaims(a.store)
            end = fleet.drive(T0, T0 + 3)
            fleet.sched._builder.flush()
            fleet.sched.publisher.flush(timeout=30)
            for _ in range(3):
                for a in fleet.live():
                    a.poll()
                    a.join_running()
            led = {n: list(r.ledger) for n, r in fleet.recorders.items()}
            procs = {nid: fleet.admin.count_prefix(KS.proc + nid + "/")
                     for nid in AGENTS}
        finally:
            fleet.close()
    assert all(g.doubled > 0 for g in gates.values())
    want = {(f"{i:02d}", s) for i in range(N_TWINS)
            for s in range(T0 + 1, end)}
    got_p = {e for e in by_twin(led["node-p"], "b") if e[1] < end}
    assert got_p == want, sorted(want - got_p)
    assert len(led["node-p"]) == len(set(led["node-p"]))
    assert not by_twin(led["node-j"], "a") & want
    assert procs["node-j"] > 0 and procs["node-p"] == 0, procs


def test_the_port_agent_refuses_a_duplicate_node_like_the_jax_one():
    """A node id registered by another host while its lease lives: both
    agents refuse to start, with the same error."""
    srv = StoreServer(MemStore()).start()
    logd = LogSinkServer().start()
    admin = JaxRemote("127.0.0.1", srv.port)
    clients = [admin]
    try:
        lease = admin.grant(30)
        admin.put(KS.node_key("dup"), "elsewhere:4242", lease=lease)
        errs = []
        for agent_cls, store_cls, sink_cls, res in AGENTS.values():
            a = agent_cls(store_cls("127.0.0.1", srv.port),
                          sink_cls("127.0.0.1", logd.port), node_id="dup",
                          executor=Recorder(res))
            clients += [a.store, a.sink]
            with pytest.raises(Exception) as e:
                a.register()
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]
        assert errs[0][0] == "DuplicateNode" and "elsewhere" in errs[0][1]
    finally:
        for c in clients:
            c.close()
        logd.stop()
        srv.stop()


def test_order_values_parse_alike():
    """A bundle value with a trace header and a malformed one: both
    agents stage the same members (or release the malformed order)."""
    value = json.dumps(["default/x1", "default/x2", {"tb": T0 - 1.5}])
    out = []
    for nid, (agent_cls, store_cls, sink_cls, res) in AGENTS.items():
        srv = StoreServer(MemStore()).start()
        logd = LogSinkServer().start()
        a = agent_cls(store_cls("127.0.0.1", srv.port),
                      sink_cls("127.0.0.1", logd.port), node_id=nid,
                      executor=Recorder(res))
        try:
            n_ok = a._handle_dispatch_kv(
                KS.dispatch_bundle_key(nid, T0), value)
            n_bad = a._handle_dispatch_kv(
                KS.dispatch_bundle_key(nid, T0 + 1), "{not json")
            out.append((n_ok, n_bad, sorted(
                name.split("-")[0] for name in a.running)))
        finally:
            a.stop()
            a.store.close()
            a.sink.close()
            logd.stop()
            srv.stop()
    assert out[0] == out[1]
    assert out[0][:2] == (2, 0)
