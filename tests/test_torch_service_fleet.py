"""The port's scheduler service in a fleet of the JAX package's parts.

An in-process fleet (the JAX package's ``MemStore`` and ``NodeAgent``s
with the port's ``SchedulerService`` on the CPU) runs jobs exactly once,
as ``tests/test_integration.py`` shows for the JAX service; the port
service resyncs after a ``WatchLost`` raised by the JAX package's store;
and scheduler checkpoints restore across the two packages in both
directions — the JAX package's into the port in a process that never
imports the JAX package, the port's into the JAX package's service.
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from cronsun_tpu.core import Job, JobRule, Keyspace, KIND_ALONE, KIND_COMMON
from cronsun_tpu.logsink import JobLogStore
from cronsun_tpu.node.agent import NodeAgent
from cronsun_tpu.sched import SchedulerService as JaxService
from cronsun_tpu.store import MemStore
from cronsun_tpu_torch.sched import SchedulerService as PortService
from cronsun_tpu_torch.synth import seed_service_store
from torch_parity import one_torch_thread  # noqa: F401

KS = Keyspace()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_753_000_000


# ---- the in-process fleet (tests/test_integration.py, port scheduler) -----

@pytest.fixture
def world():
    store = MemStore()
    sink = JobLogStore()
    agents = [NodeAgent(store, sink, node_id=f"node-{i}") for i in range(2)]
    for a in agents:
        a.register()
    sched = PortService(store, job_capacity=256, node_capacity=64,
                        window_s=2, device="cpu")
    yield store, sink, sched, agents
    sched.stop()
    store.close()


def put_job(store, job: Job):
    job.check()
    store.put(KS.job_key(job.group, job.id), job.to_json())


def drive(sched, agents, t0, seconds):
    """Step the scheduler over [t0, t0+seconds), letting agents consume."""
    t = t0
    end = t0 + seconds
    while t < end:
        sched.step(now=t)
        for a in agents:
            a.poll()
        for a in agents:
            a.join_running()
        t = sched._next_epoch
    for a in agents:
        a.poll()
        a.join_running()


def test_alone_job_runs_on_exactly_one_node_per_second(world):
    store, sink, sched, agents = world
    job = Job(name="solo", command="echo solo", kind=KIND_ALONE,
              rules=[JobRule(timer="* * * * * *",
                             nids=["node-0", "node-1"])])
    put_job(store, job)
    drive(sched, agents, 1_753_000_100, 4)
    logs, total = sink.query_logs(job_ids=[job.id])
    assert total >= 2
    # every execution holds its own (job, second) fence key: no fence
    # without a run, no run twice
    locks = store.get_prefix(KS.lock + job.id + "/")
    assert len(locks) == total
    spans = sorted((lg.begin_ts, lg.end_ts) for lg in logs)
    for (_b1, e1), (b2, _e2) in zip(spans, spans[1:]):
        assert b2 >= e1, "Alone executions overlapped"


def test_node_death_reroutes_exclusive_job(world):
    store, sink, sched, agents = world
    job = Job(name="failover", command="echo f", kind=KIND_ALONE,
              rules=[JobRule(timer="* * * * * *",
                             nids=["node-0", "node-1"])])
    put_job(store, job)
    drive(sched, agents, 1_753_000_600, 2)
    agents[0].unregister()          # node-0 dies: lease revoked, DELETE
    _, before = sink.query_logs(job_ids=[job.id])
    drive(sched, agents, 1_753_000_610, 3)
    logs, total = sink.query_logs(job_ids=[job.id])
    assert total > before
    assert any(lg.node == "node-1" for lg in logs)
    assert len(store.get_prefix(KS.lock + job.id + "/")) == total


def test_common_job_runs_on_every_eligible_node_once_a_second(world):
    store, sink, sched, agents = world
    job = Job(name="hello", command="echo hi", kind=KIND_COMMON,
              rules=[JobRule(timer="* * * * * *",
                             nids=["node-0", "node-1"])])
    put_job(store, job)
    drive(sched, agents, 1_753_000_000, 3)
    logs, total = sink.query_logs(job_ids=[job.id])
    runs = [(lg.node, lg.begin_ts) for lg in logs]
    assert total >= 4 and {n for n, _ in runs} == {"node-0", "node-1"}
    assert all(lg.success for lg in logs)


def test_scheduler_resync_after_watch_loss(world):
    """The JAX package's store raises its own ``WatchLost``: the port
    service resyncs from the store's contents, as the JAX service does."""
    store, sink, sched, agents = world
    j1 = Job(name="pre", command="echo 1", kind=KIND_COMMON,
             rules=[JobRule(timer="* * * * * *", nids=["node-0"])])
    put_job(store, j1)
    sched.drain_watches()
    assert ("default", j1.id) in sched.rows.by_job
    sched._w_jobs._max_backlog = 5
    store.delete(KS.job_key("default", j1.id))
    j2 = Job(name="post", command="echo 2", kind=KIND_COMMON,
             rules=[JobRule(timer="* * * * * *", nids=["node-0"])])
    put_job(store, j2)
    for i in range(10):
        store.put(KS.cmd + f"filler/f{i}", "not-json")
    sched.drain_watches()      # the buffered tail
    sched.drain_watches()      # WatchLost -> resync
    assert sched.stats["watch_losses"] == 1
    assert ("default", j1.id) not in sched.rows.by_job, \
        "deleted job survived resync"
    assert ("default", j2.id) in sched.rows.by_job, "new job missed by resync"


def test_other_store_errors_still_raise(world):
    store, sink, sched, agents = world

    class Broken(RuntimeError):
        pass

    def boom():
        raise Broken("not a watch loss")
    sched._drain_watches_once = boom
    with pytest.raises(Broken):
        sched.drain_watches()
    assert sched.stats["watch_losses"] == 0


# ---- checkpoints across the packages ---------------------------------------

J, N, W = 512, 32, 4


def seeded_store(wal=None):
    store = MemStore()
    if wal is not None:
        store.open_wal(wal)
    seed_service_store(store, KS, 400, 24, NOW)
    return store


def service(cls, store, ckpt_dir, **kw):
    if cls is PortService:
        kw["device"] = "cpu"
    return cls(store, KS, job_capacity=J, node_capacity=N, window_s=W,
               dispatch_ttl=3600.0, clock=lambda: float(NOW),
               checkpoint_dir=ckpt_dir, node_id=f"s{time.monotonic_ns()}",
               **kw)


def first_window(svc, ep):
    """The orders of the window at ``ep``, planned from capacities
    reconciled from the service's mirrors (bench_sched.py's divergence
    check)."""
    svc.reconcile_capacity()
    svc._flush_device()
    secs = []
    for p in svc.planner.plan_window(ep, W, sla_bucket=J):
        svc._build_plan_orders(p, secs, [])
    return [[ep, k, v] for ep, os_ in secs for k, v in os_]


def saved(cls, store, ckpt_dir):
    """A service of ``cls`` that stepped two windows and saved a full
    checkpoint; returns it with the next window's epoch."""
    svc = service(cls, store, ckpt_dir)
    t = NOW
    for _ in range(2):
        svc.step(now=t)
        t = svc._next_epoch
    svc._resolve_handle(svc._pending_plan[1])
    assert svc.checkpoint_save(kind="full")["kind"] == "full"
    return svc, t


_PORT_RESTORE = """
import json, sys
sys.path.insert(0, {root!r})
from cronsun_tpu_torch.core import Keyspace
from cronsun_tpu_torch.sched import SchedulerService
from cronsun_tpu_torch.store import MemStore
store = MemStore().open_wal({wal!r})
svc = SchedulerService(store, Keyspace(), job_capacity={J}, node_capacity={N},
                       window_s={W}, dispatch_ttl=3600.0,
                       clock=lambda: float({now}), checkpoint_dir={ckpt!r},
                       node_id="port", device="cpu")
assert svc.checkpoint_restored, "cold-loaded"
svc.reconcile_capacity()
svc._flush_device()
secs = []
for p in svc.planner.plan_window({ep}, {W}, sla_bucket={J}):
    svc._build_plan_orders(p, secs, [])
svc.stop()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "cronsun_tpu")]
print(json.dumps({{"bad": bad, "orders": [[e, k, v] for e, os_ in secs
                                           for k, v in os_]}}))
"""


def test_jax_checkpoint_restores_in_the_port_without_the_jax_package(
        tmp_path):
    """The JAX service saves; a port service in another process opens the
    same store (from its WAL) and restores the checkpoint without
    importing ``jax`` or ``cronsun_tpu``; its first window's orders are
    the JAX service's."""
    wal, ckpt = str(tmp_path / "store.wal"), str(tmp_path / "ckpt")
    store = seeded_store(wal)
    jax_svc, ep = saved(JaxService, store, ckpt)
    want = first_window(jax_svc, ep)
    jax_svc.stop()
    store.close()
    code = _PORT_RESTORE.format(root=ROOT, wal=wal, ckpt=ckpt, J=J, N=N, W=W,
                                now=NOW, ep=ep)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert want and got["orders"] == want


def test_port_checkpoint_restores_in_the_jax_service(tmp_path):
    """The port service saves; the JAX service restores it on the same
    store, and its first window's orders are the port service's."""
    store = seeded_store()
    ckpt = str(tmp_path / "ckpt")
    port_svc, ep = saved(PortService, store, ckpt)
    jax_svc = service(JaxService, store, ckpt)
    try:
        assert jax_svc.checkpoint_restored
        want = first_window(port_svc, ep)
        assert want and first_window(jax_svc, ep) == want
    finally:
        jax_svc.stop()
        port_svc.stop()


def test_both_packages_write_the_same_checkpoint_arrays(tmp_path):
    """From the same state the two services checkpoint the same device
    arrays in the same dtypes: the table columns, ``elig`` as uint32
    words, ``exclusive`` bool, ``cost`` f32."""
    files = {}
    for cls in (JaxService, PortService):
        d = str(tmp_path / cls.__module__.split(".")[0])
        svc = service(cls, seeded_store(), d)
        svc.checkpoint_save(kind="full")
        svc.stop()
        with open(os.path.join(d, "sched.ckpt"), "rb") as f:
            files[cls] = pickle.load(f)
    ref, got = files[JaxService], files[PortService]
    assert set(got["table"]) == set(ref["table"])
    for name in ("elig", "exclusive", "cost", *(f"table.{c}" for c in
                                                ref["table"])):
        a = ref["table"][name[6:]] if name.startswith("table.") else ref[name]
        b = got["table"][name[6:]] if name.startswith("table.") else got[name]
        assert b.dtype == a.dtype and np.array_equal(b, a), name
    assert got["elig"].dtype == np.uint32
    assert got["jobs"] == ref["jobs"] and got["rows"] == ref["rows"]


def test_port_loader_maps_the_jax_packages_classes(tmp_path):
    """Unpickling a JAX scheduler's checkpoint names the port's copy of
    ``Group``, in a process that never imports the JAX package."""
    ckpt = str(tmp_path / "ckpt")
    svc = service(JaxService, seeded_store(), ckpt)
    svc.checkpoint_save(kind="full")
    svc.stop()
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from cronsun_tpu_torch.checkpoint import load_checkpoint; "
            f"st = load_checkpoint({os.path.join(ckpt, 'sched.ckpt')!r}); "
            "g = next(iter(st['groups'].values())); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cronsun_tpu')]; "
            "print(type(g).__module__, len(st['groups']), bad)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["cronsun_tpu_torch.core.models", "32", "[]"]
