"""The port's scheduler service against the JAX package's.

Each case seeds two JAX-package ``MemStore``s the same way, builds a JAX
``SchedulerService`` (JAX on the CPU) on one and a port
``SchedulerService(device="cpu")`` on the other, steps both over the same
``now``s, and requires byte-identical published ``dispatch`` keys and
values and equal high-water marks — the check ``tests/test_partition.py``
makes between two JAX services.

Between steps the harness waits for each service's in-flight plan
dispatches (``settle``): a pipelined step hands the next window's dispatch
to the service's dispatch thread, and whether the next step's capacity
reconcile lands before or after that dispatch is a race in both packages.
"""

import json

import numpy as np
import pytest

from cronsun_tpu.core import Keyspace, TenantQuota
from cronsun_tpu.ops.planner import TickPlanner as JaxPlanner
from cronsun_tpu.sched import SchedulerService as JaxService
from cronsun_tpu.store import MemStore
from cronsun_tpu_torch.ops.planner import TickPlanner as PortPlanner
from cronsun_tpu_torch.sched import SchedulerService as PortService
from cronsun_tpu_torch.synth import seed_service_store

KS = Keyspace()
NOW = 1_753_000_000          # :40 — eight 4 s windows cross a minute
J, N, W = 2048, 64, 4
# the services' own counters each scenario is compared on (the snapshot's
# other fields are latencies)
COUNTERS = ("jobs", "dispatches_total", "overflow_late_fires_total",
            "overflow_drops_total", "publish_max_second_node_keys",
            "publish_max_second_excl_fires", "dep_jobs", "dep_blocked_jobs",
            "dep_events_mirrored", "tenants", "tenant_throttled_fires_total",
            "tenant_shed_fires_total", "smear_jobs", "smear_deferred_total",
            "smear_emitted_total", "smear_merged_dups_total")


def settle(svc):
    """Wait until every plan dispatch the service has handed to its
    dispatch thread has been issued."""
    if svc._pending_plan is not None:
        svc._resolve_handle(svc._pending_plan[1])
    for _ep, handle, _fires in svc._pending_replans:
        svc._resolve_handle(handle)


def jax_service(store, max_fire_bucket=None, **kw):
    if max_fire_bucket is not None:
        kw["planner"] = JaxPlanner(J, N, max_fire_bucket=max_fire_bucket)
    return JaxService(store, KS, job_capacity=J, node_capacity=N,
                      window_s=W, dispatch_ttl=3600.0,
                      clock=lambda: float(NOW), **kw)


def port_service(store, max_fire_bucket=None, **kw):
    if max_fire_bucket is not None:
        kw["planner"] = PortPlanner(J, N, max_fire_bucket=max_fire_bucket,
                                    device="cpu")
    return PortService(store, KS, job_capacity=J, node_capacity=N,
                       window_s=W, dispatch_ttl=3600.0,
                       clock=lambda: float(NOW), device="cpu", **kw)


def orders(store):
    return {kv.key: kv.value for kv in store.get_prefix(KS.dispatch)}


def run(make, seed, steps=8, between=None, partitions=1, **kw):
    """Seed a fresh store, step ``partitions`` services of one package
    over ``steps`` windows from NOW; ``between(store, new_orders)`` runs
    after each step with the orders that step published.  Returns the
    published orders, the high-water marks and the services' counters."""
    store = MemStore()
    seed(store)
    if partitions > 1:
        kw.update(partitions=partitions)
    svcs = [make(store, node_id=f"s{i}",
                 **(dict(kw, partition=i) if partitions > 1 else kw))
            for i in range(partitions)]
    try:
        t = [NOW] * partitions
        seen = {}
        for _ in range(steps):
            for i, svc in enumerate(svcs):
                svc.step(now=t[i])
                settle(svc)
                t[i] = svc._next_epoch
            cur = orders(store)
            if between is not None:
                between(store, {k: v for k, v in cur.items()
                                if seen.get(k) != v})
            seen = cur
        for svc in svcs:
            svc._builder.flush()
            svc.publisher.flush()
        for svc in svcs:
            svc._drain_build_acct()
            svc._drain_tenant_q()
        snaps = [svc.metrics_snapshot() for svc in svcs]
        return (sorted(orders(store).items()),
                [store.get(svc._hwm_key).value for svc in svcs],
                [{k: snap[k] for k in COUNTERS} for snap in snaps])
    finally:
        for svc in svcs:
            svc.stop()


# ---- scenarios: (seed, between, service kwargs) ---------------------------

def put_job(store, group, jid, doc):
    store.put(KS.job_key(group, jid), json.dumps(doc))


def nodes(store, n):
    ids = [f"n{i}" for i in range(n)]
    for nid in ids:
        store.put(KS.node_key(nid), "x")
    return ids


def seed_mix(store):
    """Common, Interval and Alone jobs placed on one node, on groups and
    on groups less a node: ``scripts/bench_sched.py``'s placement mix."""
    seed_service_store(store, KS, 1500, 48, NOW)


DAG_SOURCES, DAG_MIDS, DAG_SINKS = 8, 8, 4


def seed_dag(store):
    """A 3-stage DAG (as tests/test_dag.py): time-triggered sources, mids
    on two sources each (every misfire policy, one max_in_flight gate),
    sinks on two mids each; plus plain jobs around it."""
    ids = nodes(store, 6)
    for i in range(DAG_SOURCES):
        put_job(store, "dag", f"s{i}", {
            "name": f"s{i}", "command": "true", "kind": (0, 2)[i % 2],
            "rules": [{"id": "r", "timer": f"*/{2 + i % 3} * * * * *",
                       "nids": ids[:3]}]})
    policies = ("skip", "fire", "hold")
    for i in range(DAG_MIDS):
        put_job(store, "dag", f"m{i}", {
            "name": f"m{i}", "command": "true", "kind": (0, 2, 1)[i % 3],
            "deps": {"on": [f"s{i}", f"s{(i + 3) % DAG_SOURCES}"],
                     "misfire": policies[i % 3],
                     "max_in_flight": 1 if i == 5 else 0},
            "rules": [{"id": "r", "timer": "@dep", "nids": ids[2:]}]})
    for i in range(DAG_SINKS):
        put_job(store, "dag", f"k{i}", {
            "name": f"k{i}", "command": "true", "kind": 2,
            "deps": {"on": [f"m{2 * i}", f"m{2 * i + 1}"]},
            "rules": [{"id": "r", "timer": "@dep", "nids": ids}]})
    for i in range(40):
        put_job(store, "default", f"p{i}", {
            "name": f"p{i}", "command": "true", "kind": i % 3,
            "rules": [{"id": "r", "timer": f"*/{1 + i % 7} * * * * *",
                       "nids": [ids[i % 6]]}]})


def fold_completions(store, new_orders):
    """The agents' completion records for every DAG fire just published:
    ``dep/dag/<job>`` = "<latest scheduled second>|ok" (every third job
    fails)."""
    latest = {}
    for key, value in new_orders.items():
        parts = key[len(KS.dispatch):].split("/")
        if parts[0] == KS.BROADCAST:
            fires = [("/".join(parts[2:]), int(parts[1]))]
        else:
            fires = [(j, int(parts[1])) for j in json.loads(value)]
        for job, ep in fires:
            if job.startswith("dag/"):
                latest[job] = max(latest.get(job, 0), ep)
    for job in sorted(latest):
        jid = job.split("/")[1]
        verdict = "fail" if int(jid[1:]) % 3 == 2 else "ok"
        store.put(KS.dep_key("dag", jid), f"{latest[job]}|{verdict}")


def seed_tenants(store):
    """A noisy tenant offered 12 fires a second against a 3/s bucket, a
    tenant capped by max_running, a weighted one, and untenanted
    victims."""
    ids = nodes(store, 4)
    store.put(KS.tenant_quota_key("noisy"), TenantQuota(
        tenant="noisy", rate=3.0, burst=3.0).to_json())
    store.put(KS.tenant_quota_key("acme"), TenantQuota(
        tenant="acme", max_running=2).to_json())
    store.put(KS.tenant_quota_key("heavy"), TenantQuota(
        tenant="heavy", weight=2.0).to_json())
    for i in range(12):
        put_job(store, "default", f"nz{i}", {
            "name": f"nz{i}", "command": "true", "kind": (0, 2)[i % 2],
            "tenant": "noisy",
            "rules": [{"id": "r", "timer": "* * * * * *", "nids": ids}]})
    for t in ("acme", "heavy"):
        for i in range(5):
            put_job(store, "default", f"{t}{i}", {
                "name": f"{t}{i}", "command": "true", "kind": 2,
                "tenant": t, "rules": [{"id": "r", "timer": "*/2 * * * * *",
                                        "nids": ids}]})
    for i in range(6):
        put_job(store, "default", f"v{i}", {
            "name": f"v{i}", "command": "true", "kind": i % 3,
            "rules": [{"id": "r", "timer": "* * * * * *",
                       "nids": [ids[i % 4]]}]})


def seed_jitter(store):
    """A herd smeared by per-job jitter (as tests/test_jitter.py), beside
    unsmeared jobs."""
    ids = nodes(store, 8)
    for i in range(300):
        put_job(store, "default", f"h{i}", {
            "name": f"h{i}", "command": "true", "kind": (2, 0, 1)[i % 3],
            "jitter": 1 + i % 9,
            "rules": [{"id": "r", "timer": "*/10 * * * * *",
                       "nids": [ids[i % 8], ids[(i + 3) % 8]]}]})
    for i in range(40):
        put_job(store, "default", f"u{i}", {
            "name": f"u{i}", "command": "true", "kind": i % 3,
            "rules": [{"id": "r", "timer": "*/3 * * * * *",
                       "nids": [ids[i % 8]]}]})


def seed_herd(store):
    """A minute-boundary herd of 1500 fires, three times the planners'
    512-row fire bucket: the service re-plans that second with an
    escalated bucket."""
    ids = nodes(store, 16)
    for i in range(1500):
        put_job(store, "default", f"hd{i}", {
            "name": f"hd{i}", "command": "true", "kind": (2, 0, 2, 1)[i % 4],
            "rules": [{"id": "r", "timer": "0 * * * * *",
                       "nids": [ids[i % 16], ids[(i * 7 + 1) % 16]]}]})
    for i in range(100):
        put_job(store, "default", f"e{i}", {
            "name": f"e{i}", "command": "true", "kind": i % 3,
            "rules": [{"id": "r", "timer": f"*/{2 + i % 5} * * * * *",
                       "nids": [ids[i % 16]]}]})


SCENARIOS = {
    "mix": (seed_mix, None, {}),
    "mix_serial": (seed_mix, None, {"pipelined": False}),
    "dag": (seed_dag, fold_completions, {}),
    "tenants": (seed_tenants, None, {}),
    "jitter": (seed_jitter, None, {}),
    "herd_overflow": (seed_herd, None, {"max_fire_bucket": 512}),
    "partitions_2": (seed_mix, None, {"partitions": 2}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_service_publishes_the_jax_services_orders(name):
    seed, between, kw = SCENARIOS[name]
    ref = run(jax_service, seed, between=between, **kw)
    got = run(port_service, seed, between=between, **kw)
    assert ref[0], "no orders published: the comparison is vacuous"
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    # each scenario exercises what it names
    c = ref[2][0]
    assert c["overflow_drops_total"] == 0
    if name == "herd_overflow":
        assert c["overflow_late_fires_total"] > 0, "no second overflowed"
    if name == "dag":
        assert c["dep_jobs"] == DAG_MIDS + DAG_SINKS
        assert any('"dag/k' in v for _k, v in ref[0]), "no sink fired"
    if name == "tenants":
        assert c["tenant_throttled_fires_total"] > 0
    if name == "jitter":
        assert c["smear_deferred_total"] > 0


def test_seed_is_a_faithful_copy_of_the_bench_seed(monkeypatch):
    """``synth.seed_service_store`` writes what ``scripts/bench_sched.py``'s
    ``seed`` writes, key for key and value for value, at one clock."""
    import os
    import sys
    import time
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import bench_sched
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    ref, got = MemStore(), MemStore()
    bench_sched.seed(ref, KS, 2000, 64, on_log=lambda _m: None)
    seed_service_store(got, KS, 2000, 64, NOW)

    def dump(store):
        return sorted((kv.key, kv.value) for kv in store.get_prefix("/"))
    assert dump(got) == dump(ref)
    assert len(dump(ref)) == 64 + 32 + 2000 + 1200
    kinds = np.bincount([json.loads(kv.value)["kind"]
                         for kv in got.get_prefix(KS.cmd)], minlength=3)
    assert kinds.min() > 0
