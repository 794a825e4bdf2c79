"""The port's invariant audits, ``cronsun_tpu_torch.chaos.invariants``, against
the JAX package's, on the CPU.

One recorded fleet state, made from a seed (store contents, the drill's
execution ledger, the result store's records and the agents' acked counts),
is loaded into each package's ``MemStore`` and ``JobLogStore`` and audited
by each package: the drill checks (exactly-once, acked records, fixpoint),
``fsck`` with the sink, and the drill harness's own gate
(``bench_chaos.Fleet.audit``, which adds the lost-fire coverage check).
The clean state gives no finding; each seeded mutation must be named by
both packages with the same findings, code, key and detail alike.
"""

import dataclasses
import os
import sys
import threading
import types

import numpy as np
import pytest

from cronsun_tpu.chaos import invariants as jax_inv
from cronsun_tpu.core import Job as JaxJob
from cronsun_tpu.core import JobRule as JaxJobRule
from cronsun_tpu.core import Keyspace
from cronsun_tpu.logsink import JobLogStore as JaxJobLogStore
from cronsun_tpu.logsink import LogRecord as JaxLogRecord
from cronsun_tpu.store.memstore import MemStore as JaxMemStore
from cronsun_tpu_torch.chaos import invariants as port_inv
from cronsun_tpu_torch.core import Job as PortJob
from cronsun_tpu_torch.core import JobRule as PortJobRule
from cronsun_tpu_torch.logsink import JobLogStore as PortJobLogStore
from cronsun_tpu_torch.logsink import LogRecord as PortLogRecord
from cronsun_tpu_torch.scripts import bench_chaos as port_chaos
from cronsun_tpu_torch.store.memstore import MemStore as PortMemStore
from torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_chaos as jax_chaos  # noqa: E402

KS = Keyspace()
T0 = 1_760_000_000
NOW = T0 + 600.0          # every fence settled (fsck's 60 s window)
SECONDS = range(T0 + 1, T0 + 6)

JAX = types.SimpleNamespace(inv=jax_inv, Job=JaxJob, JobRule=JaxJobRule,
                            MemStore=JaxMemStore, Sink=JaxJobLogStore,
                            LogRecord=JaxLogRecord, chaos=jax_chaos)
PORT = types.SimpleNamespace(inv=port_inv, Job=PortJob, JobRule=PortJobRule,
                             MemStore=PortMemStore, Sink=PortJobLogStore,
                             LogRecord=PortLogRecord, chaos=port_chaos)


def recorded_state(seed: int) -> dict:
    """A settled fleet: exclusive (interval) and Common jobs on two nodes,
    each exclusive job run once a second in ``SECONDS`` behind its fence,
    one record per run (Common runs on both nodes), every record acked."""
    rng = np.random.default_rng(seed)
    n_jobs = int(rng.integers(8, 14))
    jobs = []
    for i in range(n_jobs):
        kind = 2 if rng.random() < 0.7 else 0
        jobs.append({"id": f"j{i:03d}", "kind": kind,
                     "nids": ["node-0", "node-1"]})
    ledger, fences, records = [], [], []
    for j in jobs:
        for sec in SECONDS:
            if j["kind"] == 2:
                node = f"node-{int(rng.integers(0, 2))}"
                ledger.append((j["id"], sec))
                fences.append((j["id"], sec))
                records.append((j["id"], node, sec))
            else:
                records += [(j["id"], n, sec) for n in j["nids"]]
    return {"jobs": jobs, "ledger": ledger, "fences": fences,
            "records": records, "extra": [], "flushed": len(records),
            "dropped": 0}


def load(pkg, state):
    """The state in ``pkg``'s store and sink."""
    store, sink = pkg.MemStore(), pkg.Sink()
    for j in state["jobs"]:
        job = pkg.Job(id=j["id"], name=j["id"], command="true",
                      kind=j["kind"],
                      rules=[pkg.JobRule(timer="* * * * * *",
                                         nids=j["nids"])])
        job.check()
        store.put(KS.job_key(job.group, job.id), job.to_json())
    for n in ("node-0", "node-1"):
        store.put(KS.node_key(n), "{}")
    for jid, sec in state["fences"]:
        store.put(KS.lock_key(jid, sec), "node-0")
    for key, value in state["extra"]:
        store.put(key, value)
    sink.create_job_logs([
        pkg.LogRecord(job_id=jid, job_group="default", name=jid, node=node,
                      user="", command="true", output="ok", success=True,
                      begin_ts=float(sec), end_ts=float(sec) + 0.5)
        for jid, node, sec in state["records"]])
    return store, sink


def audit(pkg, state) -> dict:
    store, sink = load(pkg, state)
    try:
        inv = pkg.inv
        out = {
            "exactly_once": inv.check_exactly_once(state["ledger"]),
            "acked": inv.check_acked_records(
                state["flushed"], state["dropped"],
                sink.stat_overall()["total"]),
            "fixpoint": inv.check_fixpoint(store, KS),
            "fsck": inv.fsck(store, sink, KS, now=NOW),
        }
        fleet = types.SimpleNamespace(
            ledger=list(state["ledger"]), ledger_mu=threading.Lock(),
            audit_store=store, audit_sink=sink, ks=KS,
            flushed_totals=lambda: (state["flushed"], state["dropped"]))
        excl = [j["id"] for j in state["jobs"] if j["kind"] == 2]
        findings, info = pkg.chaos.Fleet.audit(
            fleet, expect_jobs=excl, planned_range=(SECONDS[0],
                                                    SECONDS[-1] + 1))
        out["drill_gate"], out["drill_info"] = findings, info
    finally:
        sink.close()
    return {k: v if k == "drill_info"
            else [dataclasses.astuple(f) for f in v]
            for k, v in out.items()}


def first_excl(state):
    return next(j["id"] for j in state["jobs"] if j["kind"] == 2)


def duplicate_fire(state):
    state["ledger"].append(state["ledger"][3])


def lost_fire(state):
    jid, sec = state["ledger"].pop(2)
    state["records"] = [r for r in state["records"]
                        if (r[0], r[2]) != (jid, sec)]
    state["flushed"] -= 1


def fence_without_record(state):
    state["fences"].append((first_excl(state), T0 + 9))


def lost_acked_record(state):
    state["flushed"] += 2


def leaked_reservation(state):
    state["extra"].append((KS.dispatch_bundle_key("node-1", T0 + 2),
                           '["default/j000"]'))


def orphan_proc(state):
    state["extra"].append((KS.proc_key("node-0", "default", "gone", 41),
                           "{}"))


def orphan_fence_and_dangling_dep(state):
    state["extra"] += [(KS.lock_key("gone", T0 + 3), "node-1"),
                       (KS.dep_key("default", "gone"), f"{T0}|ok")]


def stuck_alone_lock(state):
    state["extra"].append((KS.alone_lock_key(first_excl(state)), "node-0"))


def duplicate_records_and_drops(state):
    state["flushed"] -= 1
    state["dropped"] = 3


MUTATIONS = {
    "duplicate_fire": (duplicate_fire, {"exactly_once_violation"}),
    "lost_fire": (lost_fire, {"lost_fire", "fence_without_record"}),
    "fence_without_record": (fence_without_record,
                             {"fence_without_record"}),
    "lost_acked_record": (lost_acked_record, {"acked_record_loss"}),
    "leaked_reservation": (leaked_reservation, {"leaked_reservation"}),
    "orphan_proc": (orphan_proc, {"orphan_proc"}),
    "orphan_fence_and_dangling_dep": (orphan_fence_and_dangling_dep,
                                      {"orphan_fence", "dangling_dep"}),
    "stuck_alone_lock": (stuck_alone_lock, {"stuck_alone_lock"}),
    "duplicate_records_and_drops": (duplicate_records_and_drops,
                                    {"duplicate_records",
                                     "records_dropped"}),
}


def codes(res) -> set:
    return {f[0] for k, v in res.items() if k != "drill_info" for f in v}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_state_has_no_finding_in_either_package(seed):
    ref = audit(JAX, recorded_state(seed))
    got = audit(PORT, recorded_state(seed))
    assert got == ref
    assert codes(got) == set()
    assert got["drill_info"]["executions"] > 0
    assert got["drill_info"]["lost_fires"] == 0


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
@pytest.mark.parametrize("seed", [0, 5])
def test_a_mutation_is_named_alike_by_both_packages(seed, mutation):
    mutate, want = MUTATIONS[mutation]
    states = []
    for _ in (JAX, PORT):
        st = recorded_state(seed)
        mutate(st)
        states.append(st)
    ref = audit(JAX, states[0])
    got = audit(PORT, states[1])
    assert got == ref
    assert codes(got) == want, codes(got)


def test_fsck_reads_each_packages_store_with_the_other_packages_audit():
    """A store of one package audited by the other package's fsck: the
    audits read only the store surface, which both copies share."""
    st = recorded_state(3)
    fence_without_record(st)
    store_j, sink_j = load(JAX, st)
    store_p, sink_p = load(PORT, st)
    try:
        ref = [dataclasses.astuple(f)
               for f in jax_inv.fsck(store_j, sink_j, KS, now=NOW)]
        assert [dataclasses.astuple(f) for f in port_inv.fsck(
            store_j, sink_j, KS, now=NOW)] == ref
        assert [dataclasses.astuple(f) for f in jax_inv.fsck(
            store_p, sink_p, KS, now=NOW)] == ref
        assert [f[0] for f in ref] == ["fence_without_record"]
    finally:
        sink_j.close()
        sink_p.close()


def test_render_and_json_are_alike():
    st = recorded_state(4)
    orphan_proc(st)
    duplicate_fire(st)
    out = []
    for pkg in (JAX, PORT):
        store, sink = load(pkg, st)
        try:
            f = pkg.inv.fsck(store, sink, KS, now=NOW) + \
                pkg.inv.check_exactly_once(st["ledger"])
        finally:
            sink.close()
        out.append((pkg.inv.render(f), pkg.inv.to_json(f)))
    assert out[1] == out[0]
    assert out[0][0].startswith("fsck: 2 finding(s)")
