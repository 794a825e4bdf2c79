"""Mixed fleets of real processes, so the wire between the packages is
pinned in both directions:

- the port's web and agents around the JAX package's store, result store
  and scheduler;
- the JAX package's web and agents around the port's store, result store
  and scheduler (``--device cpu``).

In each: jobs created through the REST API run on both agents (a Common
job on each, an Interval job once a second across them), the records land
in the two-shard result store and read back through ``/v1/logs``, the
scheduler's steps show at ``/v1/metrics`` and ``/v1/sched`` (a web of
one package rendering the other's scheduler snapshot), a SIGKILLed agent
pages the noticer's HTTP receiver, and SIGTERM stops every other process
with exit 0."""

import signal
from collections import Counter

import pytest

from cronsun_tpu_torch.logsink.sharded import connect_sharded_sink
from torch_fleet import Fleet, Receiver, WebClient, wait_for

MIXES = {
    "port-edge-jax-core": dict(store="jax", logd="jax", sched="jax",
                               node="port", web="port"),
    "jax-edge-port-core": dict(store="port", logd="port", sched="port",
                               node="jax", web="jax"),
}
ECHO_TS = "sh -c 'echo $CRONSUN_SCHEDULED_TS'"


@pytest.fixture
def receiver():
    r = Receiver()
    yield r
    r.close()


@pytest.mark.parametrize("mix", list(MIXES))
def test_a_mixed_fleet_runs_jobs_across_the_wire(tmp_path, receiver, mix):
    f = Fleet(tmp_path, MIXES[mix], node_ttl=3,
              mail={"enable": True, "http_api": receiver.url})
    try:
        sched = f.sched()
        nodes = [f.node(f"mx-{i}") for i in range(2)]
        web = f.web()
        for p in (sched, *nodes):
            p.ready()
        client = WebClient(web.ready())
        for job_id, kind in (("mx-common", 0), ("mx-interval", 2)):
            client.call("PUT", "/v1/job", {
                "id": job_id, "name": job_id, "command": ECHO_TS,
                "kind": kind, "group": "default",
                "rules": [{"timer": "* * * * * *",
                           "nids": ["mx-0", "mx-1"]}]})
        sink = connect_sharded_sink(f.logd_addr.split(","))

        def both_ran():
            logs, _t = sink.query_logs(job_ids=["mx-common"], page_size=500)
            return len({r.node for r in logs}) == 2 and len(logs) >= 6
        wait_for(both_ran, 60, "the Common job on both agents")
        listed = {n["id"]: n for n in client.call("GET", "/v1/nodes")}
        assert listed["mx-0"]["connected"] and listed["mx-1"]["connected"]
        metrics = client.call("GET", "/v1/metrics")
        assert 'cronsun_sched_steps_total{instance="sched-0"}' in metrics
        insts = client.call("GET", "/v1/sched")["instances"]
        assert [(i["instance"], i["is_leader"]) for i in insts] == [
            ("sched-0", 1)] and insts[0]["steps_total"] > 0

        nodes[1].p.send_signal(signal.SIGKILL)
        wait_for(lambda: [a for a in receiver.bodies()
                          if "mx-1" in a["subject"]], 30,
                 "the node-down alert")
        assert sched.stop() == 0
        assert nodes[0].stop() == 0
        logs, total = sink.query_logs(page_size=500)
        assert client.call("GET", "/v1/logs")["total"] == total
        assert all(r.success for r in logs)
        once = Counter(int(r.output) for r in logs
                       if r.job_id == "mx-interval")
        assert once and max(once.values()) == 1, once
        sink.close()
    finally:
        rcs = f.stop_all()
    assert [rc for m, rc in rcs if not m.endswith(".node")] == [0, 0, 0, 0]
