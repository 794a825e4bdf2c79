"""A fleet of the port's processes only, each a real OS process talking
over TCP: ``cronsun_tpu_torch.bin.store``, ``.logd --shards 2``, ``.sched
--device cpu``, two ``.node`` agents and ``.web`` — the reference's
``tests/test_multiprocess.py`` (``test_full_system_multiprocess`` and
``test_node_crash_alert_across_processes``) with no process of the JAX
package.

Jobs are created through the REST API, executions land in the sharded
result store and are read back through ``/v1/logs`` and ``/v1/metrics``;
an agent SIGKILLed in one process tree makes the web process's noticer
page an HTTP receiver; SIGTERM stops every process with exit 0."""

import os
import re
import signal
from collections import Counter

from cronsun_tpu_torch.logsink.sharded import connect_sharded_sink
from torch_fleet import Fleet, Receiver, WebClient, wait_for

ALL_PORT = dict(store="port", logd="port", sched="port", node="port",
                web="port")
ECHO_TS = "sh -c 'echo $CRONSUN_SCHEDULED_TS'"


def test_full_system_of_port_processes(tmp_path):
    f = Fleet(tmp_path, ALL_PORT)
    try:
        sched = f.sched()
        nodes = [f.node(f"mp-node-{i}") for i in range(2)]
        web = f.web()
        sched.ready()
        for n in nodes:
            n.ready()
        client = WebClient(web.ready())
        for job_id, kind in (("mp-hello", 0), ("mp-once", 2)):
            client.call("PUT", "/v1/job", {
                "id": job_id, "name": job_id, "command": ECHO_TS,
                "kind": kind, "group": "default",
                "rules": [{"timer": "* * * * * *",
                           "nids": ["mp-node-0", "mp-node-1"]}]})
        connected = {n["id"] for n in client.call("GET", "/v1/nodes")
                     if n.get("connected")}
        assert {"mp-node-0", "mp-node-1"} <= connected

        sink = connect_sharded_sink(f.logd_addr.split(","))

        def landed():
            logs, total = sink.query_logs(job_ids=["mp-hello"],
                                          page_size=500)
            return total >= 6 and {r.node for r in logs} >= {
                "mp-node-0", "mp-node-1"}
        wait_for(landed, 60, "executions on both agents")
        api = client.call("GET", "/v1/logs")
        assert api["total"] >= 6
        metrics = client.call("GET", "/v1/metrics")
        m = re.search(r'cronsun_sched_steps_total\{[^}]*\} (\d+)', metrics)
        assert m and int(m.group(1)) > 0, metrics
        assert "cronsun_sched_tick_p99_ms" in metrics
        # the scheduler first, so no fire is left half-run
        assert sched.stop() == 0
        assert "kernel launch counts:" in sched.output()
        for n in nodes:
            assert n.stop() == 0
        logs, total = sink.query_logs(page_size=500)
        assert total == client.call("GET", "/v1/logs")["total"]
        assert all(r.success for r in logs)
        once = Counter(int(r.output) for r in logs if r.job_id == "mp-once")
        assert once and max(once.values()) == 1, once
        assert {r.node for r in logs if r.job_id == "mp-hello"} == {
            "mp-node-0", "mp-node-1"}
        sink.close()
        assert not os.path.exists(f.local_db), \
            "a process wrote the local log_db despite --logsink"
    finally:
        rcs = f.stop_all()
    assert all(rc == 0 for _m, rc in rcs), rcs


def test_node_crash_alert_across_port_processes(tmp_path):
    recv = Receiver()
    f = Fleet(tmp_path, ALL_PORT, node_ttl=3,
              mail={"enable": True, "http_api": recv.url})
    try:
        node = f.node("doomed-node")
        web = f.web()
        node.ready()
        client = WebClient(web.ready())
        sink = connect_sharded_sink(f.logd_addr.split(","))
        wait_for(lambda: (sink.get_node("doomed-node") or {}).get("alived"),
                 20, "the agent's mirror entry")
        node.p.send_signal(signal.SIGKILL)        # crash, not clean stop
        assert node.wait(timeout=10) == -signal.SIGKILL
        alerts = wait_for(recv.bodies, 30, "the crash alert")
        assert "doomed-node" in alerts[0]["subject"]
        wait_for(lambda: not sink.get_node("doomed-node")["alived"], 10,
                 "the mirror marked dead")
        nodes = {n["id"]: n for n in client.call("GET", "/v1/nodes")}
        assert not nodes["doomed-node"].get("connected")
        sink.close()
    finally:
        recv.close()
        rcs = f.stop_all()
    assert [rc for m, rc in rcs if not m.endswith(".node")] == [0, 0, 0]
