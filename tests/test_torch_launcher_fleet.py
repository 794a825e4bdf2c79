"""The port's scheduler as a real OS process in a fleet of the JAX
package's processes: a JAX store, ``cronsun_tpu_torch.bin.sched --device
cpu`` and a JAX agent, crossing process boundaries over TCP.

- a per-second job runs once per scheduled second, and SIGTERM stops the
  port's scheduler with exit 0 and its kernel launch counts logged;
- failover between two port schedulers: SIGKILL the leader, executions
  resume, no scheduled second runs twice, ``skipped_seconds_total`` 0;
- a JAX leader and a port standby share one ``checkpoint_dir``: SIGKILL
  the JAX leader, the port takes over with the same guarantees (a rolling
  migration from the JAX package to the port);
- a port scheduler with ``--profile-port`` serves a capture while it steps
  (the planner's ranges from its own threads), and each second still runs
  once.
"""

import gzip
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

from cronsun_tpu.core import Keyspace
from cronsun_tpu.core.models import Job, JobRule
from cronsun_tpu.logsink import JobLogStore
from cronsun_tpu.store.remote import RemoteStore
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCHED = "cronsun_tpu_torch.bin.sched"


class _Proc:
    """A fleet process whose output is drained into ``lines`` (an
    undrained pipe would block it mid-log-line)."""

    def __init__(self, mod, *args):
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        self.p = subprocess.Popen(
            [sys.executable, "-m", mod, *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self):
        for line in self.p.stdout:
            self.lines.append(line)
            if line.startswith("READY"):
                self._ready.set()
        self._ready.set()

    def ready(self, timeout=120) -> str:
        if not self._ready.wait(timeout) or self.p.poll() is not None:
            raise AssertionError(f"no READY within {timeout}s (rc "
                                 f"{self.p.poll()}):\n{self.output()}")
        return next(ln for ln in self.lines
                    if ln.startswith("READY")).split(None, 1)[1].strip()

    def output(self) -> str:
        return "".join(self.lines)

    def stop(self, timeout=10) -> int:
        """SIGTERM, then the exit code (SIGKILL past ``timeout``)."""
        if self.p.poll() is None:
            self.p.send_signal(signal.SIGTERM)
        try:
            rc = self.p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.p.kill()
            rc = self.p.wait(timeout=timeout)
        self._reader.join(timeout)
        return rc


def _conf(tmp_path, **extra):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(dict(
        log_db=str(tmp_path / "logs.db"), window_s=2, node_ttl=5,
        job_capacity=256, node_capacity=64, **extra)))
    return str(conf)


class _Fleet:
    def __init__(self, tmp_path, **conf):
        self.conf = _conf(tmp_path, **conf)
        self.log_db = str(tmp_path / "logs.db")
        self.procs = []
        self.store_p = self.spawn("cronsun_tpu.bin.store", "--port", "0")
        self.addr = self.store_p.ready()
        host, _, port = self.addr.rpartition(":")
        self.ks = Keyspace()
        self.client = RemoteStore(host, int(port))
        self.sink = None

    def spawn(self, mod, *args):
        p = _Proc(mod, *args)
        self.procs.append(p)
        return p

    def sched(self, mod, node_id, *extra):
        return self.spawn(mod, "--store", self.addr, "--conf", self.conf,
                          "--node-id", node_id,
                          *(["--device", "cpu"] if mod == PORT_SCHED else []),
                          *extra)

    def agent(self, node_id="w1"):
        p = self.spawn("cronsun_tpu.bin.node", "--store", self.addr,
                       "--conf", self.conf, "--node-id", node_id)
        p.ready()
        return p

    def put_job(self, job_id="j1", node="w1"):
        # the command echoes the second it was scheduled FOR: records of a
        # loaded box bunch into one wall second, exactly-once keys on this
        job = Job(id=job_id, group="g", name=job_id,
                  command="sh -c 'echo $CRONSUN_SCHEDULED_TS'", kind=0,
                  rules=[JobRule(id="r1", timer="* * * * * *",
                                 nids=[node])])
        self.client.put(self.ks.job_key("g", job_id), job.to_json())

    def scheduled(self):
        if self.sink is None:
            self.sink = JobLogStore(self.log_db)
        recs, _total = self.sink.query_logs(page_size=1000)
        out = [r.output.strip() for r in recs]
        assert all(s.isdigit() for s in out), out
        return [int(s) for s in out]

    def wait_runs(self, n, timeout, after=0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if sum(s > after for s in self.scheduled()) >= n:
                return
            time.sleep(0.25)
        raise AssertionError(f"fewer than {n} runs after {after} within "
                             f"{timeout}s: {sorted(self.scheduled())}")

    def leader(self, among, timeout=30):
        deadline = time.time() + timeout
        while time.time() < deadline:
            kv = self.client.get(self.ks.leader)
            if kv is not None and kv.value in among:
                return kv.value
            time.sleep(0.1)
        raise AssertionError(f"none of {among} leads within {timeout}s")

    def close(self):
        for p in self.procs:
            p.stop()
        self.client.close()
        if self.sink is not None:
            self.sink.close()


def _exactly_once_across(fleet, old_leader, scheds):
    """SIGKILL ``old_leader``; a standby of ``scheds`` takes over, planning
    resumes, no scheduled second runs twice, none is skipped."""
    fleet.wait_runs(3, timeout=60)
    killed_at = int(time.time())
    scheds[old_leader].p.send_signal(signal.SIGKILL)
    scheds[old_leader].p.wait(timeout=10)
    # the standby takes over within the leader lease (10 s)
    fleet.wait_runs(3, timeout=60, after=killed_at + 1)
    new = fleet.leader(set(scheds) - {old_leader})
    secs = fleet.scheduled()
    assert len(secs) == len(set(secs)), \
        "a scheduled second executed twice across the failover"
    kv = fleet.client.get(fleet.ks.metrics_key("sched", new))
    assert kv is not None
    snap = json.loads(kv.value)
    assert snap.get("skipped_seconds_total", 0) == 0, snap
    return new, scheds[new]


def test_port_sched_in_a_jax_fleet_runs_each_second_once(tmp_path):
    fleet = _Fleet(tmp_path)
    try:
        sched = fleet.sched(PORT_SCHED, "port-sched")
        assert sched.ready() == "port-sched"
        fleet.agent()
        fleet.put_job()
        fleet.wait_runs(4, timeout=60)
        assert fleet.leader({"port-sched"}) == "port-sched"
        secs = fleet.scheduled()
        assert len(secs) == len(set(secs)), secs
        assert sched.stop() == 0, sched.output()
        counts = [ln for ln in sched.lines if "kernel launch counts" in ln]
        assert counts, sched.output()
        assert set(json.loads(counts[-1].split("counts: ", 1)[1])) == {
            "bid_argmin", "bid_argmin_natural", "fanout_add",
            "waterfill_accept"}
    finally:
        fleet.close()


def test_port_to_port_failover_keeps_exactly_once(tmp_path):
    fleet = _Fleet(tmp_path)
    try:
        scheds = {sid: fleet.sched(PORT_SCHED, sid)
                  for sid in ("port-a", "port-b")}
        for p in scheds.values():
            p.ready()
        fleet.agent()
        fleet.put_job()
        old = fleet.leader(set(scheds))
        new, survivor = _exactly_once_across(fleet, old, scheds)
        assert new != old
        assert survivor.stop() == 0, survivor.output()
    finally:
        fleet.close()


def test_jax_leader_to_port_standby_takeover(tmp_path):
    """The rolling migration: a JAX leader and a port standby share one
    checkpoint_dir; the port restores the JAX leader's checkpoint."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    fleet = _Fleet(tmp_path, checkpoint_dir=str(ckpt),
                   checkpoint_interval=1)
    try:
        jax_s = fleet.sched("cronsun_tpu.bin.sched", "jax-sched")
        jax_s.ready(timeout=180)
        assert fleet.leader({"jax-sched"}) == "jax-sched"
        fleet.agent()
        fleet.put_job()
        fleet.wait_runs(2, timeout=60)
        deadline = time.time() + 30
        while not (ckpt / "sched.ckpt").exists():
            assert time.time() < deadline, "the JAX leader saved no checkpoint"
            time.sleep(0.2)
        port_s = fleet.sched(PORT_SCHED, "port-sched")
        port_s.ready()
        new, survivor = _exactly_once_across(
            fleet, "jax-sched", {"jax-sched": jax_s, "port-sched": port_s})
        assert new == "port-sched"
        assert "checkpoint RESTORED" in survivor.output(), survivor.output()
        assert survivor.stop() == 0, survivor.output()
    finally:
        fleet.close()


def test_port_sched_serves_a_profile_capture_while_it_steps(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    fleet = _Fleet(tmp_path)
    try:
        sched = fleet.sched(PORT_SCHED, "port-sched", "--profile-port",
                            str(port))
        assert sched.ready() == "port-sched"
        assert f"torch profiler server on :{port}" in sched.output()
        fleet.agent()
        fleet.put_job()
        fleet.wait_runs(2, timeout=60)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/capture?ms=3000",
                timeout=120) as r:
            assert r.headers["Content-Type"] == "application/gzip"
            server_tid = int(r.headers["X-Capture-Thread"])
            events = json.loads(gzip.decompress(r.read()))["traceEvents"]
        tids = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                tids.setdefault(e["name"], set()).add(e["tid"])
        for name in ("cronsun.plan.dispatch", "cronsun.fire_mask",
                     "cronsun.assign"):
            assert tids.get(name) and server_tid not in tids[name], tids
        n = len(fleet.scheduled())
        fleet.wait_runs(n + 2, timeout=60)
        secs = fleet.scheduled()
        assert len(secs) == len(set(secs)), secs
        assert sched.stop() == 0, sched.output()
        out = sched.output()
        assert "profile capture: 3000 ms" in out and \
            "kernel launch counts" in out, out
    finally:
        fleet.close()
