"""The port's mesh planners over a mesh that spans processes, mirroring the
reference's ``tests/test_multihost.py``:

- two ``torch.distributed`` gloo processes with 2 CPU shards each plan
  exactly what one process with 4 shards plans, and what the JAX package's
  4-device mesh plans from the same state;
- the deployable mode: ``cronsun_tpu_torch.bin.sched --mesh-hosts 2``, rank
  0 leading with a store and rank 1 as a worker with none; a job put into
  the store gets orders, job churn flows through the op-log broadcast, the
  worker ignores a first SIGTERM, and the leader's SIGTERM releases it
  (exit 0, ``released after N plan steps``);
- the worker's signal watchdog: a first SIGTERM is ignored, a second
  force-exits, and a single SIGUSR1 force-exits.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_mesh_worker as worker  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(nprocs, shards, kind):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(nprocs), str(shards), kind,
         str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(nprocs)]


def lines(procs, timeout=120):
    """Each process's PLAN and STATE lines, once all have exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    return [[ln for ln in out.splitlines() if ln.startswith(("PLAN", "STATE"))]
            for out in outs]


def jax_lines(kind):
    """The same plans from the JAX package's 4-device mesh."""
    from cronsun_tpu.parallel import mesh as jm
    from torch_parity import jax_mesh_planner
    st = worker.state()
    if kind == "1d":
        p = jax_mesh_planner(jm.ShardedTickPlanner, jm.make_mesh(4), st,
                             impl="jnp", max_fire_bucket=1024)
    else:
        p = jax_mesh_planner(jm.Sharded2DTickPlanner, jm.make_mesh2d(2, 2),
                             st, max_fire_bucket=1024)
    plans = p.plan_window(worker.T0, worker.W) + [p.plan(worker.T0 +
                                                          worker.W)]
    lines = [" ".join(["PLAN", str(pl.epoch_s),
                       ",".join(map(str, pl.fired.tolist())),
                       ",".join(map(str, pl.assigned.tolist())),
                       str(pl.overflow), str(pl.total_fired)])
             for pl in plans]
    load = np.asarray(p.load).astype(np.float64)
    lines.append(" ".join(["STATE", ",".join(map(repr, load.tolist())),
                           ",".join(map(str, np.asarray(p.rem_cap)
                                        .tolist()))]))
    return lines


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_two_process_mesh_matches_one_process_and_the_jax_mesh(
        forced_host_devices, kind):
    one, two = start(1, 4, kind), start(2, 4, kind)
    ref, = lines(one)
    mh = lines(two)
    assert len(ref) == worker.W + 2 and any(
        len(ln.split()[2]) > 50 for ln in ref[:-1]), ref
    # every process computed (and fetched) the identical global plan
    assert mh[0] == mh[1], "processes disagree on the global plan"
    assert mh[0] == ref, "the 2-process plan diverged from 1 process"
    assert jax_lines(kind) == ref, "the port diverged from the JAX mesh"


@pytest.mark.parametrize("mesh_flags", [("--mesh", "2"), ("--mesh2d", "2x2")])
def test_mesh_worker_mode_end_to_end(tmp_path, mesh_flags):
    from cronsun_tpu.core.models import Job, JobRule
    from test_torch_launcher_fleet import PORT_SCHED, _Fleet
    fleet = _Fleet(tmp_path)
    try:
        common = ["--store", fleet.addr, "--conf", fleet.conf, "--device",
                  "cpu", *mesh_flags, "--mesh-hosts", "2",
                  "--mesh-coordinator", f"127.0.0.1:{free_port()}"]
        leader = fleet.spawn(PORT_SCHED, *common, "--mesh-proc-id", "0",
                             "--node-id", "mesh-leader")
        wk = fleet.spawn(PORT_SCHED, *common, "--mesh-proc-id", "1")
        assert wk.ready() == "mesh-worker-1"
        assert leader.ready() == "mesh-leader"
        fleet.put_job("mh1")
        c, ks = fleet.client, fleet.ks
        deadline = time.time() + 60
        while time.time() < deadline and c.count_prefix(ks.dispatch_all) < 3:
            time.sleep(0.25)
        assert c.count_prefix(ks.dispatch_all) >= 3, leader.output()
        # live churn flows through the broadcast op log
        c.put(ks.job_key("g", "mh2"), Job(
            id="mh2", group="g", name="second", command="echo 2", kind=0,
            rules=[JobRule(id="r1", timer="*/2 * * * * *",
                           nids=["w1", "w2"])]).to_json())
        deadline = time.time() + 60
        while time.time() < deadline and not any(
                kv.key.endswith("/g/mh2")
                for kv in c.get_prefix(ks.dispatch_all)):
            time.sleep(0.25)
        assert any(kv.key.endswith("/g/mh2")
                   for kv in c.get_prefix(ks.dispatch_all)), leader.output()
        # the worker ignores a first SIGTERM; the leader's SIGTERM releases
        # it through the stop broadcast
        wk.p.send_signal(signal.SIGTERM)
        time.sleep(1.0)
        assert wk.p.poll() is None, wk.output()
        assert leader.stop(timeout=30) == 0, leader.output()
        assert wk.p.wait(timeout=30) == 0, wk.output()
        wk.stop()
        out = wk.output()
        assert "first signal ignored" in out
        steps = int(out.split("released after ")[1].split()[0])
        assert steps > 0
        assert "kernel launch counts" in leader.output()
    finally:
        for p in fleet.procs:
            p.stop()
        fleet.client.close()


_WATCHDOG = """
import sys, threading
sys.path.insert(0, {root!r})
from cronsun_tpu_torch.bin.sched import install_worker_signal_watchdog
install_worker_signal_watchdog()
print("READY", flush=True)
threading.Event().wait()
"""


@pytest.mark.parametrize("signals,ignored", [
    ((signal.SIGTERM, signal.SIGTERM), True),
    ((signal.SIGUSR1,), False)])
def test_worker_signal_watchdog(signals, ignored):
    """The main thread parked in a wait that never returns to the
    interpreter (as in a gloo collective): a first SIGTERM is ignored, a
    second force-exits; one SIGUSR1 force-exits."""
    p = subprocess.Popen([sys.executable, "-c",
                          _WATCHDOG.format(root=REPO)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        assert p.stdout.readline().strip() == "READY"
        p.send_signal(signals[0])
        if ignored:
            time.sleep(0.5)
            assert p.poll() is None
            p.send_signal(signals[1])
        assert p.wait(timeout=20) == 1
        err = p.stderr.read()
        assert "mesh worker: force exit" in err
        assert ("first signal ignored" in err) == ignored
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(10)
