"""A fleet of real OS processes for the port's process tests: each role
(store, logd, sched, node, web) is the JAX package's ``cronsun_tpu.bin.*``
or the port's ``cronsun_tpu_torch.bin.*``, so a test pins the wire
between any two of them.  The process, the noticer's receiver and the
web client are ``chip_smoke.py``'s, which drives the same fleet on the
card."""

import json
import os
import subprocess
import sys
import time

from chip_smoke import Proc, Receiver, WebClient  # noqa: F401 (re-exported)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": "cronsun_tpu", "port": "cronsun_tpu_torch"}


def run_cli(mod, *args, timeout=60):
    """One launcher run to its end: (exit code, stdout + stderr)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", mod, *args], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    return r.returncode, r.stdout + r.stderr


class Fleet:
    """``roles`` maps each role to "jax" or "port"; the scheduler of the
    port runs with ``--device cpu`` unless :meth:`sched` is told
    otherwise."""

    def __init__(self, tmp_path, roles, logd_shards=2, **conf):
        self.tmp = tmp_path
        self.roles = roles
        self.procs = []
        self.local_db = str(tmp_path / "local-UNUSED.db")
        c = dict(log_db=self.local_db, window_s=2, node_ttl=5,
                 job_capacity=256, node_capacity=64, proc_req=0)
        c.update(conf)
        self.conf = str(tmp_path / "conf.json")
        with open(self.conf, "w") as f:
            json.dump(c, f)
        self.store = self.spawn("store", "--port", "0")
        self.store_addr = self.store.ready()
        self.logd = self.spawn("logd", "--port", "0", "--shards",
                               str(logd_shards), "--db",
                               str(tmp_path / "logd.db"))
        self.logd_addr = self.logd.ready()

    def spawn(self, role, *args) -> Proc:
        p = Proc(f"{PKG[self.roles[role]]}.bin.{role}", *args)
        self.procs.append(p)
        return p

    def _client_args(self):
        return ["--store", self.store_addr, "--logsink", self.logd_addr,
                "--conf", self.conf]

    def sched(self, node_id="sched-0", device="cpu") -> Proc:
        """``device`` None: the port's default, the card."""
        dev = ["--device", device] if self.roles["sched"] == "port" \
            and device else []
        return self.spawn("sched", "--store", self.store_addr, "--conf",
                          self.conf, "--node-id", node_id, *dev)

    def node(self, node_id) -> Proc:
        return self.spawn("node", *self._client_args(), "--node-id",
                          node_id)

    def web(self) -> Proc:
        return self.spawn("web", *self._client_args(), "--port", "0")

    def stop_all(self):
        """SIGTERM every live process, the last started first (the
        store last): [(module, exit code)] in start order."""
        rcs = [(p.mod, p.stop()) for p in reversed(self.procs)]
        return rcs[::-1]


def wait_for(pred, timeout, what, step=0.5):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(step)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")
