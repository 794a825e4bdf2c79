"""The port's replication plane, ``cronsun_tpu_torch.repl`` (``ReplLog``,
``ReplManager``), against the JAX package's, on the CPU.

- A port replica group (three ``StoreServer`` members with quorum ack)
  loses its leader to a kill while a probe writer collects acked puts: a
  follower promotes and no acked probe is lost, as in the JAX group run
  the same way.
- Mixed groups (a port leader with JAX followers, and the other way
  round) converge to the leader's image: the shipping wire is one
  protocol.
- The replica drill's control arm (``replicated=False``) must lose acked
  probes in the port as it does in the JAX package.
- Slow tier: the port copy of ``tests/test_repl.py``'s drill gate.
"""

import os
import sys
import threading
import time

import pytest

from cronsun_tpu.repl import ReplManager as JaxManager
from cronsun_tpu.repl import ReplicaGroupStore as JaxGroupStore
from cronsun_tpu.store.memstore import MemStore as JaxMemStore
from cronsun_tpu.store.remote import RemoteStore as JaxRemote
from cronsun_tpu.store.remote import StoreServer as JaxServer
from cronsun_tpu_torch.repl import ReplLog, ReplManager as PortManager
from cronsun_tpu_torch.repl import ReplicaGroupStore as PortGroupStore
from cronsun_tpu_torch.scripts import bench_chaos as port_chaos
from cronsun_tpu_torch.store.memstore import MemStore as PortMemStore
from cronsun_tpu_torch.store.remote import RemoteStore as PortRemote
from cronsun_tpu_torch.store.remote import StoreServer as PortServer
from torch_parity import one_torch_thread, time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_chaos as jax_chaos  # noqa: E402

PKG = {"jax": (JaxMemStore, JaxServer, JaxManager, JaxGroupStore,
               JaxRemote),
       "port": (PortMemStore, PortServer, PortManager, PortGroupStore,
                PortRemote)}


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Group:
    """Members of the given packages served over loopback; member 0
    boots leader with ``ack``, the rest boot followers."""

    def __init__(self, pkgs, ack="async", promote_after=60.0):
        self.pkgs = pkgs
        self.stores, self.srvs, self.mgrs = [], [], []
        for p in pkgs:
            mem_cls, srv_cls = PKG[p][:2]
            st = mem_cls()
            self.stores.append(st)
            self.srvs.append(srv_cls(st))
        self.addrs = [f"{s.host}:{s.port}" for s in self.srvs]
        for i, p in enumerate(pkgs):
            m = PKG[p][2](self.stores[i], self.addrs[i], self.addrs,
                          ack_mode=ack if i == 0 else "async",
                          promote_after=promote_after,
                          initial_role="leader" if i == 0 else "follower")
            self.srvs[i].attach_repl(m)
            self.srvs[i].start()
            self.mgrs.append(m)
        for m in self.mgrs:
            m.start()

    def dial(self, i):
        host, _, port = self.addrs[i].rpartition(":")
        return PKG[self.pkgs[i]][4](host, int(port), timeout=5.0,
                                    reconnect=False)

    def image(self, i):
        return {kv.key: (kv.value, kv.mod_rev)
                for kv in self.stores[i].get_prefix("")}

    def close(self):
        for m in self.mgrs:
            try:
                m.stop()
            except Exception:  # noqa: BLE001 — already stopped
                pass
        for s in self.srvs:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — already killed
                pass


def leader_kill(pkg):
    """A 3-member quorum group of ``pkg`` loses its leader under a probe
    writer.  Returns (acked probes, lost probes, promoted members)."""
    g = Group([pkg] * 3, ack="quorum", promote_after=1.0)
    cli = PKG[pkg][3](list(g.addrs), timeout=5.0)
    acked, stop = [], threading.Event()

    def probe():
        i = 0
        while not stop.is_set():
            key = f"/probe/{i:05d}"
            try:
                cli.put(key, str(i))
                acked.append(key)
            except Exception:  # noqa: BLE001 — unacked: not in the ledger
                pass
            i += 1
            time.sleep(0.01)
    th = threading.Thread(target=probe, daemon=True)
    try:
        th.start()
        time.sleep(0.5)
        g.srvs[0].kill()
        _wait(lambda: any(m.role() == "leader" for m in g.mgrs[1:]), 20.0,
              "a follower's promotion")
        n_before = len(acked)
        _wait(lambda: len(acked) > n_before + 5, 20.0,
              "acked probes through the promoted leader")
        stop.set()
        th.join(timeout=10)
        lost = [k for k in acked if cli.get(k) is None]
        promoted = [i for i, m in enumerate(g.mgrs[1:], 1)
                    if m.role() == "leader"]
        return acked, lost, promoted
    finally:
        stop.set()
        cli.close()
        g.close()


@pytest.mark.chaos
def test_a_port_group_loses_no_acked_probe_to_a_leader_kill():
    with time_limit(120, "replica leader kill"):
        out = {p: leader_kill(p) for p in ("jax", "port")}
    for pkg, (acked, lost, promoted) in out.items():
        assert len(acked) > 10, pkg
        assert lost == [], (pkg, lost[:5])
        assert len(promoted) == 1, (pkg, promoted)


@pytest.mark.parametrize("pkgs", [("port", "jax", "jax"),
                                  ("jax", "port", "port")],
                         ids=["port-leader", "jax-leader"])
def test_a_mixed_group_converges_to_the_leaders_image(pkgs):
    with time_limit(60, "mixed replica group"):
        g = Group(list(pkgs))
        lead = g.dial(0)
        try:
            for i in range(60):
                lead.put(f"/m/{i:03d}", f"v{i}")
            lease = lead.grant(30)
            lead.put("/m/leased", "x", lease=lease)
            for i in range(0, 60, 4):
                lead.delete(f"/m/{i:03d}")
            rev = g.stores[0].rev()
            _wait(lambda: all(s.rev() >= rev for s in g.stores[1:]), 20.0,
                  "followers at the leader's revision")
            want = g.image(0)
            assert len(want) == 46
            for i in (1, 2):
                assert g.image(i) == want, g.pkgs[i]
                assert g.mgrs[i].role() == "follower"
            statuses = [m.status() for m in g.mgrs]
            assert statuses[1]["lag_records"] == statuses[2][
                "lag_records"] == 0
        finally:
            lead.close()
            g.close()


def test_repl_log_rings_alike():
    """The leader's shipping ring: the same appends (epoch records among
    them) and reads give the same cursors, records, coverage and epochs
    in both packages, before and after a re-baseline."""
    from cronsun_tpu.repl import ReplLog as JaxReplLog
    out = []
    for cls in (JaxReplLog, ReplLog):
        log = cls(capacity=16, epoch=2)
        for i in range(40):
            log.append(["E", 3] if i == 25 else ["p", f"/k{i}", str(i)])
        got = [log.read_after(c, 8) for c in (0, 20, 30, 39, 40)]
        cov = [log.covers(c) for c in (0, 23, 24, 40, 41)]
        eps = [log.epoch_at(c) for c in (0, 25, 26, 40)]
        log.reset(100, 4)
        log.append(["p", "/after", "x"])
        out.append((log.seq, got, cov, eps, log.read_after(100),
                    log.epoch_at(101)))
    assert out[1] == out[0]
    assert out[0][2] == [False, False, True, True, False]


def codes(res):
    return {f["code"] if isinstance(f, dict) else f.code
            for f in res["findings"]}


@pytest.mark.chaos
def test_the_unreplicated_control_arm_loses_acked_probes_in_both():
    """``replicated=False``: single-copy stores ack locally, the standby
    promotes empty, and the acked probes are gone — the finding that
    shows the drill measures the replication plane."""
    os.environ.setdefault("CRONSUN_CHAOS", "1")
    with time_limit(90, "unreplicated control arm"):
        ref = jax_chaos.drill_replica_leader_kill(
            on_log=lambda *a: None, replicated=False)
        got = port_chaos.drill_replica_leader_kill(
            on_log=lambda *a: None, replicated=False, device="cpu")
    assert "acked_record_lost" in codes(got)
    assert codes(got) == codes(ref)
    assert got["info"] == ref["info"]


@pytest.mark.slow
@pytest.mark.chaos
def test_replica_leader_kill_drill():
    """Port copy of ``tests/test_repl.py::test_replica_leader_kill_drill``:
    kill -9 of a store-shard leader under live dispatch with quorum ack
    — bounded takeover, exactly-once intact, zero acked-record loss —
    across 3 seeds."""
    for seed in (43, 44, 45):
        res = port_chaos.DRILLS["replica_leader_kill"](
            on_log=lambda *a: None, seed=seed, device="cpu")
        assert res["findings"] == [], f"seed {seed}: {res['findings']}"
        assert res["info"]["acked_probes"] > 0


@pytest.mark.slow
@pytest.mark.chaos
def test_replica_leader_kill_drill_fails_unreplicated():
    """Port copy of the JAX slow gate: the same drill MUST fail with
    replication disabled."""
    res = port_chaos.DRILLS["replica_leader_kill"](
        on_log=lambda *a: None, replicated=False, device="cpu")
    assert "acked_record_lost" in codes(res)
