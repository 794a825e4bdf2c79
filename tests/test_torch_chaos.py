"""The port's chaos drills, ``cronsun_tpu_torch.scripts.bench_chaos``,
against the JAX script's, on the CPU.

The smoke drill runs in both packages at one seed: both end with no
finding and a byte-identical fault schedule, inject the same faults, and
execute the same (job, scheduled second) set over the seconds the drill
guarantees (every planned second of every job).  The port's schedulers
plan on ``device="cpu"`` here; on the card the same drills run from
``chip_smoke.py``.  The slow tier holds port copies of
``tests/test_chaos_drills.py``'s gates.
"""

import json
import os
import sys

import pytest
import torch

from cronsun_tpu_torch.scripts import bench_chaos as port_chaos
from torch_parity import one_torch_thread, time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_chaos as jax_chaos  # noqa: E402


def quiet(*a):
    pass


def run_keeping_ledger(mod, monkeypatch, drill, **kw):
    """Run ``drill`` of ``mod``; returns its result, and the fleet's
    execution ledger and last plan cursor as the fleet saw them.

    The JAX drill arms its store reply-lost faults on ``claim_many`` and
    ``claim_bundle``; bundles due together are claimed in one group
    commit, ``claim_bundle_many``, which it leaves unarmed, so how many
    faults it injects hangs on the agents' poll lag (on a loaded host,
    none: ``tests/test_chaos.py::test_chaos_smoke_drill`` fails so).  The
    port's drill arms all three (``CLAIM_OPS``); here the JAX drill arms
    the same set, so both run one fault plan."""
    kept = {}
    close, drive = mod.Fleet.close, mod.Fleet.drive

    def keep_close(self):
        kept["ledger"] = list(self.ledger)
        return close(self)

    def keep_drive(self, *a, **k):
        kept["end"] = drive(self, *a, **k)
        return kept["end"]
    monkeypatch.setattr(mod.Fleet, "close", keep_close)
    monkeypatch.setattr(mod.Fleet, "drive", keep_drive)
    if mod is jax_chaos:
        arm = mod.hooks.arm

        def arm_claim_ops(site, kind, ops=None, **k):
            if site == "store.rpc" and ops == ("claim_many", "claim_bundle"):
                ops = port_chaos.CLAIM_OPS
            return arm(site, kind, ops=ops, **k)
        monkeypatch.setattr(mod.hooks, "arm", arm_claim_ops)
    res = getattr(mod, drill)(on_log=quiet, **kw)
    monkeypatch.undo()
    return res, kept["ledger"], kept["end"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [5, 7])
def test_port_smoke_drill_matches_the_jax_one(monkeypatch, seed):
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    with time_limit(120, "smoke drills"):
        ref, led_j, end_j = run_keeping_ledger(jax_chaos, monkeypatch,
                                               "drill_smoke", seed=seed)
        got, led_p, end_p = run_keeping_ledger(port_chaos, monkeypatch,
                                               "drill_smoke", seed=seed,
                                               device="cpu")
    for res in (ref, got):
        assert res["findings"] == [], res["findings"]
        assert res["info"]["schedule_deterministic"]
    assert got["info"]["injected"] == ref["info"]["injected"]
    assert got["info"]["injected"]["store.rpc:reply_lost"] > 0
    assert got["info"]["injected"]["logsink.rpc:reply_lost"] > 0
    # every planned second of every job is covered by both drills: the
    # sets agree up to the shorter of the two drives
    end = min(end_j, end_p)
    assert end > jax_chaos.T0 + 1
    lo = jax_chaos.T0 + 1
    covered_j = {e for e in led_j if lo <= e[1] < end}
    covered_p = {e for e in led_p if lo <= e[1] < end}
    assert covered_p == covered_j
    assert len(covered_p) == 10 * (end - lo)
    assert len(led_p) == len(set(led_p))


def test_same_seed_same_fault_schedule_bytes_in_both_scripts():
    """The smoke drill's determinism artifact, built by either script's
    rule set, is one byte string."""
    def rules(mod, seed):
        s = mod.FaultSchedule(seed)
        s.add("delay", prob=0.2, ms=15)
        s.add("dup", prob=0.10)
        s.add("reorder", prob=0.05)
        return s.schedule_bytes()
    for seed in (5, 7, 31):
        assert rules(port_chaos, seed) == rules(jax_chaos, seed)


def test_an_unknown_drill_is_refused_alike(capsys):
    with pytest.raises(KeyError):
        jax_chaos.run_drills(["nope"], on_log=quiet)
    with pytest.raises(KeyError):
        port_chaos.run_drills(["nope"], on_log=quiet, device="cpu")
    codes = []
    for mod, extra in ((jax_chaos, []), (port_chaos, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.main(["--drill", "smoke,nope"] + extra)
        codes.append(e.value.code)
        assert "unknown drill 'nope'" in capsys.readouterr().err
    assert codes == [2, 2]


def test_the_drill_list_and_flags_are_the_jax_scripts():
    assert list(port_chaos.DRILLS) == list(jax_chaos.DRILLS)
    assert port_chaos.T0 == jax_chaos.T0


def test_drills_refuse_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_chaos.run_drills(["smoke"], on_log=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_chaos.drill_smoke(on_log=quiet)


@pytest.mark.chaos
def test_port_chaos_smoke_drill(monkeypatch):
    """Port copy of ``tests/test_chaos.py::test_chaos_smoke_drill``, as
    it is: the port's drill also arms its store faults on the group
    commit (``CLAIM_OPS``), so its injections do not hang on the agents'
    poll lag."""
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    with time_limit(90, "smoke drill"):
        res = port_chaos.drill_smoke(seed=5, on_log=quiet, device="cpu")
    assert res["info"]["schedule_deterministic"], \
        "same seed must give byte-identical fault schedules"
    assert res["findings"] == [], res["findings"]
    assert res["info"]["executions"] > 0
    inj = res["info"]["injected"]
    assert inj.get("store.rpc:reply_lost", 0) > 0
    assert inj.get("logsink.rpc:reply_lost", 0) > 0


@pytest.mark.chaos
def test_port_main_writes_the_jax_scripts_json(tmp_path, capsys):
    path = tmp_path / "chaos.json"
    with time_limit(90, "bench_chaos main"):
        rc = port_chaos.main(["--drill", "smoke", "--device", "cpu",
                              "--json", str(path)])
    text = capsys.readouterr().out      # the drill's log lines, then
    out = json.loads(text[text.index("\n{") + 1:])       # the summary
    assert rc == 0
    assert text.startswith("=== drill smoke ===")
    assert out == {"smoke": {"findings": [],
                             "wall_s": out["smoke"]["wall_s"]},
                   "total_findings": 0}
    full = json.loads(path.read_text())
    assert set(full["smoke"]) == {"findings", "info", "wall_s"}
    assert full["smoke"]["info"]["agent_redeliveries"] >= 0


# ---- slow tier: port copies of tests/test_chaos_drills.py --------------

def _run(drill, **kw):
    return port_chaos.DRILLS[drill](on_log=quiet, device="cpu", **kw)


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_drills():
    res = _run("leader_kill9")
    assert res["findings"] == [], res["findings"]
    assert res["info"]["recovery_s"] < 16.0
    assert res["info"]["executions"] > 0

    res = _run("shard_partition")
    assert res["findings"] == [], res["findings"]
    assert res["info"]["executions"] > 0


@pytest.mark.slow
@pytest.mark.chaos
def test_partition_leader_kill_drill():
    res = _run("partition_leader_kill")
    assert res["findings"] == [], res["findings"]
    assert res["info"]["recovery_s"] < 16.0
    assert res["info"]["executions"] > 0
    assert all(n > 0 for n in res["info"]["slice_sizes"].values())


@pytest.mark.slow
@pytest.mark.chaos
def test_brownout_drill_bounded_p99():
    res = _run("brownout")
    assert res["findings"] == [], res["findings"]
    info = res["info"]
    assert info["degraded_p99_ms"] >= info["delay_ms"] * 0.8
    assert info["hardened_p99_ms"] <= \
        max(2.0 * info["baseline_p99_ms"], 20.0)


@pytest.mark.slow
@pytest.mark.chaos
def test_brownout_dispatch_drill():
    res = _run("brownout_dispatch")
    assert res["findings"] == [], res["findings"]
    info = res["info"]
    assert info["lost_fires"] == 0
    assert info["healthy_fires"] > 0 and info["degraded_fires"] > 0
    assert info["degraded_fire_p99_ms"] >= info["delay_ms"]
    assert info["slow_waterfalls"], "no trace waterfalls captured"
    stages = info["slow_waterfalls"][0]["stages"]
    assert "publish" in stages and "claim" in stages


@pytest.mark.slow
@pytest.mark.chaos
def test_native_backend_drill():
    if not port_chaos.native_available():
        pytest.skip("cronsun-stored/cronsun-logd binaries unavailable")
    res = _run("native_smoke")
    assert res["findings"] == [], res["findings"]
    assert res["info"].get("backend") == "native"
    assert res["info"]["executions"] > 0


@pytest.mark.slow
@pytest.mark.chaos
def test_logd_flap_and_crash_drills():
    for name in ("logd_flap", "ckpt_race", "agent_kill"):
        res = _run(name)
        assert res["findings"] == [], (name, res["findings"])


# ---- the port harness's own paths ----------------------------------------

class _Publisher:
    """A publisher whose in-flight windows at ``late`` fail to land, which
    shows only once it is flushed."""

    def __init__(self, late):
        self.late, self.hole = list(late), None

    def take_failed_epoch(self):
        return self.hole

    def flush(self, timeout=30.0):
        if self.hole is None and self.late:
            self.hole = self.late.pop(0)
        return True


class _Sched:
    """Plans 2 s a step from its cursor; a step below which a publish
    hole lies rewinds there first and clears it, as the service does."""

    def __init__(self, late):
        self.publisher = _Publisher(late)
        self._next_epoch = None
        self.steps = []

    def step(self, now):
        self.steps.append(now)
        start = self._next_epoch or now
        if self.publisher.hole is not None and self.publisher.hole < start:
            start, self.publisher.hole = self.publisher.hole, None
        self._next_epoch = start + 2


class _StubFleet:
    """The drive loop of ``bench_chaos.Fleet`` over stub schedulers."""
    drive = port_chaos.Fleet.drive
    publish_hole = port_chaos.Fleet.publish_hole
    partitions, step_errors = 1, 0

    def __init__(self, sched):
        self.sched = sched

    def live_scheds(self):
        return [self.sched]

    def live_agents(self):
        return []

    def keepalive_agents(self):
        pass

    def quiesce_publishers(self, timeout=30.0):
        self.sched.publisher.flush(timeout)


def test_drive_goes_on_from_a_publish_hole_left_past_the_end():
    """A window that fails to land after the cursor passed ``end`` is
    re-planned: the drive steps again from the hole, through ``end``."""
    sched = _Sched(late=[103])
    end = _StubFleet(sched).drive(100, 106)
    assert sched.steps == [100, 102, 104, 103, 105]
    assert end == 107
    assert sched.publisher.take_failed_epoch() is None


def test_drive_gives_up_on_a_hole_that_never_closes():
    sched = _Sched(late=[101] * 10_000)
    sched.step = lambda now: setattr(sched, "_next_epoch", now + 2)
    with pytest.raises(RuntimeError, match="publish hole at epoch 101"):
        _StubFleet(sched).drive(100, 104, stall_timeout=0.3)


@pytest.mark.chaos
def test_a_killed_schedulers_threads_and_tensors_go_with_its_fleet(
        monkeypatch):
    """kill_sched only closes the dead service's sockets; close() stops
    its threads too, so nothing holds it (or its planner's tensors)."""
    import gc
    import weakref
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    with time_limit(90, "kill and close"):
        fl = port_chaos.Fleet(seed=3, n_jobs=4, n_agents=1, n_scheds=2,
                              device="cpu")
        try:
            fl.put_jobs()
            fl.drive(port_chaos.T0, port_chaos.T0 + 2)
            fl.quiesce_publishers()
            leader = next(s for s in fl.scheds if s.is_leader)
            fl.kill_sched(leader)
            refs = [weakref.ref(s) for s in fl.scheds]
            planner = weakref.ref(leader.planner)
            del leader
        finally:
            fl.close()
        del fl
        gc.collect()
    assert [r() for r in refs] == [None, None]
    assert planner() is None


@pytest.mark.chaos
def test_a_killed_agents_threads_stop_with_its_fleet(monkeypatch):
    """kill_agent only closes the dead agent's clients; close() stops its
    threads too, so no flusher of it retries through later runs: no
    thread the fleet started outlives it (a grace for pool workers that
    exit on their own)."""
    import threading
    import time
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    before = set(threading.enumerate())
    with time_limit(90, "agent kill and close"):
        fl = port_chaos.Fleet(seed=3, n_jobs=4, n_agents=2, device="cpu")
        try:
            fl.put_jobs()
            fl.drive(port_chaos.T0, port_chaos.T0 + 2)
            victim = fl.agents[0]
            victim._ack("probe")          # starts its ack flusher
            fl.kill_agent(victim)
            fl.drive(port_chaos.T0 + 2, port_chaos.T0 + 4)
        finally:
            fl.close()
        deadline = time.monotonic() + 30
        while True:
            left = sorted(t.name for t in threading.enumerate()
                          if t not in before and t.is_alive())
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    assert victim._stop.is_set()
    assert left == []


