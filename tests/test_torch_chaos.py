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




class _StuckPublisher:
    """A publisher whose flush never lands: ``inflight`` windows still
    out, or (none in flight) its high-water mark behind."""

    _thread = _hwm_thread = _barrier_thread = None
    _pools = ()

    def __init__(self, inflight, hwm_done=5, hwm_want=5):
        self.inflight = inflight
        self._hwm_done, self._hwm_want = hwm_done, hwm_want

    def flush(self, timeout=30.0):
        return (not self.inflight) and self._hwm_done >= self._hwm_want


class _StuckBuilder:
    def __init__(self, lands):
        self.lands = lands

    def flush(self, timeout=120.0):
        return self.lands


def test_quiesce_reports_each_publisher_whose_flush_timed_out():
    """quiesce_publishers names the schedulers whose flush returned False
    and the stage that had not landed, and keeps them in
    ``flush_timeouts``; a publisher that landed is not reported."""
    import types
    scheds = [types.SimpleNamespace(node_id=n, publisher=p, _builder=b)
              for n, p, b in (
                  ("landed", _StuckPublisher(0), _StuckBuilder(True)),
                  ("windows", _StuckPublisher(2), _StuckBuilder(True)),
                  ("hwm", _StuckPublisher(0, 7, 9), _StuckBuilder(True)),
                  ("build", _StuckPublisher(0), _StuckBuilder(False)))]
    fleet = types.SimpleNamespace(flush_timeouts=[],
                                  live_scheds=lambda: scheds)
    out = port_chaos.Fleet.quiesce_publishers(fleet, timeout=0.1)
    assert [(d["sched"], d["stage"]) for d in out] == [
        ("windows", "windows"), ("hwm", "hwm"), ("build", "build")]
    assert out[1]["hwm_done"] == 7 and out[1]["hwm_want"] == 9
    assert out[0]["inflight"] == 2
    assert fleet.flush_timeouts == out
    assert all(d["stacks"] == {} for d in out)     # no thread to show


def test_a_stuck_publishers_threads_are_shown_where_they_wait():
    """A real publisher held in its store call: the report's stacks show
    its lane worker inside that call."""
    import threading
    from cronsun_tpu_torch.sched.publisher import OrderPublisher
    release = threading.Event()

    class Held:
        def put_many(self, items, lease=0):
            release.wait(30)
    pub = OrderPublisher([Held()], advance_hwm=lambda v: None)
    try:
        pub.submit([(100, [("/k", "v")])], lease=0, hwm=101)
        assert not pub.flush(timeout=0.3)
        stacks = port_chaos._publisher_stacks(pub)
        assert any("put_many" in fr for fr in stacks["pub0_0"])
        assert "hwm-advance" in stacks and "order-publisher" in stacks
    finally:
        release.set()
        pub.stop(timeout=10)


def test_drive_clocks_the_end_apart_from_its_trailing_quiesce():
    """The drive's ``end_passed_at`` is when its cursor passed ``end``
    (where the JAX harness's drive returns); the quiesce after it is
    ``quiesce_s``."""
    import time

    class SlowFlush(_StubFleet):
        def quiesce_publishers(self, timeout=30.0):
            time.sleep(0.3)
    sched = _Sched(late=[])
    fleet = SlowFlush(sched)
    t0 = time.monotonic()
    fleet.drive(100, 104)
    assert fleet.end_passed_at - t0 < 0.2
    assert 0.3 <= fleet.quiesce_s < 1.0


class _Gate:
    """Holds calls of ``fn`` until :meth:`open`; ``entered`` is set once
    one is held."""

    def __init__(self, fn):
        import threading
        self.fn, self.entered = fn, threading.Event()
        self._open = threading.Event()

    def __call__(self, *a, **kw):
        self.entered.set()
        self._open.wait(60)
        return self.fn(*a, **kw)

    def open(self):
        self._open.set()


class _GatedLane:
    def __init__(self, conn, gate):
        self._conn, self.put_many = conn, gate

    def __getattr__(self, name):
        return getattr(self._conn, name)


@pytest.mark.chaos
def test_publisher_lands_its_window_and_mark_after_a_replica_leader_kill(
        monkeypatch):
    """The replica leader is killed while one window's orders and the
    previous window's high-water mark are on their way to it (both held
    at the publisher's store calls until the kill): the scheduler's
    publisher must land both on the promoted leader, its flush returning
    within the replica drill's bound (``promote_after * 3 + 10``), and
    the drive must pass its end with no flush timing out."""
    import time
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    promote_after = 1.5
    bound = promote_after * 3 + 10
    with time_limit(150, "replica leader kill with a window in flight"):
        fl = port_chaos.Fleet(seed=43, n_jobs=8, n_agents=2, lease_ttl=2.0,
                              repl="quorum", repl_members=3,
                              promote_after=promote_after, device="cpu")
        try:
            fl.put_jobs()
            t = fl.drive(port_chaos.T0, port_chaos.T0 + 3)
            assert fl.quiesce_publishers() == []
            sc = next(s for s in fl.scheds if s.is_leader)
            pub = sc.publisher
            hwm = _Gate(pub._advance_hwm)
            pub._advance_hwm = hwm           # the next mark is held
            sc.step(now=t)
            t = sc._next_epoch
            assert hwm.entered.wait(30), "no high-water mark was written"
            lane = _Gate(pub._lane_conns[0].put_many)
            pub._lane_conns = [_GatedLane(c, lane)
                               for c in pub._lane_conns]
            sc.step(now=t)                  # the next window's orders
            t = sc._next_epoch
            assert lane.entered.wait(30), "no window was published"
            assert pub.inflight > 0 and pub._hwm_done < pub._hwm_want
            t_kill = time.monotonic()
            fl.kill_store_leader()
            lane.open()
            hwm.open()
            landed = pub.flush(timeout=bound)
            flush_s = time.monotonic() - t_kill
            end = fl.drive(t, t + 4, stall_timeout=90.0)
            recovery_s = fl.end_passed_at - t_kill
            timeouts = fl.quiesce_publishers(timeout=bound)
        finally:
            fl.close()
    assert landed and flush_s <= bound, (
        f"flush landed={landed} after {flush_s:.1f}s "
        f"(inflight {pub.inflight}, hwm {pub._hwm_done} of "
        f"{pub._hwm_want})")
    assert fl.flush_timeouts == [] and timeouts == []
    assert recovery_s <= bound and end >= t + 4
    assert pub._hwm_done >= pub._hwm_want
