"""The hand-written CUDA kernels against their plain versions, and the planner
(disarmed and with both arms armed), batched next-fire and the scheduler
service on the card against the same on the CPU.  Needs an NVIDIA GPU (the
kernels have no CPU mode); without one every test here skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import datetime as dt
import subprocess
import sys
from pathlib import Path
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import kernels as k
from cronsun_tpu_torch.ops import next_fire, tick
from cronsun_tpu_torch.ops.schedule_table import build_table
from cronsun_tpu_torch.synth import (arm_mixed, bench_mixed_specs,
                                     completions, seed_service_store,
                                     synth_state)
from test_torch_service_lock import check_windows_see_writes_whole

pytestmark = pytest.mark.cuda

T0 = 1_753_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tile(dev, K, w32, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-2**31, 2**31, (K, w32), dtype=torch.int32,
                           device=dev, generator=g)
    packed[::5] = 0
    packed[1::7] &= 0x10001
    load = torch.randint(0, 3, (w32 * 32,), device=dev, generator=g).float()
    load[::11] = float("inf")
    return packed, load


# w32 = 400 puts load_eff past 48 KB of shared memory: the __ldg variant
@pytest.mark.parametrize("K,w32", [(1, 1), (33, 5), (1000, 320), (300, 400)])
def test_bid_kernel_matches_plain(cuda, K, w32):
    packed, load = _tile(cuda, K, w32, K + w32)
    best, choice = k.bid_argmin(packed, load)
    best_p, choice_p = k.bid_argmin_plain(packed, load)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)


@pytest.mark.parametrize("K,w32", [(1, 1), (129, 7), (5000, 320), (300, 3200)])
def test_fanout_kernel_matches_plain(cuda, K, w32):
    packed, _ = _tile(cuda, K, w32, K * w32)
    w = torch.randint(0, 5, (K,), device=cuda).float()
    assert torch.equal(k.fanout_add(packed, w), k.fanout_add_plain(packed, w))
    wf = torch.rand(K, device=cuda)
    torch.testing.assert_close(k.fanout_add(packed, wf),
                               k.fanout_add_plain(packed, wf),
                               rtol=1e-5, atol=1e-5)
    # deterministic: no atomics, same bits every run
    assert torch.equal(k.fanout_add(packed, wf), k.fanout_add(packed, wf))


def _bucket(dev, K, J, seed, prefix=False):
    """Row indices with repeats and row 0 as padding, and an active mask
    (random, or a prefix, as the planner's valid mask is)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, J, (K,), dtype=torch.int32, device=dev,
                         generator=g)
    rows[K // 2:] = 0                                     # padded slots
    rows[1:K // 4:3] = rows[0]                            # repeats
    if prefix:
        active = torch.arange(K, device=dev) < (K * 5) // 8
    else:
        active = torch.rand(K, device=dev, generator=g) < 0.6
    return rows, active


# w32: 5 and 7 take the direct-load path (rows not 16-byte aligned), 320 the
# headline width, 400 one shared-memory tile past 48 KB, 3200 node tiling
@pytest.mark.parametrize("K,J,w32", [(1, 7, 5), (37, 64, 7), (999, 2000, 320),
                                     (257, 300, 400), (65, 90, 3200)])
@pytest.mark.parametrize("prefix", [False, True])
def test_bid_kernel_rows_active_match_plain(cuda, K, J, w32, prefix):
    table, load = _tile(cuda, J, w32, K + w32)
    rows, active = _bucket(cuda, K, J, K * w32, prefix)
    best, choice = k.bid_argmin(table, load, rows=rows, active=active)
    best_p, choice_p = k.bid_argmin_plain(table, load, rows, active)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)
    assert torch.isinf(best[~active]).all() and (choice[~active] == 0).all()
    # without rows and active: the TPU kernel's function on every row
    best, choice = k.bid_argmin(table, load)
    best_p, choice_p = k.bid_argmin_plain(table, load)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)


@pytest.mark.parametrize("w32", [5, 320, 3200])
def test_bid_kernel_all_closed_and_tie_heavy(cuda, w32):
    table, load = _tile(cuda, 129, w32, w32)
    closed = torch.full_like(load, float("inf"))
    best, choice = k.bid_argmin(table, closed)
    assert torch.isinf(best).all() and (choice == 0).all()
    flat = torch.zeros_like(load)                # every score a tie on load
    assert all(torch.equal(a, b) for a, b in zip(
        k.bid_argmin(table, flat), k.bid_argmin_plain(table, flat)))


@pytest.mark.parametrize("w32", [40, 320, 3200])
def test_bid_kernel_winner_within_one_unit(cuda, w32):
    """Sparse rows over loads of 0.75 with one word of 0: the candidate
    masks keep every bit that can still win."""
    table, _ = _tile(cuda, 257, w32, w32 + 1)
    g = torch.Generator(device=cuda).manual_seed(w32)
    for _ in range(4):
        table &= torch.randint(-2**31, 2**31, table.shape, dtype=torch.int32,
                               device=cuda, generator=g)
    load = torch.full((w32 * 32,), 0.75, device=cuda)
    load[:32] = 0.0
    assert all(torch.equal(a, b) for a, b in zip(
        k.bid_argmin(table, load), k.bid_argmin_plain(table, load)))


@pytest.mark.parametrize("K,J,w32", [(1, 3, 5), (129, 200, 7),
                                     (5001, 6000, 320), (301, 400, 3200)])
def test_fanout_kernel_rows_match_plain(cuda, K, J, w32):
    table, _ = _tile(cuda, J, w32, K + J)
    rows, active = _bucket(cuda, K, J, K)
    w = torch.randint(0, 5, (K,), device=cuda).float() * active
    assert torch.equal(k.fanout_add(table, w, rows=rows),
                       k.fanout_add_plain(table, w, rows))
    wf = torch.rand(K, device=cuda) * active
    got = k.fanout_add(table, wf, rows=rows)
    torch.testing.assert_close(got, k.fanout_add_plain(table, wf, rows),
                               rtol=1e-5, atol=1e-5)
    # one launch, no atomics on floats: the same bits every call
    assert torch.equal(got, k.fanout_add(table, wf, rows=rows))


_OUT_OF_RANGE = """
import os, torch
from cronsun_tpu_torch.ops import kernels as k
table = torch.zeros((64, 8), dtype=torch.int32, device="cuda")
rows = torch.tensor([0, {bad}, 1] * 40, dtype=torch.int32, device="cuda")
try:
    if "{name}" == "bid_argmin":
        k.bid_argmin(table, torch.zeros(256, device="cuda"), rows=rows)
    else:
        k.fanout_add(table, torch.ones(120, device="cuda"), rows=rows)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", type(e).__name__, str(e).splitlines()[0], flush=True)
    os._exit(0)
os._exit(3)
"""


@pytest.mark.parametrize("name", ["bid_argmin", "fanout_add"])
@pytest.mark.parametrize("bad", [-1, 64])
def test_kernel_stops_on_a_row_outside_the_table(cuda, name, bad):
    """A row index outside [0, J) stops the kernel, which leaves the CUDA
    context unusable, so each case runs in a process of its own."""
    r = subprocess.run([sys.executable, "-c",
                        _OUT_OF_RANGE.format(name=name, bad=bad)],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "stopped:" in r.stdout, (r.stdout, r.stderr)


def test_wrappers_count_kernel_launches(cuda):
    k.reset_launch_counts()
    packed, load = _tile(cuda, 64, 2, 0)
    k.bid_argmin(packed, load)
    k.bid_argmin_natural(packed, load, 32)
    k.fanout_add(packed, torch.ones(64, device=cuda))
    k.fanout_add(packed, torch.ones(64, device=cuda))
    assert k.launch_counts() == {"bid_argmin": 1, "bid_argmin_natural": 1,
                                 "fanout_add": 2}
    with pytest.raises(ValueError):
        k.bid_argmin(packed[:, :1], load[:32].clone())   # not contiguous


def test_planner_on_the_card_matches_the_cpu(cuda):
    state = synth_state(8192, 320, seed=3, node_cap=3, empty_rows=0.05)
    gpu = planner_from_numpy(state, device=cuda, max_fire_bucket=2048)
    cpu = planner_from_numpy(state, device="cpu", max_fire_bucket=2048)
    for i in range(3):
        a = gpu.plan_window(T0 + 4 * i, 4)
        b = cpu.plan_window(T0 + 4 * i, 4)
        for x, y in zip(a, b):
            assert np.array_equal(x.fired, y.fired)
            assert np.array_equal(x.assigned, y.assigned)
            assert (x.overflow, x.total_fired, x.n_excl) == \
                (y.overflow, y.total_fired, y.n_excl)
    assert torch.equal(gpu.load.cpu(), cpu.load)
    assert torch.equal(gpu.rem_cap.cpu(), cpu.rem_cap)


def test_armed_planner_on_the_card_matches_the_cpu(cuda):
    """Both arms armed (a 3-stage DAG with every policy, Zipf tenants, a
    noisy one, one slot per node so the fair share clamps), completions
    folded between windows: every TickPlan field and the carried state
    equal."""
    J, N = 8192, 320
    state = synth_state(J, N, seed=4, node_cap=1, empty_rows=0.05)
    stages = arm_mixed(state, seed=5, n_dep=600, n_noisy=200,
                       start_epoch_s=T0)
    ups = np.zeros(J, bool)
    ups[stages["sources"]] = ups[stages["mids"]] = True
    gpu = planner_from_numpy(state, device=cuda, max_fire_bucket=2048)
    cpu = planner_from_numpy(state, device="cpu", max_fire_bucket=2048)
    rng = np.random.default_rng(6)
    refused = 0
    for i in range(4):
        for p in (gpu, cpu):
            p.set_node_capacity(list(range(N)), [1] * N)
        a = gpu.plan_window(T0 + 4 * i, 4)
        b = cpu.plan_window(T0 + 4 * i, 4)
        for x, y in zip(a, b):
            for f in dataclasses.fields(x):
                assert np.array_equal(getattr(x, f.name),
                                      getattr(y, f.name)), f.name
            refused += int(x.tenant_throttled.sum())
        rows, succ, fail = completions(a, ups, rng)
        for p in (gpu, cpu):
            p.set_dep_epochs(rows, succ, fail)
    assert refused
    for name in ("load", "rem_cap", "dep_last_fire", "tb_tokens"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name


NY = ZoneInfo("America/New_York")


@pytest.mark.parametrize("tz", [dt.timezone.utc, NY], ids=["utc", "new_york"])
def test_next_fire_on_the_card_matches_the_cpu(cuda, tz, monkeypatch):
    """The bench's mixed specs plus sparse and never-firing ones, around a
    DST change, in several row passes and past the day window's horizon."""
    specs = bench_mixed_specs(1500) + ["0 30 2 * * *", "0 30 1 ? * Sun",
                                       "0 0 0 29 2 ?", "0 0 0 30 2 ?",
                                       "0 0 12 13 * Fri"]
    cpu = build_table(specs, phase_epoch_s=T0, device="cpu")
    gpu = build_table(specs, phase_epoch_s=T0, device=cuda)
    monkeypatch.setattr(tick, "NEXT_FIRE_CHUNK", 512)
    for after in (T0, int(dt.datetime(2025, 10, 30, 12, tzinfo=NY).timestamp()),
                  int(dt.datetime(2026, 3, 6, 3, tzinfo=NY).timestamp())):
        got = next_fire(gpu, after, tz=tz)
        assert np.array_equal(got, next_fire(cpu, after, tz=tz))
        assert (got[:1500] >= 0).all()
    long = dict(tz=tz, horizon_s=10 * 366 * 86400)
    assert np.array_equal(next_fire(gpu, T0, **long),
                          next_fire(cpu, T0, **long))


def test_service_on_the_card_matches_the_cpu(cuda):
    """The port's service on the card publishes the orders the same
    service publishes on the CPU (which tests/test_torch_service.py holds
    to the JAX package's), and its steps launch both kernels."""
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.sched import SchedulerService
    from cronsun_tpu_torch.store import MemStore
    ks = Keyspace()
    out = []
    for dev in (cuda, "cpu"):
        store = MemStore()
        seed_service_store(store, ks, 1500, 48, T0)
        svc = SchedulerService(store, ks, job_capacity=2048, node_capacity=64,
                               window_s=4, dispatch_ttl=3600.0,
                               clock=lambda: float(T0), device=dev)
        k.reset_launch_counts()
        try:
            t = T0
            for _ in range(8):
                svc.step(now=t)
                # the next window's dispatch lands before the next reconcile
                svc._resolve_handle(svc._pending_plan[1])
                t = svc._next_epoch
        finally:
            svc.stop()
        out.append((sorted((kv.key, kv.value)
                           for kv in store.get_prefix(ks.dispatch)),
                    store.get(ks.hwm).value, k.launch_counts()))
    assert out[0][0] and out[0][:2] == out[1][:2]
    assert out[0][2]["bid_argmin"] and out[0][2]["fanout_add"]


def test_planner_writes_land_whole_on_the_card(cuda):
    check_windows_see_writes_whole(cuda)


def test_entry_on_the_card_matches_the_cpu(cuda):
    from cronsun_tpu_torch import entry
    k.reset_launch_counts()
    fn, args = entry.entry()
    got = [t.cpu() for t in fn(*args)]
    counts = k.launch_counts()
    assert counts["bid_argmin"] and counts["fanout_add"]
    fn, args = entry.entry(device="cpu")
    for g, w in zip(got, fn(*args)):
        assert torch.equal(g, w)


def test_launcher_on_the_card_publishes_and_exits_clean(cuda, tmp_path):
    """``python -m cronsun_tpu_torch.bin.sched`` with no ``--device`` runs on
    the card: READY, orders published through the TCP store, exit 0 on
    SIGTERM with both kernels' launch counts logged above zero."""
    import json
    import os
    import signal
    import time
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.store import MemStore, StoreServer
    ks = Keyspace()
    store = MemStore()
    seed_service_store(store, ks, 1500, 48, int(time.time()))
    server = StoreServer(store).start()
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"window_s": 2, "job_capacity": 2048,
                                "node_capacity": 64,
                                "log_db": str(tmp_path / "unused.db")}))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    p = subprocess.Popen(
        [sys.executable, "-m", "cronsun_tpu_torch.bin.sched", "--store",
         f"{server.host}:{server.port}", "--conf", str(conf)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in p.stdout:
            lines.append(line)
            if line.startswith("READY"):
                break
        assert lines and lines[-1].startswith("READY"), "".join(lines)
        deadline = time.time() + 60
        while not store.get_prefix(ks.dispatch):
            assert time.time() < deadline, "no orders published"
            time.sleep(0.2)
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=60)
        assert p.returncode == 0, "".join(lines) + rest
        counts = [ln for ln in rest.splitlines()
                  if "kernel launch counts:" in ln]
        assert counts, rest
        launches = json.loads(counts[-1].split("kernel launch counts:", 1)[1])
        assert launches["bid_argmin"] > 0 and launches["fanout_add"] > 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        server.stop()


def test_profile_server_on_the_card_records_both_kernels(cuda):
    """A capture of ``ProfileServer(0, "cuda")`` while a worker thread plans
    card windows holds both kernels' device events and the planner's
    ranges on the worker's thread; the plans equal the CPU planner's."""
    import threading
    import time
    from torch.autograd import profiler as autograd_profiler
    from cronsun_tpu_torch.profile_server import ProfileServer
    from cronsun_tpu_torch.scripts.profile_sched import (capture_summary,
                                                         fetch_capture)
    from cronsun_tpu_torch.ops import _build
    _build.build()      # not inside the capture, as the launcher does
    state = synth_state(8192, 320, seed=3, node_cap=3, empty_rows=0.05)
    gpu = planner_from_numpy(state, device=cuda, max_fire_bucket=2048)
    cpu = planner_from_numpy(state, device="cpu", max_fire_bucket=2048)
    plans, failed = [], []

    def plan():
        try:
            deadline = time.monotonic() + 60
            while not autograd_profiler._is_profiler_enabled:
                assert time.monotonic() < deadline, "no capture began"
                time.sleep(0.001)
            for i in range(3):
                plans.append(gpu.gather_window(
                    gpu.plan_window_async(T0 + 4 * i, 4)))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)
    srv = ProfileServer(0, cuda)
    worker = threading.Thread(target=plan)
    try:
        worker.start()
        events, info = fetch_capture("127.0.0.1", srv.port, 3000)
        worker.join(60)
    finally:
        srv.stop()
    assert not worker.is_alive() and not failed, failed
    kernels = {e.key for e in events if e.cat == "kernel"}
    for name in ("bid_argmin_kernel", "fanout_add_kernel"):
        assert any(name in k for k in kernels), kernels
    threads = capture_summary(events, 3000)["range_threads"]
    for name in ("cronsun.plan.dispatch", "cronsun.fire_mask",
                 "cronsun.assign"):
        assert threads.get(name) == [worker.native_id], threads
    for i in range(3):
        for x, y in zip(plans[i], cpu.plan_window(T0 + 4 * i, 4)):
            assert np.array_equal(x.fired, y.fired)
            assert np.array_equal(x.assigned, y.assigned)


def test_a_fleet_of_port_processes_runs_its_scheduler_on_the_card(
        cuda, tmp_path):
    """Store, two-shard logd, scheduler (no ``--device``: the card), an
    agent and the web, all ``cronsun_tpu_torch.bin.*``: a job made through
    the REST API runs and lands in the sharded sink, only the scheduler
    holds the card's device file open, and SIGTERM stops every process
    with exit 0, the scheduler logging both kernels' launches."""
    import json
    from chip_smoke import card_device_files
    from torch_fleet import Fleet, WebClient, wait_for

    f = Fleet(tmp_path, dict(store="port", logd="port", sched="port",
                             node="port", web="port"),
              job_capacity=2048, node_capacity=64)
    try:
        sched = f.sched(device=None)
        node = f.node("card-node")
        web = f.web()
        sched.ready(timeout=300)
        node.ready()
        client = WebClient(web.ready())
        client.call("PUT", "/v1/job", {
            "id": "card-job", "name": "card-job", "command": "echo ok",
            "kind": 2, "group": "default",
            "rules": [{"timer": "* * * * * *", "nids": ["card-node"]}]})
        wait_for(lambda: client.call("GET", "/v1/logs")["total"] >= 3,
                 60, "executions in the result store")
        holders = [p.mod for p in f.procs if card_device_files(p.p.pid)]
        assert holders == ["cronsun_tpu_torch.bin.sched"], holders
        assert sched.stop() == 0
        counts = [ln for ln in sched.lines if "kernel launch counts:" in ln]
        assert counts, sched.output()
        launches = json.loads(counts[-1].split("kernel launch counts:", 1)[1])
        assert launches["bid_argmin"] > 0 and launches["fanout_add"] > 0
    finally:
        rcs = f.stop_all()
    assert all(rc == 0 for _m, rc in rcs), rcs


@pytest.mark.parametrize("K,w32,col0", [(1, 1, 0), (33, 5, 32), (1000, 160, 5120),
                                        (300, 400, 96)])
def test_k1n_kernel_matches_plain(cuda, K, w32, col0):
    packed, load = _tile(cuda, K, w32, K + w32 + col0)
    for ld in (load, torch.zeros_like(load)):          # ties decide too
        best, choice = k.bid_argmin_natural(packed, ld, col0)
        best_p, choice_p = k.bid_argmin_natural_plain(packed, ld, col0)
        assert torch.equal(choice, choice_p) and torch.equal(best, best_p)
    rows = torch.randint(0, K, (2 * K,), dtype=torch.int32, device=cuda)
    active = torch.rand(2 * K, device=cuda) < 0.5
    got = k.bid_argmin_natural(packed, load, col0, rows=rows, active=active)
    ref = k.bid_argmin_natural_plain(packed, load, col0, rows, active)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_mesh_planner_on_the_card_matches_the_cpu(cuda, kind):
    """Mesh planners with their shards sharing the card against the same
    planners on the CPU: every plan field, load and rem_cap identical."""
    from cronsun_tpu_torch.convert import install_mesh_state
    from cronsun_tpu_torch.parallel import mesh as pm
    state = synth_state(16384, 512, seed=5, node_cap=3)
    shape = (2,) if kind == "1d" else (2, 2)
    cls = pm.ShardedTickPlanner if kind == "1d" else pm.Sharded2DTickPlanner
    planners = []
    for d in (cuda, torch.device("cpu")):
        grid = np.array([d] * int(np.prod(shape)), dtype=object).reshape(shape)
        p = cls(pm.Mesh(grid), 16384, 512, max_fire_bucket=4096)
        install_mesh_state(p, state)
        planners.append(p)
    k.reset_launch_counts()
    got = planners[0].plan_window(T0, 4) + [planners[0].plan(T0 + 4)]
    ref = planners[1].plan_window(T0, 4) + [planners[1].plan(T0 + 4)]
    for a, b in zip(ref, got):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (np.array_equal(x, y) if isinstance(x, np.ndarray)
                    else x == y), f.name
    assert torch.equal(planners[0].load.cpu(), planners[1].load)
    assert torch.equal(planners[0].rem_cap.cpu(), planners[1].rem_cap)
    counts = k.launch_counts()
    bid = "bid_argmin" if kind == "1d" else "bid_argmin_natural"
    assert counts[bid] > 0 and counts["fanout_add"] > 0


@pytest.mark.parametrize("T", [16, 64, 4096])
def test_fair_shares_non_dyadic_weights_on_the_card_match_the_cpu(cuda, T):
    """The device waterfill on the card against the same on the CPU with
    weights that are not dyadic (uniform f32 draws, and the JAX test's
    two-decimal ones), where partial sums round: the shares must be equal."""
    from cronsun_tpu_torch.ops.tenancy import fair_shares
    rng = np.random.default_rng(17 + T)
    for i in range(300):
        d = rng.integers(0, 40, T)
        w = (rng.uniform(0.05, 7.0, T) if i % 2
             else rng.uniform(0.25, 4.0, T).round(2)).astype(np.float32)
        cap = float(rng.integers(0, 20 * T))
        got, ref = (fair_shares(torch.as_tensor(d, dtype=torch.int32,
                                                device=dev),
                                torch.as_tensor(w, device=dev),
                                torch.tensor(cap, device=dev)).cpu()
                    for dev in (cuda, torch.device("cpu")))
        assert torch.equal(got, ref), (i, d, w, cap)


def test_smoke_drill_on_the_card_launches_k1_with_no_finding(cuda,
                                                             monkeypatch):
    """``bench_chaos``'s smoke drill with its schedulers on the card: no
    invariant finding, the faults injected, and the exclusive bid kernel
    launched by the drill's planners."""
    from cronsun_tpu_torch.scripts import bench_chaos
    monkeypatch.setenv("CRONSUN_CHAOS", "1")
    bench_chaos.warm_device(cuda)
    k.reset_launch_counts()
    res = bench_chaos.drill_smoke(seed=5, on_log=lambda *a: None,
                                  device=cuda)
    counts = k.launch_counts()
    assert res["findings"] == [], res["findings"]
    assert res["info"]["schedule_deterministic"]
    assert res["info"]["executions"] > 0
    assert res["info"]["injected"]["store.rpc:reply_lost"] > 0
    assert counts["bid_argmin"] > 0 and counts["fanout_add"] > 0, counts


def test_trace_bench_on_the_card_at_the_tier1_size(cuda):
    """``run_trace_bench`` at ``tests/test_bench_smoke.py``'s tier-1 size
    with the scheduler on the card: every wire stage of the waterfall,
    both overhead arms, both kernels launched."""
    from cronsun_tpu_torch.scripts import bench_sched
    k.reset_launch_counts()
    res = bench_sched.run_trace_bench(
        n_jobs=800, n_nodes=32, steps=4, window_s=2, traced_jobs=12,
        seconds=4, on_log=lambda *a: None, device=cuda)
    counts = k.launch_counts()
    assert res["trace_stage_fires"] > 0
    for st in ("publish", "claim", "queue", "run", "record"):
        assert res["trace_stage_p99_ms"][st] >= 0.0, st
    assert res["trace_overhead_on_p99_ms"] > 0
    assert res["trace_overhead_off_p99_ms"] > 0
    assert counts["bid_argmin"] > 0 and counts["fanout_add"] > 0, counts


def test_the_port_bench_cells_on_the_card(cuda):
    """``cronsun_tpu_torch.scripts.bench``'s in-process cells at a small
    size on the card: the kernels equal plain at the bench's kernel shape
    and at the small one, every cell has its keys, and both kernels
    launched on the planner path."""
    from cronsun_tpu_torch.scripts import bench
    rng = np.random.default_rng(0)
    eq, _ = bench.kernel_inputs(rng, False, cuda)
    assert [bench.kernels_equal(*t[1:]) for t in eq] == [True, True]
    small = bench.Shapes(
        k_eq=256, n_eq=1024, n_wide=2048, c2_specs=1000,
        ladders=(("c3_10kx1k", 2000, 256, 0.5, 1 << 20, 2048),
                 ("c4_100kx1k", 4000, 256, 0.2, 64, 4096),
                 ("c5_1Mx10k", 16384, 1024, 0.02, 1 << 20, 4096)),
        headline_jobs=16384, headline_nodes=1024, headline_bucket=4096,
        sla=(2048, 2048))
    k.reset_launch_counts()
    detail, p99 = bench.run_cells(True, cuda, small)
    counts = k.launch_counts()
    assert detail["kernels_equal"] is True and p99 > 0
    assert detail["kernel_bid_pallas_ms"] > 0
    assert detail["kernel_fanout_pallas_ms"] > 0
    assert all(detail[f"{name}_fired_per_tick"] > 0
               for name, *_ in small.ladders)
    assert counts["bid_argmin"] > 0 and counts["fanout_add"] > 0, counts


def test_the_demo_runs_its_scheduler_on_the_card(cuda, tmp_path):
    """``cronsun_tpu_torch.demo`` with no ``--device`` plans on the card:
    its seeded jobs run (the Common one on both agents), only the demo's
    pid holds the card's device file, and SIGTERM ends it with exit 0 and
    the summary line."""
    import re
    import signal
    import socket
    import time
    from chip_smoke import Proc, WebClient, card_device_files, \
        check_demo_runs
    conf = tmp_path / "conf.json"
    conf.write_text('{"job_capacity": 2048, "node_capacity": 64, '
                    '"window_s": 2}')
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    demo = Proc("cronsun_tpu_torch.demo", "--nodes", "2", "--port",
                str(port), "--conf", str(conf))
    try:
        deadline = time.monotonic() + 300
        while not any("demo up" in ln for ln in demo.lines):
            demo.check_alive()
            assert time.monotonic() < deadline, demo.output()
            time.sleep(0.1)
        assert card_device_files(demo.p.pid)
        web = WebClient(f"127.0.0.1:{port}")
        kinds = {j["id"]: j["kind"] for j in web.call("GET", "/v1/jobs")}
        time.sleep(14)
        t_read = time.time()
        records = web.call("GET", "/v1/logs?pageSize=500")["list"]
        check_demo_runs(records, kinds, ["node-0", "node-1"], 5, t_read)
        assert demo.stop(signal.SIGTERM) == 0
        assert any(re.fullmatch(r"executed \d+ runs across 2 nodes\n", ln)
                   for ln in demo.lines), demo.output()
    finally:
        demo.stop(signal.SIGKILL, timeout=30)
