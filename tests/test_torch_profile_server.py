"""The port's profiler server (``cronsun_tpu_torch.profile_server``, the
scheduler's ``--profile-port``) on the CPU: a capture taken on the
server's thread holds the planner's ranges and Python frames from the
thread that plans, the plans planned under it equal the JAX planner's,
and every refusal answers its status.  Its client and trace splitter
(``scripts/profile_sched.py``) on known traces and on a scheduler
process.  The scheduler process serving a capture in a fleet is in
``test_torch_launcher_fleet.py``."""

import argparse
import gzip
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from cronsun_tpu.bin import sched as jax_sched
from cronsun_tpu_torch.bin import sched as port_sched
from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.profile_server import MAX_MS, ProfileServer
from cronsun_tpu_torch.scripts.profile_sched import (Event, capture_summary,
                                                     load_events, split)
from cronsun_tpu_torch.scripts.profile_sched import run as profile_sched_run
from cronsun_tpu_torch.synth import synth_state
from torch_parity import (assert_plans_equal, assert_state_equal,  # noqa: F401
                          jax_planner_from_state, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
T0 = 1_753_000_000
J, N, W, WINDOWS = 4096, 320, 2, 4


def get(port, query, timeout=120):
    """(status, headers, body) of ``GET query`` on the local server."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{query}",
                                    timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def trace_events(body) -> list:
    return json.loads(gzip.decompress(body))["traceEvents"]


def names_by_thread(events, cat) -> dict:
    """{name: {tid, ...}} of the trace's events of category ``cat``."""
    out = {}
    for e in events:
        if e.get("cat") == cat:
            out.setdefault(e["name"], set()).add(e["tid"])
    return out


@pytest.fixture
def server():
    srv = ProfileServer(0, "cpu")
    yield srv
    srv.stop()


@pytest.mark.parametrize("stack", [0, 1], ids=["ranges", "stacks"])
def test_capture_holds_the_planning_thread_and_plans_match_jax(server,
                                                               stack):
    """A worker thread plans ``WINDOWS`` windows once the capture is on;
    the capture, taken on the server's thread, names the planner's ranges
    (and with stack=1 its Python frames) on the worker's thread, and the
    plans equal the JAX planner's on the same seeded state."""
    state = synth_state(J, N, seed=11, empty_rows=0.05, node_cap=6)
    tp = planner_from_numpy(state, device="cpu")
    plans, failed = [], []

    def plan():
        try:
            deadline = time.monotonic() + 60
            while not autograd_profiler._is_profiler_enabled:
                assert time.monotonic() < deadline, "no capture began"
                time.sleep(0.001)
            for i in range(WINDOWS):
                tp.set_node_capacity(list(range(0, N, 3)),
                                     [5] * len(range(0, N, 3)))
                plans.append(tp.gather_window(
                    tp.plan_window_async(T0 + W * i, W)))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)
    worker = threading.Thread(target=plan, name="planner")
    worker.start()
    status, headers, body = get(server.port,
                                f"/capture?ms=3000&stack={stack}")
    worker.join(60)
    assert not worker.is_alive() and not failed, failed
    assert status == 200, body
    assert headers["Content-Type"] == "application/gzip"
    assert float(headers["X-Export-Seconds"]) >= 0
    server_tid = int(headers["X-Capture-Thread"])
    assert server_tid != worker.native_id
    events = trace_events(body)
    ranges = names_by_thread(events, "user_annotation")
    for name in ("cronsun.plan.dispatch", "cronsun.fire_mask",
                 "cronsun.assign", "cronsun.plan.gather"):
        # threads another test left running in this process may add theirs
        assert worker.native_id in ranges.get(name, ()), (name, ranges)
        assert server_tid not in ranges[name]
    frames = {n for n, tids in names_by_thread(
        events, "python_function").items() if worker.native_id in tids}
    if stack:
        assert any(n.endswith(": plan_window_async") for n in frames)
    else:
        assert not frames

    jp = jax_planner_from_state(state)
    for i in range(WINDOWS):
        jp.set_node_capacity(list(range(0, N, 3)), [5] * len(range(0, N, 3)))
        assert_plans_equal(jp.plan_window(T0 + W * i, W), plans[i])
    assert_state_equal(jp, tp)


@pytest.mark.parametrize("query,status", [
    ("/capture?ms=0", 400),
    (f"/capture?ms={MAX_MS + 1}", 400),
    ("/capture?ms=x", 400),
    ("/capture", 400),
    ("/capture?ms=10&stack=2", 400),
    ("/", 404),
    ("/trace?ms=10", 404),
])
def test_bad_requests(server, query, status):
    got, _, body = get(server.port, query)
    assert got == status, body


def test_a_second_capture_while_one_runs_is_409(server):
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=get(server.port, "/capture?ms=2000")))
    t.start()
    deadline = time.monotonic() + 30
    while not server._busy.locked():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    status, _, body = get(server.port, "/capture?ms=10")
    t.join(60)
    assert status == 409 and b"already running" in body, body
    assert first["r"][0] == 200


def test_a_capture_beside_another_profiler_is_409(server):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        status, _, body = get(server.port, "/capture?ms=10")
    assert status == 409 and b"another profiler" in body, body
    assert get(server.port, "/capture?ms=10")[0] == 200


def test_no_device_activity_on_the_card_is_500_not_a_cpu_trace():
    """A server for the card whose capture records no CUDA activity (here:
    a CPU-only build, as on a host without CUPTI) refuses to answer a
    CPU-only trace."""
    srv = ProfileServer(0, "cuda")
    try:
        status, headers, body = get(srv.port, "/capture?ms=50")
    finally:
        srv.stop()
    assert status == 500 and b"no CUDA activity" in body, body
    assert headers["Content-Type"] != "application/gzip"


def test_stop_ends_a_running_capture_and_leaves_no_thread():
    before = set(threading.enumerate())
    srv = ProfileServer(0, "cpu")
    got = {}
    t = threading.Thread(target=lambda: got.update(
        r=get(srv.port, "/capture?ms=60000")))
    t.start()
    deadline = time.monotonic() + 30
    while not srv._busy.locked():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 30
    t.join(30)
    assert not t.is_alive() and got["r"][0] == 503
    assert set(threading.enumerate()) <= before
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", srv.port), timeout=2)


def test_a_port_in_use_raises_and_the_scheduler_exits_naming_it(server):
    with pytest.raises(OSError):
        ProfileServer(server.port, "cpu")
    r = subprocess.run(
        [sys.executable, "-m", "cronsun_tpu_torch.bin.sched", "--store",
         "127.0.0.1:1", "--device", "cpu", "--profile-port",
         str(server.port)], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 1, r.stderr
    err = [ln for ln in r.stderr.splitlines() if ln.startswith("error:")]
    assert err == [f"error: --profile-port {server.port}: "
                   f"Address already in use"], r.stderr
    assert "READY" not in r.stdout


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser a launcher's ``main`` builds, taken at parse time."""
    class Got(Exception):
        pass

    def grab(self, *a, **kw):
        raise Got(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Got) as e:
        main([])
    return e.value.args[0]


def test_profile_port_flag_matches_the_jax_launcher(monkeypatch):
    def flag(main):
        ap = _parser(main, monkeypatch)
        return next(a for a in ap._actions
                    if "--profile-port" in a.option_strings)
    ref, got = flag(jax_sched.main), flag(port_sched.main)
    assert (got.dest, got.type, got.default, got.metavar) == \
        (ref.dest, ref.type, ref.default, ref.metavar) == \
        ("profile_port", int, 0, "PORT")


# ---- the client: scripts/profile_sched.py -----------------------------------

def test_load_events_reads_a_trace_across_chunk_seams(tmp_path):
    """A trace of ~12 MB (three of the reader's 4 MB chunks) comes back
    event for event, names keyed without lines and addresses."""
    import random
    rng = random.Random(5)
    events = [{"ph": "X", "cat": "python_function",
               "name": f"m.py({i}): f{i % 7}" + " " * rng.randrange(400),
               "pid": 1, "tid": 2, "ts": float(i), "dur": 1.0,
               "args": {"Python id": i, "Python parent id": i - 1}}
              for i in range(25_000)]
    events.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": 2})
    events.append({"ph": "X", "cat": "python_function", "pid": 1, "tid": 2,
                   "name": "<built-in method get of dict object at 0x7f0a>",
                   "ts": 0.0, "dur": 1.0, "args": {}})
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events,
                   "traceName": "t"}, f, indent=1)
    got = load_events(str(path))
    assert len(got) == 25_001
    assert [e.pyid for e in got[:-1]] == list(range(25_000))
    assert got[3].key.rstrip() == "m.py: f3" and got[3].parent == 2
    assert got[-1].key == "<built-in method get of dict object>"


def _ev(cat, key, ts, dur, pyid=None, parent=None, tid=1):
    return Event(cat, key, tid, ts, dur, pyid, parent)


def test_split_and_summary_of_a_known_trace():
    events = [
        _ev("python_function", "s.py: step", 0, 100, 1),
        _ev("python_function", "s.py: reconcile", 10, 60, 2, 1),
        _ev("python_function", "p.py: issuing", 20, 45, 3, 2),
        _ev("python_function", "s.py: drain", 75, 20, 4, 1),
        _ev("python_function", "s.py: step", 200, 50, 5),
        _ev("python_function", "s.py: reconcile", 210, 10, 6, 5),
        _ev("user_annotation", "cronsun.plan.dispatch", 0, 30, tid=7),
        _ev("user_annotation", "cronsun.plan.dispatch", 40, 10, tid=7),
        _ev("kernel", "k1", 0, 400),
        _ev("kernel", "k2", 300, 200),       # overlaps k1 by 100
        _ev("gpu_memcpy", "copy", 900, 100),
    ]
    s = split(events, "s.py: step", depth=2)
    assert (s["calls"], s["ms"], s["max_ms"], s["threads"]) == \
        (2, 0.15, 0.1, [1])
    assert s["self_ms"] == pytest.approx(0.06)
    rec = s["callees"]["s.py: reconcile"]
    assert (rec["calls"], rec["ms"], rec["self_ms"]) == \
        (2, 0.07, pytest.approx(0.025))
    assert rec["callees"]["p.py: issuing"]["ms"] == 0.045
    assert list(s["callees"]) == ["s.py: reconcile", "s.py: drain"]
    assert [c["at_ms"] for c in s["longest"]] == [0.0, 0.2]
    assert split(events, "nowhere") == {"calls": 0}

    summary = capture_summary(events, ms=1)
    assert summary["device_busy_share"] == pytest.approx(0.6)
    assert [o["name"] for o in summary["top_device_ops"]] == \
        ["k1", "k2", "copy"]
    assert summary["top_host_ranges"] == [
        {"name": "cronsun.plan.dispatch", "ms": 0.04, "calls": 2,
         "max_ms": 0.03}]
    assert summary["range_threads"] == {"cronsun.plan.dispatch": [7]}


def test_profile_sched_splits_a_scheduler_process_on_the_cpu():
    res = profile_sched_run(4000, 64, 2, 1, 2000, 5000, "cpu",
                            on_log=lambda *a: None, align=False)
    assert res["sched_rc"] == 0, res["sched_log_tail"]
    stacks = res["stacks"]
    assert stacks["gz_bytes"] > 0 and stacks["events"] > 0
    for label in ("step", "reconcile", "plan", "build"):
        assert stacks["split"][label]["calls"] >= 1, (label, stacks["split"])
    step = stacks["split"]["step"]
    assert "cronsun_tpu_torch/sched/service.py: reconcile_capacity" in \
        step["callees"]
    assert res["ranges"]["stack"] is False
    assert res["sched_snapshot"]["steps_total"] >= 1
