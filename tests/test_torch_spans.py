"""The planner's spans (``cronsun_tpu_torch.ops.spans``) on the CPU: they
nest, carry their window, stay in a bounded ring, enter no profiler range
with no profiler running, count the stream waits of a window, share the
profiler's clock, and reach the scheduler's ``/v1/metrics``."""

import json
import os
import queue
import statistics
import sys
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import spans
from cronsun_tpu_torch.synth import synth_state

T0 = 1_753_000_000
J, N = 2048, 128


@pytest.fixture(scope="module")
def state():
    return synth_state(J, N, seed=5, specs=None, node_cap=1 << 20)


def planner(state, **kw):
    return planner_from_numpy(state, device="cpu", max_fire_bucket=256, **kw)


def plan(p, n, W=8, start=T0):
    for i in range(n):
        p.gather_window(p.plan_window_async(start + W * i, W))


def by_name(sp, name):
    return [s for s in sp if s.name == name]


def test_spans_nest_under_their_parents_and_carry_their_window(state):
    p = planner(state, rounds=2)
    assert spans.newest() is p.spans
    plan(p, 2)
    ws = p.spans.windows()
    assert [w.id for w in ws] == [(p.spans.serial, T0), (p.spans.serial, T0 + 8)]
    assert all(w.seconds == 8 and not w.profiled for w in ws)
    sp = ws[0].spans()
    names = [s.name for s in sp]
    assert names[0] == "cronsun.plan.dispatch" and sp[0].parent == -1
    assert names[-1] == "cronsun.plan.gather" and sp[-1].parent == -1
    for i, s in enumerate(sp):
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = sp[s.parent]
            assert s.parent < i
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    want_parent = {"cronsun.fire_mask": "cronsun.plan.dispatch",
                   "cronsun.compact": "cronsun.plan.dispatch",
                   "cronsun.fanout": "cronsun.plan.dispatch",
                   "cronsun.assign": "cronsun.plan.dispatch",
                   "cronsun.assign.bid": "cronsun.assign",
                   "cronsun.assign.accept": "cronsun.assign"}
    for child, parent in want_parent.items():
        got = {sp[s.parent].name for s in by_name(sp, child)}
        assert got == {parent}, (child, got)
    # the window's upload waits under the dispatch; each round's three
    # selections under its accept
    assert [sp[s.parent].name for s in by_name(sp, spans.SYNC)] == \
        ["cronsun.plan.dispatch"] + ["cronsun.assign.accept"] * 48
    assert len(by_name(sp, "cronsun.compact")) == 8
    assert len(by_name(sp, "cronsun.assign.bid")) == 16


def test_a_gather_on_another_thread_finds_its_window(state):
    p = planner(state)
    handles = [p.plan_window_async(T0 + 8 * i, 8) for i in range(3)]
    got = []
    t = threading.Thread(target=lambda: got.extend(
        p.gather_window(h) for h in reversed(handles)))
    t.start()
    t.join(60)
    assert not t.is_alive() and len(got) == 3
    for w in p.spans.windows():
        sp = w.spans()
        gathers = by_name(sp, "cronsun.plan.gather")
        assert len(gathers) == 1 and gathers[0].parent == -1
        assert gathers[0].start_ns >= sp[0].end_ns
    # the gathers ran newest window first: each window got its own
    ends = [by_name(w.spans(), "cronsun.plan.gather")[0].end_ns
            for w in p.spans.windows()]
    assert ends == sorted(ends, reverse=True)


def test_gathers_on_many_threads_lose_no_span(state):
    """One thread dispatches, more threads than cores gather, with a short
    switch interval: every window keeps its spans and the totals count
    each of them once."""
    p = planner(state, rounds=1)
    n, W = 48, 1
    handles: queue.Queue = queue.Queue()
    failed = []

    def dispatch():
        for i in range(n):
            handles.put(p.plan_window_async(T0 + i, W))

    def gather():
        try:
            while True:
                h = handles.get(timeout=30)
                if h is None:
                    return
                p.gather_window(h)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failed.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gatherers = [threading.Thread(target=gather)
                     for _ in range(2 * (os.cpu_count() or 1) + 2)]
        for t in gatherers:
            t.start()
        dispatch()
        for _ in gatherers:
            handles.put(None)
        for t in gatherers:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not failed and not any(t.is_alive() for t in gatherers), failed
    ws = p.spans.windows()
    assert len(ws) == n
    for w in ws:
        sp = w.spans()
        assert len(by_name(sp, "cronsun.plan.gather")) == 1
        assert len(by_name(sp, spans.SYNC)) == 3 * W + 1
        assert all(s.end_ns >= s.start_ns > 0 for s in sp)
    snap = p.spans.totals.snapshot()
    assert snap["cronsun.plan.gather"]["count"] == n
    assert snap[spans.SYNC]["count"] == n * (3 * W + 1)


def test_the_ring_stays_bounded(state):
    p = planner(state)
    assert spans.RING_WINDOWS >= 2048
    assert p.spans._ring.maxlen == spans.RING_WINDOWS
    p.spans = spans.SpanRecorder(windows=4)
    plan(p, 10, W=2)
    ws = p.spans.windows()
    assert [w.id[1] for w in ws] == [T0 + 2 * i for i in range(6, 10)]
    # the totals keep counting every window
    assert p.spans.totals.snapshot()["cronsun.plan.dispatch"]["count"] == 10


def test_a_span_outside_any_window_records_nothing(state):
    p = planner(state)
    p.warm_window(T0, 8)
    assert p.spans.windows() == []
    assert p.spans.totals.snapshot() == {}


class _Spy:
    """``record_function`` counting its entries."""

    entered = 0

    def __init__(self, name):
        self.rf = _REAL(name)

    def __enter__(self):
        _Spy.entered += 1
        return self.rf.__enter__()

    def __exit__(self, *exc):
        return self.rf.__exit__(*exc)


_REAL = spans.record_function


def test_no_range_is_entered_with_no_profiler_running(state, monkeypatch):
    monkeypatch.setattr(spans, "record_function", _Spy)
    _Spy.entered = 0
    p = planner(state)
    plan(p, 2)
    assert _Spy.entered == 0
    assert not any(w.profiled for w in p.spans.windows())
    with profile(activities=[ProfilerActivity.CPU]):
        plan(p, 1, start=T0 + 16)
    w = p.spans.windows()[-1]
    assert w.profiled and _Spy.entered == len(w.spans())
    assert all(s.profiled for s in w.spans())


@pytest.mark.parametrize("rounds,W", [(1, 1), (2, 8), (3, 4)])
def test_the_sync_count_is_three_a_round_and_one_a_window(state, rounds, W):
    p = planner(state, rounds=rounds)
    plan(p, 2, W=W)
    for w in p.spans.windows():
        n = len(by_name(w.spans(), spans.SYNC))
        assert n / W == 3 * rounds + 1 / W
    snap = p.spans.totals.snapshot()
    assert snap[spans.SYNC]["count"] == 2 * (3 * rounds * W + 1)


def assert_on_profiler_clock(recorder, windows, doc):
    """Mapped by ``recorder``'s anchor, each span of ``windows`` holds its
    range in the Chrome trace ``doc`` (a span is stamped before its range
    opens and after it closes), and the clocks agree within 1 ms: the
    median gap between a span's start and its range's is under 1 ms (a
    thread descheduled while a range opens widens only that span)."""
    base = int(doc["baseTimeNanoseconds"])
    ranges = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            a = float(ev["ts"]) * 1e3 + base
            ranges.setdefault(ev["name"], []).append(
                (a, a + float(ev["dur"]) * 1e3))
    recorded = {}
    for w in windows:
        for s in w.spans():
            recorded.setdefault(s.name, []).append(
                (recorder.wall_ns(s.start_ns), recorder.wall_ns(s.end_ns)))
    assert set(recorded) <= set(ranges)
    gaps = []
    for name, got in recorded.items():
        assert len(ranges[name]) == len(got), name
        for (a, b), (ra, rb) in zip(sorted(got), sorted(ranges[name])):
            assert a <= ra + 1e6 and b >= rb - 1e6, (name, ra - a, b - rb)
            gaps.append(ra - a)
    assert abs(statistics.median(gaps)) < 1e6, statistics.median(gaps)


def test_spans_map_onto_the_profilers_clock(state, tmp_path):
    p = planner(state)
    plan(p, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan(p, 2, start=T0 + 8)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    assert_on_profiler_clock(p.spans, p.spans.windows()[1:], doc)


def test_the_scheduler_publishes_the_planner_totals():
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.logsink import JobLogStore
    from cronsun_tpu_torch.metrics import parse_exposition
    from cronsun_tpu_torch.sched import SchedulerService
    from cronsun_tpu_torch.store import MemStore
    from cronsun_tpu_torch.synth import seed_service_store
    from cronsun_tpu_torch.web.server import ApiServer
    ks = Keyspace()
    store = MemStore()
    seed_service_store(store, ks, 512, 64, T0)
    svc = SchedulerService(store, ks, job_capacity=1024, node_capacity=64,
                           window_s=4, dispatch_ttl=3600.0,
                           clock=lambda: float(T0), device="cpu",
                           node_id="s0")
    srv = ApiServer(store, JobLogStore(), ks=ks, auth_enabled=False,
                    port=0).start()
    try:
        t = T0
        for _ in range(3):
            svc.step(now=t)
            t = svc._next_epoch
        # every window handed to the dispatch thread dispatched, then published
        if svc._pending_plan is not None:
            svc._resolve_handle(svc._pending_plan[1])
        snap = svc.planner.spans.totals.snapshot()
        svc.metrics._next_at = 0.0
        svc.metrics.maybe_publish()
        body, _ctx = srv.handle("GET", "/v1/metrics", {}, b"", {})
        series = parse_exposition(str(body))
    finally:
        srv.stop()
        svc.stop()
    got = {name: v for (name, lbl), v in series.items()
           if name.startswith("cronsun_sched_planner_")
           and dict(lbl).get("instance") == "s0"}
    assert got["cronsun_sched_planner_syncs_total"] == \
        snap[spans.SYNC]["count"] > 0
    assert got["cronsun_sched_planner_sync_wait_ms_total"] == \
        pytest.approx(snap[spans.SYNC]["total_ms"], abs=2e-3)
    assert snap["cronsun.plan.dispatch"]["total_ms"] > 0
    assert got["cronsun_sched_planner_dispatch_ms_total"] == pytest.approx(
        snap["cronsun.plan.dispatch"]["total_ms"], abs=2e-3)
    # the CPU path waits for no event
    assert got["cronsun_sched_planner_gather_wait_ms_total"] == 0
