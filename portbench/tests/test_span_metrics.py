"""The span metrics read the program's in-memory spans: each from a recorder
built by hand, over the windows gathered with no profiler running; nothing
off the card, nor from a program that keeps no spans."""

import sys
from types import SimpleNamespace

import pytest

from cronsun_tpu_torch.ops import spans
from portbench import harness

CARD = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
MS = 1_000_000
READERS = ("plan_host_ms", "gather_wait_ms", "assign_host_ms",
           "sync_wait_ms", "syncs_per_tick")

# one window of 2 s, times in ms: (name, start, end, parent)
WINDOW = [("cronsun.plan.dispatch", 0, 10, -1),
          ("cronsun.sync", 1, 1.5, 0),              # the upload
          ("cronsun.assign", 2, 8, 0),
          ("cronsun.assign.accept", 3, 7, 2),
          ("cronsun.sync", 4, 5, 3),
          ("cronsun.sync", 5, 6, 3),
          ("cronsun.plan.gather", 20, 24, -1),
          ("cronsun.plan.gather.wait", 20, 21, 6)]
# per planned second at scale 1
ONE = {"plan_host_ms": 5.0, "gather_wait_ms": 0.5, "assign_host_ms": 2.0,
       "sync_wait_ms": 1.25, "syncs_per_tick": 1.5}


def _window(rec, epoch, scale, profiled=False, gathered=True):
    w = rec.window(epoch, 2)
    for name, a, b, parent in WINDOW:
        if name.startswith("cronsun.plan.gather") and not gathered:
            continue
        w.rec.extend((spans._CODE[name], int(a * scale * MS),
                      int(b * scale * MS), parent, profiled))
    w.profiled = profiled
    return w


def _read(name, ctx=CARD):
    return harness.reader(name)(ctx)


@pytest.fixture
def recorder():
    rec = spans.SpanRecorder()
    assert spans.newest() is rec
    return rec


def test_each_reader_takes_the_median_a_second(recorder):
    for i, scale in enumerate((1, 2, 5)):
        _window(recorder, 100 + 2 * i, scale)
    for name in READERS:
        want = ONE[name] * (1 if name == "syncs_per_tick" else 2)
        assert _read(name) == pytest.approx(want), name


def test_profiled_and_ungathered_windows_are_skipped(recorder):
    _window(recorder, 100, 1)
    _window(recorder, 102, 50, profiled=True)
    _window(recorder, 104, 70, gathered=False)
    for name in READERS:
        assert _read(name) == pytest.approx(ONE[name]), name
    # a recorder with only profiled windows gives nothing to read
    rec = spans.SpanRecorder()
    _window(rec, 100, 1, profiled=True)
    for name in READERS:
        assert _read(name) is None, name


def test_nothing_is_read_off_the_card_or_without_spans(recorder,
                                                       monkeypatch):
    _window(recorder, 100, 1)
    for name in READERS:
        assert _read(name, SimpleNamespace(device_kind="cpu")) is None
        assert _read(name, SimpleNamespace()) is None
    # a program without the module (the tree before it)
    import cronsun_tpu_torch.ops as ops
    monkeypatch.delattr(ops, "spans")
    monkeypatch.setitem(sys.modules, "cronsun_tpu_torch.ops.spans", None)
    for name in READERS:
        assert _read(name) is None, name


def test_a_planner_run_on_the_card_path_is_read(recorder):
    """The readers over the spans a real planner records (the CPU path
    standing in for the card's): two rounds, W = 8."""
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.synth import synth_state
    p = planner_from_numpy(synth_state(1024, 64, seed=2, specs=None),
                           device="cpu", max_fire_bucket=256, rounds=2)
    for i in range(3):
        p.gather_window(p.plan_window_async(1_753_000_000 + 8 * i, 8))
    assert _read("syncs_per_tick") == 6.125
    assert _read("plan_host_ms") > _read("assign_host_ms") > 0
    assert _read("sync_wait_ms") > 0
    assert _read("gather_wait_ms") == 0.0      # the CPU waits for no event
