"""The metric arithmetic: percentiles over all samples, rates over the
whole window, the byte model, and the trace reader on a known trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.trace import WINDOW, Trace


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_tick_p99_is_over_every_window_over_its_seconds():
    iv = np.linspace(0.010, 0.030, 1001)
    ctx = SimpleNamespace(intervals_s=iv, W=8)
    assert _read("tick_ms_p99", ctx) == pytest.approx(
        np.percentile(iv, 99) / 8 * 1e3)
    assert _read("tick_ms_p99", SimpleNamespace(intervals_s=np.array([]),
                                                W=8)) is None


def test_rates_are_over_the_whole_window():
    ctx = SimpleNamespace(placed_fires=5_000_000, window_wall_s=40.5)
    assert _read("plan_fires_per_s", ctx) == pytest.approx(5e6 / 40.5)


def test_byte_model_counts_each_byte_once():
    # K1: 10446 active rows of 320 words, a bucket of 16384
    assert roofline.k1_bytes(10446, 16384, 320) == (
        4 * 10446 * 320 + 4 * 10240 + 13 * 16384)
    assert roofline.k2_bytes(10521, 16384, 320) == (
        4 * 10521 * 320 + 8 * 16384 + 4 * 10240)
    assert roofline.peak_bytes_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_s("cpu") is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    ev = [_ev("user_annotation", WINDOW, 0, 1000),
          _ev("user_annotation", "cronsun.plan.dispatch", 10, 400),
          _ev("user_annotation", "cronsun.assign", 100, 200),
          _ev("cpu_op", "aten::nonzero", 350, 100),
          _ev("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=2),
          _ev("kernel", "bid_argmin_kernel<false, false>", 130, 50, tid=7,
              correlation=1),
          _ev("kernel", "fanout_add_kernel", 600, 100, tid=7, correlation=2),
          _ev("gpu_memcpy", "Memcpy DtoH", 650, 100, tid=7, correlation=3)]
    return Trace(ev)


def test_trace_busy_idle_and_attribution():
    tr = _trace()
    assert tr.window_s() == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx((50 + 150) * 1e-6)
    assert tr.device_s_in("cronsun.assign") == pytest.approx(50e-6)
    assert tr.device_s_in("cronsun.plan.dispatch") == pytest.approx(50e-6)
    assert tr.host_s_of("cronsun.plan.dispatch") == pytest.approx(400e-6)
    ctx = SimpleNamespace(trace=tr, traced_seconds=2)
    assert _read("device_ops_per_tick", ctx) == 1.5
    assert _read("device_idle.plan", ctx) == pytest.approx(80.0)
    # one reader for a quantity split by the metric it moves
    assert _read("device_idle.any_part", ctx) == pytest.approx(80.0)
    assert _read("assign_dev_ms", ctx) == pytest.approx(0.025)
    gaps = dict(tr.idle_gaps())
    # gaps 0-130 and 180-600 inside the dispatch range (the second's middle
    # inside its nonzero), 750-1000 outside every range
    assert gaps == {"cronsun.plan.dispatch": pytest.approx(130e-6),
                    "cronsun.plan.dispatch > aten::nonzero":
                        pytest.approx(420e-6),
                    "host": pytest.approx(250e-6)}
    assert tr.top_ops()[0] == ["fanout_add_kernel", pytest.approx(100e-6)]


def test_rooflines_read_the_first_round_and_every_fanout():
    tr = Trace([_ev("user_annotation", WINDOW, 0, 10_000)]
               + [_ev("kernel", "bid_argmin_kernel<false, false>", 100 * i,
                      10 if i % 2 == 0 else 5, tid=7) for i in range(4)]
               + [_ev("kernel", "fanout_add_kernel", 1000 + 100 * i, 20,
                      tid=7) for i in range(2)])
    ctx = SimpleNamespace(trace=tr, traced=[(1000, 2000), (500, 1000)],
                          rounds=2, bucket=(2048, 4096), w32=320,
                          device_kind="NVIDIA H100 80GB HBM3")
    k1 = (roofline.k1_bytes(1000, 2048, 320) + roofline.k1_bytes(500, 2048, 320)
          ) / 3.35e12 / 20e-6 * 100
    k2 = (roofline.k2_bytes(2000, 4096, 320) + roofline.k2_bytes(1000, 4096, 320)
          ) / 3.35e12 / 40e-6 * 100
    assert _read("k1_roofline", ctx) == pytest.approx(k1)
    assert _read("k2_roofline", ctx) == pytest.approx(k2)
    ctx.traced = ctx.traced[:1]          # launches do not match the seconds
    assert _read("k1_roofline", ctx) is None
    assert _read("k2_roofline", ctx) is None
