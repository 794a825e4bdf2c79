#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--windows N] [--profile]

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  Fails when no CUDA device is available.
2. build — compiles the hand-written kernels (csrc/*.cu) in parallel.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (K1 bid_argmin: best and choice exactly equal;
   K2 fanout_add: exact for integer weights, rtol 1e-5 for fractional ones,
   since the two sum in different orders), with its time, the plain
   version's time and the least time the card could take.
4. plan_equivalence — TickPlanner on the card against TickPlanner on the CPU
   (plain path) from one seeded state at the config-sample shape (65536 jobs
   x 1024 nodes, W = 4): every TickPlan field, the final load and rem_cap
   identical.
5. headline — the north-star deployment, 2^20 jobs x 10240 nodes, W = 8,
   buckets (16384, 16384), rounds 2: 2 warm-up windows then ``--windows``
   timed windows pipelined 2 deep, with the launch counts of both kernels
   set to 0 just before and read just after; the plans are checked against
   the numpy state (every fire due, every due row fired, every placement
   eligible).
6. ``--profile`` only: a torch.profiler pass over a few headline windows,
   device time by op written to chiprun_out/.

Then the kernels line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the fp32
# rate outside the tensor cores — the rate the bound charges every 32-bit
# integer or float operation at.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
K1_OPS_PER_BIT = 10   # 3 imul, 2 xor, 2 shift, convert, add, compare
T0 = 1_753_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls (CUDA events,
    after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def popcount(packed) -> int:
    import torch
    return int(sum(((packed >> b) & 1).sum(dtype=torch.int64).item()
                   for b in range(32)))


def bound_ms(n_bytes: float, n_ops: float) -> "tuple[float, str]":
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phases

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, HERE)
    import cronsun_tpu_torch  # noqa: F401  (fails outside a checkout)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from cronsun_tpu_torch.ops import _build
    secs = _build.build()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.KERNELS}
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})


def _random_tile(K, w32, seed, dev, empty_every=16):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-2**31, 2**31, (K, w32), dtype=torch.int32,
                           device=dev, generator=g)
    packed[::empty_every] = 0
    # loads quantized to 4 values force exact-score tie collisions; a few
    # closed nodes are +inf
    load = torch.randint(0, 4, (w32 * 32,), device=dev, generator=g
                         ).to(torch.float32)
    load[::97] = float("inf")
    w_int = torch.randint(0, 9, (K,), device=dev, generator=g
                          ).to(torch.float32)
    w_frac = torch.rand(K, device=dev, generator=g) * (w_int > 0)
    return packed, load, w_int, w_frac


def phase_kernels(dev):
    import torch
    from cronsun_tpu_torch.ops import kernels as k
    checks = []
    err = {"bid_argmin": 0.0, "fanout_add": 0.0}
    cases = [("main", 16384, 320), ("wide_fleet", 2048, 3200),
             ("empty_rows", 2048, 320)]
    tiles = {}
    for seed, (name, K, w32) in enumerate(cases):
        packed, load, w_int, w_frac = _random_tile(K, w32, seed, dev)
        if name == "empty_rows":
            packed.zero_()
        tiles[name] = (packed, load, w_int, w_frac)
        best, choice = k.bid_argmin(packed, load)
        best_p, choice_p = k.bid_argmin_plain(packed, load)
        torch.cuda.synchronize()
        if not (torch.equal(choice, choice_p) and torch.equal(best, best_p)):
            bad = int((choice != choice_p).sum())
            raise AssertionError(f"K1 {name}: {bad} choices differ from plain")
        fin = torch.isfinite(best_p)
        err["bid_argmin"] = max(err["bid_argmin"], float(
            (best[fin] - best_p[fin]).abs().max()) if fin.any() else 0.0)
        out_i = k.fanout_add(packed, w_int)
        ref_i = k.fanout_add_plain(packed, w_int)
        if not torch.equal(out_i, ref_i):
            raise AssertionError(f"K2 {name}: integer weights not exact")
        out_f = k.fanout_add(packed, w_frac)
        ref_f = k.fanout_add_plain(packed, w_frac)
        torch.testing.assert_close(out_f, ref_f, rtol=1e-5, atol=1e-5)
        err["fanout_add"] = max(err["fanout_add"],
                                float((out_f - ref_f).abs().max()))
        checks.append({"case": name, "K": K, "N": w32 * 32,
                       "rows_empty": int((packed == 0).all(1).sum()),
                       "k1_no_candidate": int((~fin).sum()),
                       "k1_equal": True, "k2_int_equal": True,
                       "k2_frac_max_abs": float((out_f - ref_f).abs().max())})
    # times at the main path's shape (K = the headline SLA bucket)
    packed, load, w_int, _ = tiles["main"]
    K, w32 = packed.shape
    bits = popcount(packed)
    rows = []
    k1_bound, k1_by = bound_ms(4 * K * w32 + 4 * w32 * 32 + 8 * K,
                               K1_OPS_PER_BIT * bits)
    k2_bound, k2_by = bound_ms(4 * K * w32 + 4 * K + 4 * w32 * 32, bits)
    for name, fn, plain, b_ms, b_by, line in (
            ("bid_argmin", lambda: k.bid_argmin(packed, load),
             lambda: k.bid_argmin_plain(packed, load), k1_bound, k1_by, 119),
            ("fanout_add", lambda: k.fanout_add(packed, w_int),
             lambda: k.fanout_add_plain(packed, w_int), k2_bound, k2_by, 185)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cronsun_tpu_torch/csrc/{name}.cu",
            "replaces": f"cronsun_tpu/ops/pallas_kernels.py:{line}",
            "launches": 0, "max_abs_err": err[name],
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"K": K, "N": w32 * 32, "set_bits": bits}})
    emit({"phase": "kernels", "checks": checks, "timings": rows})
    return rows


def _compare_plans(ref, got, where):
    from cronsun_tpu_torch.ops.planner import TickPlan
    import dataclasses
    assert len(ref) == len(got), where
    for a, b in zip(ref, got):
        for f in dataclasses.fields(TickPlan):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = (np.array_equal(x, y) if isinstance(x, np.ndarray)
                    else x == y)
            if not same:
                raise AssertionError(f"{where} @ {a.epoch_s}: {f.name} differs")


def phase_plan_equivalence(dev, J=65536, N=1024, windows=5, W=4):
    """J, N: conf/base.json.sample's job_capacity and node_capacity."""
    import torch
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.synth import synth_state
    state = synth_state(J, N, seed=7, node_cap=4, empty_rows=0.02)
    kw = dict(rounds=2, max_fire_bucket=8192)
    gpu = planner_from_numpy(state, device=dev, **kw)
    cpu = planner_from_numpy(state, device="cpu", **kw)
    fired = placed = 0
    t = time.perf_counter()
    for i in range(windows):
        for p in (gpu, cpu):     # the service's reconcile re-opens capacity
            p.set_node_capacity(list(range(N)), [4] * N)
        got = gpu.plan_window(T0 + W * i, W)
        ref = cpu.plan_window(T0 + W * i, W)
        _compare_plans(ref, got, f"window {i}")
        fired += sum(p.total_fired for p in got)
        placed += sum(int((p.assigned >= 0).sum()) for p in got)
    if not (torch.equal(gpu.load.cpu(), cpu.load)
            and torch.equal(gpu.rem_cap.cpu(), cpu.rem_cap)):
        raise AssertionError("final load / rem_cap differ")
    if placed == 0:
        raise AssertionError("nothing was placed: the comparison is vacuous")
    emit({"phase": "plan_equivalence", "J": J, "N": N, "W": W,
          "windows": windows, "seconds_planned": windows * W,
          "fired": fired, "placed": placed, "identical": True,
          "buckets": [gpu._bx.cur_k, gpu._bc.cur_k],
          "wall_s": time.perf_counter() - t})


def _check_headline(state, plans, N):
    """Every fire is due, every due row fired (no overflow at this SLA), and
    every placement is on an eligible node."""
    t_rel = np.int64(plans[0].epoch_s - 1577836800)
    period = state["period"].astype(np.int64)
    phase = state["phase_mod"].astype(np.int64)
    for i, p in enumerate(plans):
        due = np.nonzero((phase - (t_rel + i)) % period == 0)[0]
        if p.overflow:
            raise AssertionError(f"overflow {p.overflow} at the headline SLA")
        if not np.array_equal(np.sort(p.fired), due):
            raise AssertionError(f"second {p.epoch_s}: fire set != due rows")
        xs, a = p.fired[:p.n_excl], p.assigned[:p.n_excl]
        if not (state["exclusive"][xs].all()
                and not state["exclusive"][p.fired[p.n_excl:]].any()):
            raise AssertionError("kind split wrong")
        ok = a >= 0
        if (a >= N).any() or (p.assigned[p.n_excl:] != -1).any():
            raise AssertionError("placement out of range")
        words = state["elig"][xs[ok], a[ok] // 32]
        if not ((words >> (a[ok] % 32).astype(np.uint32)) & 1).all():
            raise AssertionError("placement on an ineligible node")


def phase_headline(dev, n_windows, profile, J=1 << 20, N=10240,
                   SLA=(16384, 16384), W=8):
    """bench.py's headline shape: 1M @every jobs (periods 35-70 s, uniform
    phases) x 10240 nodes, half exclusive, capacity never binding."""
    import torch
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.ops import kernels as k
    from cronsun_tpu_torch.synth import synth_state
    t = time.perf_counter()
    state = synth_state(J, N, seed=2, specs=None, node_cap=1 << 20)
    p = planner_from_numpy(state, device=dev, rounds=2, max_fire_bucket=65536)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()

    k.reset_launch_counts()                     # the main path's run starts
    for i in range(2):                          # warm-up windows
        p.gather_window(p.plan_window_async(T0 + i * W, W, sla_bucket=SLA))
    handles, stamps, plans = [], [], []
    t0 = T0 + 1000
    for i in range(n_windows):
        handles.append(p.plan_window_async(t0 + i * W, W, sla_bucket=SLA))
        if len(handles) > 2:
            plans.append(p.gather_window(handles.pop(0)))
            stamps.append(time.perf_counter())
    for h in handles:
        plans.append(p.gather_window(h))
    counts = k.launch_counts()                  # ... and ends
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    per_tick = np.diff(stamps) / W * 1e3
    for i in (0, len(plans) // 2, len(plans) - 1):
        _check_headline(state, plans[i], N)
    if not torch.isfinite(p.load).all():
        raise AssertionError("non-finite load")
    ticks = [pl for win in plans for pl in win]
    out = {"phase": "headline", "J": J, "N": N, "W": W, "sla": list(SLA),
           "rounds": 2, "timed_windows": n_windows,
           "interval_samples": int(len(per_tick)),
           "p50_ms_per_tick": float(np.percentile(per_tick, 50)),
           "p99_ms_per_tick": float(np.percentile(per_tick, 99)),
           "mean_ms_per_tick": float(per_tick.mean()),
           "fired_per_tick": float(np.mean([pl.total_fired for pl in ticks])),
           "placed_per_tick": float(np.mean(
               [(pl.assigned >= 0).sum() for pl in ticks])),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "setup_s": setup_s, "launches": counts,
           "launches_per_planned_second": {
               n: c / ((n_windows + 2) * W) for n, c in counts.items()},
           "nvidia_smi": nvidia_smi_line()}
    emit(out)
    if profile:
        profile_windows(p, W, SLA)
    return counts


def profile_windows(p, W, SLA, n=4):
    """Device time by op over ``n`` pipelined headline windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for i in range(n):
            p.gather_window(p.plan_window_async(T0 + 50_000 + i * W, W,
                                                sla_bucket=SLA))
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType
    rows, busy_ms = [], 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(ev, "self_cuda_time_total", 0)
        rows.append({"name": ev.key, "count": ev.count,
                     "device_ms": dev_us / 1e3, "self_device_ms": self_us / 1e3,
                     "cpu_ms": ev.cpu_time_total / 1e3})
        # kernels and copies; the cronsun.* ranges' device rows only span them
        if ev.device_type == DeviceType.CUDA and not ev.key.startswith("cronsun."):
            busy_ms += self_us / 1e3
    rows.sort(key=lambda r: -r["device_ms"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_headline.json"), "w") as f:
        json.dump({"wall_ms": wall_ms, "windows": n, "W": W, "rows": rows}, f,
                  indent=1)
    emit({"phase": "profile", "windows": n, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "top": rows[:25]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=100,
                    help="timed headline windows (default 100)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over headline windows")
    args = ap.parse_args(argv)

    smi = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    rows = phase_kernels(dev)
    phase_plan_equivalence(dev)
    counts = phase_headline(dev, args.windows, args.profile)
    for r in rows:
        r["launches"] = counts[r["name"]]
        r.pop("shape")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
