#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--windows N] [--profile]

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  Fails when no CUDA device is available.
2. build — compiles the hand-written kernels (csrc/*.cu) in parallel and
   prints what ``-Xptxas -v`` says of every kernel variant (registers,
   shared memory, spills).
3. kernels — each kernel against its plain PyTorch version on the card
   (K1 bid_argmin: best and choice exactly equal; K2
   fanout_add: exact for integer weights, rtol 1e-5 for fractional ones,
   since the two sum in different orders, and bitwise equal across two
   calls): the main path's shape, a wide fleet past shared memory, rows
   whose words are not 16-byte aligned (W32 = 5, 7), one row, all nodes
   closed, all loads equal, and buckets of rows of a larger table with
   ``rows`` (repeats, row 0 as padding) and ``active`` (random, prefix).
4. kernel_times — on a synthetic tile at the main path's shape (K = 16384,
   N = 10240, no gather): each kernel's time (also timed back to back
   without a pre-filled stream, and with no row to work on), its plain
   version's time, the least time the card could take, and the kernels the
   card ran for one call (torch.profiler).
5. plan_equivalence — TickPlanner on the card against TickPlanner on the CPU
   (plain path) from one seeded state at the config-sample shape (65536 jobs
   x 1024 nodes, W = 4): every TickPlan field, the final load and rem_cap
   identical.
6. path_times — on the headline's planner, fresh from its seed and
   advanced ``PATH_WINDOWS`` windows (so the state does not depend on
   ``--windows``), both kernels on inputs captured from the next second
   (the 1M-row table, each bid round's rows, active mask and load_eff; the
   Common bucket's rows and weights), held against plain and timed, with a
   bound that counts only the rows read.
7. headline — the north-star deployment, 2^20 jobs x 10240 nodes, W = 8,
   buckets (16384, 16384), rounds 2: 2 warm-up windows then ``--windows``
   timed windows pipelined 2 deep, with the launch counts of both kernels
   set to 0 just before and read just after; the plans are checked against
   the numpy state (every fire due, every due row fired, every placement
   eligible).  One more window counts the index gathers per planned second.
8. ``--profile`` only: a torch.profiler pass over a few headline windows,
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
# K1's least work: every set bit of an active row costs its load and a
# compare; a bit that pruning cannot skip also costs the hash and the
# lexicographic compare (3 imul, 2 xor, 2 shift, or, sub, add, compare)
K1_OPS_PER_BIT = 2
K1_OPS_PER_HASH = 11
T0 = 1_753_000_000
SPIN_CYCLES = 20_000_000   # ~11 ms at the H100's 1.755 GHz boost clock
PATH_WINDOWS = 4           # headline windows planned before the path capture


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, prefill: bool = True) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls (CUDA events,
    after one warm call).  With ``prefill`` the stream first runs a ~10 ms
    spin, during which the host enqueues every call, so the events time the
    card and not the Python wrapper; without it a call that takes less
    device time than its wrapper times the wrapper."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(SPIN_CYCLES)
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
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
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


def _bucket(K, J, seed, dev, prefix):
    """Row indices with repeats and row 0 as padding (the planner's padded
    slots), and an active mask: random, or a prefix like ``valid``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, J, (K,), dtype=torch.int32, device=dev,
                         generator=g)
    rows[(K * 5) // 8:] = 0
    rows[1:K // 4:3] = rows[0]
    if prefix:
        active = torch.arange(K, device=dev) < (K * 5) // 8
    else:
        active = torch.rand(K, device=dev, generator=g) < 0.6
    return rows, active


def k1_max_abs(best, best_p) -> float:
    """max |best - best_p| over the entries where plain's best is finite."""
    import torch
    fin = torch.isfinite(best_p)
    return float((best[fin] - best_p[fin]).abs().max()) if fin.any() else 0.0


def _check_case(k, name, packed, load, w_int, w_frac, rows=None, active=None):
    """K1 equal to plain (best and choice exactly); K2 exact on integer
    weights, rtol 1e-5 on fractional ones, bitwise repeatable."""
    import torch
    best_p, choice_p = k.bid_argmin_plain(packed, load, rows, active)
    best, choice = k.bid_argmin(packed, load, rows=rows, active=active)
    torch.cuda.synchronize()
    if not (torch.equal(choice, choice_p) and torch.equal(best, best_p)):
        bad = int((choice != choice_p).sum())
        raise AssertionError(f"K1 {name}: {bad} choices differ")
    if rows is not None:
        w_int, w_frac = w_int * active, w_frac * active
    if not torch.equal(k.fanout_add(packed, w_int, rows=rows),
                       k.fanout_add_plain(packed, w_int, rows)):
        raise AssertionError(f"K2 {name}: integer weights not exact")
    out_f = k.fanout_add(packed, w_frac, rows=rows)
    ref_f = k.fanout_add_plain(packed, w_frac, rows)
    torch.testing.assert_close(out_f, ref_f, rtol=1e-5, atol=1e-5)
    if not torch.equal(out_f, k.fanout_add(packed, w_frac, rows=rows)):
        raise AssertionError(f"K2 {name}: two calls differ")
    fin = torch.isfinite(best_p)
    return {"case": name, "K": int(best_p.shape[0]),
            "N": packed.shape[1] * 32,
            "rows": None if rows is None else int(rows.shape[0]),
            "active": None if active is None else int(active.sum()),
            "k1_no_candidate": int((~fin).sum()),
            "k1_max_abs": k1_max_abs(best, best_p), "k1_equal": True, "k2_int_equal": True, "k2_repeatable": True,
            "k2_frac_max_abs": float((out_f - ref_f).abs().max())}


def k1_work(packed, load, best, rows=None, active=None):
    """(bytes, set bits, bits that must be hashed) of one K1 call: each
    active row read once, plus rows/active/load_eff in and best/choice out.
    A set bit must be hashed only when its load is finite and <= the row's
    final best — any other bit is pruned exactly, in any scan order."""
    import torch
    K, w32 = (packed.shape if rows is None else (rows.shape[0],
                                                  packed.shape[1]))
    sel = (torch.arange(K, device=packed.device) if active is None
           else torch.nonzero(active).flatten())
    src = sel if rows is None else rows[sel].to(torch.int64)
    n_bytes = (4 * len(sel) * w32 + 4 * w32 * 32 + 8 * K
               + (0 if rows is None else 5 * K))
    bits = hashed = 0
    cols = torch.arange(w32 * 32, device=packed.device)
    for i in range(0, len(sel), 2048):
        words = packed[src[i:i + 2048]]
        dense = ((words[:, cols // 32] >> (cols % 32).to(torch.int32)) & 1
                 ) != 0
        bits += int(dense.sum())
        ok = (load[None, :] <= best[sel[i:i + 2048], None]) & torch.isfinite(
            load)[None, :]
        hashed += int((dense & ok).sum())
    return n_bytes, bits, hashed


def k2_work(packed, weights, rows=None):
    """(bytes, set bits) of one K2 call over the rows of nonzero weight."""
    import torch
    K, w32 = weights.shape[0], packed.shape[1]
    sel = torch.nonzero(weights != 0).flatten()
    src = sel if rows is None else rows[sel].to(torch.int64)
    n_bytes = 4 * len(sel) * w32 + 4 * K + 4 * w32 * 32 + (
        0 if rows is None else 4 * K)
    return n_bytes, popcount(packed[src])


def k1_bound(work):
    n_bytes, bits, hashed = work
    return bound_ms(n_bytes, K1_OPS_PER_BIT * bits + K1_OPS_PER_HASH * hashed)


def device_kernels_per_call(fn) -> int:
    """Kernels the card ran for one call (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def phase_kernels(dev):
    import torch
    from cronsun_tpu_torch.ops import kernels as k
    checks = []
    tiles = {}
    cases = [("main", 16384, 320), ("wide_fleet", 2048, 3200),
             ("one_tile_past_48k", 2048, 400), ("empty_rows", 2048, 320),
             ("unaligned_rows_w5", 999, 5), ("unaligned_rows_w7", 1001, 7),
             ("one_row", 1, 320)]
    for seed, (name, K, w32) in enumerate(cases):
        packed, load, w_int, w_frac = _random_tile(K, w32, seed, dev)
        if name == "empty_rows":
            packed.zero_()
        tiles[name] = (packed, load, w_int, w_frac)
        checks.append(_check_case(k, name, packed, load, w_int, w_frac))
    packed, load, w_int, w_frac = tiles["main"]
    checks.append(_check_case(k, "all_closed", packed,
                              torch.full_like(load, float("inf")),
                              w_int, w_frac))
    checks.append(_check_case(k, "all_loads_equal", packed,
                              torch.zeros_like(load), w_int, w_frac))
    # sparse rows whose winner may load 0.75 while a bit of load 0 sets the
    # candidate bound: the masks must keep every bit within one unit
    sparse = packed.clone()
    g = torch.Generator(device=dev).manual_seed(99)
    for _ in range(4):
        sparse &= torch.randint(-2**31, 2**31, sparse.shape, dtype=torch.int32,
                                device=dev, generator=g)
    near = torch.full_like(load, 0.75)
    near[:32] = 0.0
    checks.append(_check_case(k, "winner_within_one_unit", sparse, near,
                              w_int, w_frac))
    # the fused gather: a bucket of rows of a larger table
    for seed, (name, J, K, w32, prefix) in enumerate((
            ("bucket_main", 65536, 16384, 320, True),
            ("bucket_random_active", 65536, 16383, 320, False),
            ("bucket_wide_fleet", 4096, 2047, 3200, True),
            ("bucket_w5", 3000, 1001, 5, False),
            ("bucket_w7", 3000, 999, 7, True))):
        table, load, _, _ = _random_tile(J, w32, 100 + seed, dev)
        _, _, w_int, w_frac = _random_tile(K, 1, 200 + seed, dev)
        rows, active = _bucket(K, J, 300 + seed, dev, prefix)
        checks.append(_check_case(k, name, table, load, w_int, w_frac,
                                  rows, active))
    emit({"phase": "kernels", "checks": checks})

    # times on the synthetic tile: K = 16384, N = 10240, half the bits set,
    # loads in {0..3}, every row active, no gather
    packed, load, w_int, _ = tiles["main"]
    K, w32 = packed.shape
    best, _ = k.bid_argmin_plain(packed, load)
    work1 = k1_work(packed, load, best)
    b1, by1 = k1_bound(work1)
    work2 = k2_work(packed, w_int)
    b2, by2 = bound_ms(work2[0], work2[1])
    k1_b2b = cuda_ms(lambda: k.bid_argmin(packed, load), 50, prefill=False)
    # fixed cost: the same call with no row to bid for / no row weighted
    none = torch.zeros(K, dtype=torch.bool, device=dev)
    k1_fixed = cuda_ms(lambda: k.bid_argmin(packed, load, active=none), 50)
    k2_fixed = cuda_ms(lambda: k.fanout_add(packed, torch.zeros_like(w_int)),
                       50)
    rows = [{
        "name": "bid_argmin", "route": "cuda",
        "source": "cronsun_tpu_torch/csrc/bid_argmin.cu",
        "replaces": "cronsun_tpu/ops/pallas_kernels.py:119",
        "launches": 0, "max_abs_err": max(c["k1_max_abs"] for c in checks),
        "ms": cuda_ms(lambda: k.bid_argmin(packed, load), 50),
        "plain_ms": cuda_ms(lambda: k.bid_argmin_plain(packed, load), 5),
        "bound_ms": b1, "bound_by": by1, "library_ms": None,
        "ms_back_to_back": k1_b2b,
        "fixed_ms": k1_fixed, "work": dict(zip(
            ("bytes", "set_bits", "must_hash"), work1)),
        "device_kernels_per_call": device_kernels_per_call(
            lambda: k.bid_argmin(packed, load))}, {
        "name": "fanout_add", "route": "cuda",
        "source": "cronsun_tpu_torch/csrc/fanout_add.cu",
        "replaces": "cronsun_tpu/ops/pallas_kernels.py:185",
        "launches": 0, "max_abs_err": max(
            c["k2_frac_max_abs"] for c in checks),
        "ms": cuda_ms(lambda: k.fanout_add(packed, w_int), 50),
        "ms_back_to_back": cuda_ms(lambda: k.fanout_add(packed, w_int), 50,
                                   prefill=False),
        "fixed_ms": k2_fixed, "work": dict(zip(("bytes", "set_bits"),
                                                work2)),
        "plain_ms": cuda_ms(lambda: k.fanout_add_plain(packed, w_int), 5),
        "bound_ms": b2, "bound_by": by2, "library_ms": None,
        "device_kernels_per_call": device_kernels_per_call(
            lambda: k.fanout_add(packed, w_int))}]
    emit({"phase": "kernel_times", "shape": {"K": K, "N": w32 * 32},
          "timings": rows})
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
    path = phase_path_times(p, W, SLA)
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
    gathers = count_gathers(p, T0 + 20_000, W, SLA)
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
           "gathers_per_planned_second": gathers,
           "nvidia_smi": nvidia_smi_line()}
    emit(out)
    if profile:
        profile_windows(p, W, SLA)
    return counts, path


def count_gathers(p, epoch_s, W, SLA):
    """Index gathers per planned second over one headline window: those
    that read the eligibility table, and all of them (each is a launch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    ops = (aten.index.Tensor, aten.index_select.default, aten.gather.default)
    elig_ptr = p.elig.data_ptr()

    class Count(TorchDispatchMode):
        elig = total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops:
                Count.total += 1
                Count.elig += int(args[0].data_ptr() == elig_ptr)
            return func(*args, **(kwargs or {}))

    with Count():
        p.gather_window(p.plan_window_async(epoch_s, W, sla_bucket=SLA))
    return {"elig_rows": Count.elig / W, "all_index_ops": Count.total / W}


def phase_path_times(p, W, SLA):
    """K1 and K2 on inputs captured from one headline second, planned after
    ``PATH_WINDOWS`` windows on the fresh planner ``p``: the 1M-row table,
    the bucket's rows with each round's active mask and load_eff (K1), the
    Common bucket's rows and weights (K2).  Each is held equal to its plain
    version and timed; the bound counts only the rows read."""
    import torch
    from cronsun_tpu_torch.ops import assign
    from cronsun_tpu_torch.ops import kernels as k
    epoch_s = T0 + 30_000
    for _ in range(PATH_WINDOWS):
        p.gather_window(p.plan_window_async(epoch_s, W, sla_bucket=SLA))
        epoch_s += W
    bids, fans = [], []
    orig = assign.bid_argmin, assign.fanout_add

    def bid(packed, load_eff, rows=None, active=None):
        bids.append((packed, load_eff.clone(), rows.clone(), active.clone()))
        return orig[0](packed, load_eff, rows=rows, active=active)

    def fan(packed, weights, rows=None):
        fans.append((packed, weights.clone(), rows.clone()))
        return orig[1](packed, weights, rows=rows)

    assign.bid_argmin, assign.fanout_add = bid, fan
    try:
        p.gather_window(p.plan_window_async(epoch_s, 1, sla_bucket=SLA))
    finally:
        assign.bid_argmin, assign.fanout_add = orig
    out = []
    for rnd, (table, load, rows, active) in enumerate(bids, 1):
        best, choice = k.bid_argmin_plain(table, load, rows, active)
        got = k.bid_argmin(table, load, rows=rows, active=active)
        if not (torch.equal(got[0], best) and torch.equal(got[1], choice)):
            raise AssertionError(f"K1 path round {rnd} != plain")
        work = k1_work(table, load, best, rows, active)
        b_ms, b_by = k1_bound(work)
        out.append({"name": "bid_argmin", "round": rnd, "K": len(rows),
                    "active_rows": int(active.sum()), "set_bits": work[1],
                    "must_hash": work[2],
                    "max_abs_err": k1_max_abs(got[0], best),
                    "ms": cuda_ms(lambda: k.bid_argmin(
                        table, load, rows=rows, active=active), 50),
                    "plain_ms": cuda_ms(lambda: k.bid_argmin_plain(
                        table, load, rows, active), 5),
                    "bound_ms": b_ms, "bound_by": b_by})
    for table, weights, rows in fans:
        got = k.fanout_add(table, weights, rows=rows)
        ref = k.fanout_add_plain(table, weights, rows)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        n_bytes, bits = k2_work(table, weights, rows)
        b_ms, b_by = bound_ms(n_bytes, bits)
        out.append({"name": "fanout_add", "K": len(rows),
                    "weighted_rows": int((weights != 0).sum()),
                    "set_bits": bits, "max_abs_err": float(
                        (got - ref).abs().max()),
                    "ms": cuda_ms(lambda: k.fanout_add(
                        table, weights, rows=rows), 50),
                    "plain_ms": cuda_ms(lambda: k.fanout_add_plain(
                        table, weights, rows), 5),
                    "bound_ms": b_ms, "bound_by": b_by})
    if len(bids) != 2 or len(fans) != 1:
        raise AssertionError(f"captured {len(bids)} bids, {len(fans)} fan-outs")
    emit({"phase": "path_times", "table_rows": int(p.elig.shape[0]),
          "advanced_windows": PATH_WINDOWS, "epoch_s": epoch_s,
          "nvidia_smi": nvidia_smi_line(), "timings": out})
    return out


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
    counts, path = phase_headline(dev, args.windows, args.profile)
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["path"] = [{key: t[key] for key in ("ms", "bound_ms", "plain_ms")}
                     for t in path if t["name"] == r["name"]]
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            t["max_abs_err"] for t in path if t["name"] == r["name"]])
        r.pop("work")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
