"""Benchmark ladder of the PyTorch port: the counterpart of the repo's
``bench.py``.  Prints ONE JSON line on stdout.

    python -m cronsun_tpu_torch.scripts.bench [--quick] [--device cuda|cpu]
        [--detail PATH]

Headline: tick+assign latency at 2^20 jobs x 10240 nodes on one card,
sustained (pipelined windows of W = 8 s), p99 per planned second over
per-window completion intervals.  ``vs_baseline`` is ``TARGET_MS`` over the
measured p99 (> 1 beats the target).

The in-process cells run on the card unless ``--device cpu`` is given; with
no card the module exits 1.  The kernel cells launch the hand-written
kernels (``csrc/*.cu``, built at first use) and hold them against their
plain PyTorch versions; on the CPU every wrapper runs its plain version.
A failing in-process cell fails the run.

The subprocess planes (:data:`PLANES`) run the port's benches as ``python
-m cronsun_tpu_torch.scripts.bench_<name>`` from the repo root with
``bench.py``'s arguments, timeouts and environment, in its order; each
merges its JSON into the detail as ``bench.py`` does, and a plane that
fails records its ``*_error`` key (the last 500 bytes of its standard
error) and the run goes on.  With ``--device cpu`` the planes whose script
places a planner (``bench_sched``, ``bench_mesh``) get ``--device cpu`` too.

The detail goes to ``--detail`` (default ``chiprun_out/bench_detail_torch.json``
under the repo root), written again after every cell and plane; full runs
write the ``MULTICHIP_ladder.json`` and ``PUSH_ladder.json`` sidecars into
the same directory, and each plane's output to ``bench_<plane>.log`` there.

Differences from ``bench.py``, by necessity: the random eligibility bits
are drawn with numpy (``default_rng(7)`` for the kernel tiles, ``(1)`` for
the ladders, ``(2)`` for the headline, where ``bench.py`` uses
``jax.random.bits`` with those keys), so the data differ from the JAX run's;
every draw of ``bench.py``'s ``default_rng(0)`` is made in its order, so the
loads, weights, config 2's specs and the exclusive flags follow the same
stream.  The link round trip becomes a stream-sync floor on the card, and
kernel times come from CUDA events (``kernel_impls`` names what
``pallas`` and ``jnp`` mean here).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np

from .bench_mesh import git_rev, log, utc_now

TARGET_MS = 100.0
T0 = 1_753_000_000
METRIC = "tick+assign sustained p99 @ 1M jobs x 10k nodes, 1 chip"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DETAIL = os.path.join(ROOT, "chiprun_out", "bench_detail_torch.json")

NBIG = 201                 # launches of the long timed run (bench.py:242)
RTT_ROUND_TRIPS = 40
# ``torch.cuda._sleep`` cycles a second, at or above the H100's top clock:
# a spin sized by it lasts at least as long as asked
SPIN_CYCLES_PER_S = 2.0e9


def nvidia_smi_line() -> str:
    """``name, power limit`` of every card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or f"nvidia-smi exited {out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e.__class__.__name__})"


def check_artifact_provenance(rev: str, detail_path: str) -> None:
    """STALE warnings for the port's own artifacts (the detail file and the
    sidecars beside it) whose ``git_rev`` is not HEAD's."""
    here = os.path.dirname(detail_path)
    arts = [detail_path] + sorted(
        glob.glob(os.path.join(here, "MULTICHIP_*.json"))
        + glob.glob(os.path.join(here, "PUSH_*.json")))
    for path in arts:
        if not os.path.exists(path):
            continue
        name = os.path.basename(path)
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            log(f"STALE? {name}: unreadable ({e})")
            continue
        art_rev = art.get("git_rev")
        if art_rev is None:
            log(f"STALE: {name} carries no git_rev stamp")
        elif art_rev != rev:
            log(f"STALE: {name} was generated at rev {art_rev}, HEAD is "
                f"{rev} — re-run this bench before quoting it")


# ---------------------------------------------------------------- shapes

@dataclasses.dataclass(frozen=True)
class Shapes:
    """Sizes of the in-process cells; the defaults are ``bench.py``'s.
    Smaller ones keep every key and step (the tests run them on the CPU)."""
    k_eq: int = 2048                # kernel cells' rows
    n_eq: int = 10240               # ... nodes
    n_wide: int = 102400            # ... nodes of the wide rung (full runs)
    c2_specs: int = 10_000
    # name, jobs, nodes, fire rate, node capacity, combined bucket
    ladders: Tuple[tuple, ...] = (
        ("c3_10kx1k", 10_000, 1024, 0.5, 1 << 20, 8192),
        ("c4_100kx1k", 100_000, 1024, 0.2, 64, 32768),
        # bucket (16384, 16384): ~2% of 2^20 rows fire a second, about
        # half of them a kind
        ("c5_1Mx10k", 1 << 20, 10240, 0.02, 1 << 20, 32768))
    headline_jobs: int = 1 << 20
    headline_nodes: int = 10240
    headline_bucket: int = 65536
    sla: Tuple[int, int] = (16384, 16384)


BENCH_SHAPES = Shapes()


def random_bits(seed: int, shape, device):
    """Uniform random 32-bit words (int32 bit patterns) drawn with numpy
    from ``seed``: the port's ``jax.random.bits(PRNGKey(seed), shape)``."""
    import torch
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


# ---------------------------------------------------------------- helpers

def bench_ticks(p, t0, n, pipeline=8, sla=None):
    """Sustained pipelined per-tick ms over n ticks (fixed SLA bucket)."""
    handles = []
    start = time.perf_counter()
    for i in range(n):
        handles.append(p.plan_async(t0 + i, sla_bucket=sla))
        if len(handles) > pipeline:
            p.gather(handles.pop(0))
    for h in handles:
        p.gather(h)
    return (time.perf_counter() - start) / n * 1000


def bench_windows(p, t0, n_windows, W, pipeline=2, sla=None):
    """Sustained windowed per-tick ms: n_windows dispatches of W seconds."""
    handles = []
    start = time.perf_counter()
    for i in range(n_windows):
        handles.append(p.plan_window_async(t0 + i * W, W, sla_bucket=sla))
        if len(handles) > pipeline:
            p.gather_window(handles.pop(0))
    for h in handles:
        p.gather_window(h)
    return (time.perf_counter() - start) / (n_windows * W) * 1000


def window_intervals(p, t0, n_windows, W, pipeline=2, sla=None):
    """Per-tick ms as a distribution: the intervals between the gathers made
    while the pipeline is still being fed (drain-phase gathers complete at
    once and are left out), divided by W."""
    handles = []
    stamps = []
    for i in range(n_windows):
        handles.append(p.plan_window_async(t0 + i * W, W, sla_bucket=sla))
        if len(handles) > pipeline:
            p.gather_window(handles.pop(0))
            stamps.append(time.perf_counter())
    for h in handles:
        p.gather_window(h)
    return np.diff(stamps) / W * 1000


def bench_ticks_sync(p, t0, n, sla=None):
    lat = []
    for i in range(n):
        s = time.perf_counter()
        p.plan(t0 + i, sla_bucket=sla)
        lat.append((time.perf_counter() - s) * 1000)
    return np.array(lat)


def pct(x, q) -> float:
    return round(float(np.percentile(x, q)), 2)


# ---------------------------------------------------------------- cells

def stream_sync_floor(dev) -> dict:
    """Median, p90 and p99 ms of ``RTT_ROUND_TRIPS`` ``(x + 1).item()``
    round trips: the least any synchronous per-call figure can take."""
    import torch
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    (x + 1).item()
    rtts = []
    for _ in range(RTT_ROUND_TRIPS):
        s = time.perf_counter()
        (x + 1).item()
        rtts.append((time.perf_counter() - s) * 1000)
    return {"rtt_floor_ms": round(float(np.median(rtts)), 4),
            "rtt_p90_ms": round(float(np.percentile(rtts, 90)), 4),
            "rtt_p99_ms": round(float(np.percentile(rtts, 99)), 4)}


def kernels_equal(packed, load, weights) -> bool:
    """K1 and K2 against their plain versions with ``bench.py``'s bars:
    choices bit-identical, ``best`` within rtol/atol 1e-6, fan-out within
    rtol 1e-3 and atol 1e-2 (the two sum in different orders)."""
    import torch
    from ..ops import kernels
    bp, cp = kernels.bid_argmin(packed, load)
    bj, cj = kernels.bid_argmin_plain(packed, load)
    fp = kernels.fanout_add(packed, weights)
    fj = kernels.fanout_add_plain(packed, weights)
    return (bool(torch.equal(cp, cj))
            and bool(torch.allclose(bp, bj, rtol=1e-6, atol=1e-6))
            and bool(torch.allclose(fp, fj, rtol=1e-3, atol=1e-2)))


def _timed(fn, a, b, n, dev, spin_s=0.0) -> float:
    """Seconds of n back-to-back calls ``fn(a, b)``: CUDA events on the card
    (behind a spin of ``spin_s`` seconds, so the calls queue up while it
    runs and the events time the card, not the host's launches), the host
    clock on the CPU."""
    import torch
    if dev.type != "cuda":
        s = time.perf_counter()
        for _ in range(n):
            fn(a, b)
        return time.perf_counter() - s
    torch.cuda.synchronize(dev)
    if spin_s:
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(a, b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def kernel_inputs(rng, quick: bool, dev, shapes: Shapes = BENCH_SHAPES):
    """The kernel cells' inputs, drawn from ``rng`` in ``bench.py``'s order
    (``bench.py:199-249``): the equality tiles (suffix, bits, loads,
    weights) and the timed runners, ``{name: (fn, bits, loads or
    weights)}``."""
    import torch
    from ..ops import kernels
    K = shapes.k_eq
    w_eq = torch.as_tensor(rng.random(K).astype(np.float32), device=dev)
    scales = [("", shapes.n_eq)] + ([] if quick else
                                    [("_wide", shapes.n_wide)])
    # the same bits in both parts, as bench.py's PRNGKey(7)
    bits = {suffix: random_bits(7, (K, n // 32), dev) for suffix, n in scales}
    # heavy ties: loads of 4 distinct values
    eq = [(suffix, bits[suffix], torch.as_tensor(
        rng.integers(0, 4, n).astype(np.float32), device=dev), w_eq)
        for suffix, n in scales]
    runners = {}
    for suffix, n in scales:
        kp = bits[suffix]
        ld = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                             device=dev)
        wt = torch.as_tensor(rng.random(K).astype(np.float32), device=dev)
        for impl, bid_f, fan_f in (
                ("pallas", kernels.bid_argmin, kernels.fanout_add),
                ("jnp", kernels.bid_argmin_plain, kernels.fanout_add_plain)):
            runners[f"bid{suffix}_{impl}"] = (bid_f, kp, ld)
            runners[f"fanout{suffix}_{impl}"] = (fan_f, kp, wt)
    return eq, runners


def kernel_cells(eq, runners, quick: bool, dev) -> dict:
    """``kernels_equal{,_wide}`` and ``kernel_{bid,fanout}{,_wide}_{pallas,
    jnp}_ms`` (``bench.py:191-271``) from :func:`kernel_inputs`: per
    kernel, (time of ``NBIG`` calls - time of 1) / (``NBIG`` - 1), each
    the least over 3 (quick) or 5 rounds that interleave every
    measurement."""
    out = {f"kernels_equal{suffix}": kernels_equal(packed, load, w)
           for suffix, packed, load, w in eq}
    host = {}           # host seconds a call takes to issue, from a warm run
    for name, (f, a, b) in runners.items():
        _timed(f, a, b, 1, dev)
        s = time.perf_counter()
        for _ in range(NBIG):
            f(a, b)
        host[name] = (time.perf_counter() - s) / NBIG
        _timed(f, a, b, NBIG, dev)

    def spin(name, n):
        return (min(1.0, 1.25 * host[name] * n) if dev.type == "cuda"
                else 0.0)
    best = {(k, n): float("inf") for k in runners for n in (1, NBIG)}
    for _ in range(3 if quick else 5):
        for name, (f, a, b) in runners.items():
            for n in (1, NBIG):
                best[(name, n)] = min(best[(name, n)], _timed(
                    f, a, b, n, dev, spin(name, n)))
    for name in runners:
        out[f"kernel_{name}_ms"] = round(
            max(0.0, best[(name, NBIG)] - best[(name, 1)]) * 1000
            / (NBIG - 1), 5)
    return out


def kernel_impls(dev) -> dict:
    if dev.type == "cuda":
        return {"pallas": "hand-written CUDA kernel for sm_90a "
                          "(cronsun_tpu_torch/csrc/bid_argmin.cu, "
                          "fanout_add.cu), timed with CUDA events",
                "jnp": "plain PyTorch version on the card "
                       "(ops/kernels.py bid_argmin_plain, fanout_add_plain)"}
    return {"pallas": "plain PyTorch version: the wrappers run it on CPU "
                      "tensors (no kernel), timed on the host clock",
            "jnp": "plain PyTorch version on the CPU"}


def config1(quick: bool, dev) -> dict:
    """100 jobs on one node (``bench.py:273-285``): 60 specs at second
    i % 60 and 40 every second, every row exclusive and eligible on node
    0 alone, whose capacity never runs out; sync plan p50/p99."""
    import torch
    from ..cron.parser import parse
    from ..ops.planner import TickPlanner
    from ..ops.schedule_table import build_table
    p1 = TickPlanner(job_capacity=128, node_capacity=32, max_fire_bucket=128,
                     device=dev)
    specs = [parse(f"{i % 60} * * * * *") for i in range(60)] + \
        [parse("* * * * * *")] * 40
    p1.set_table(build_table(specs, capacity=p1.J, device=dev))
    p1.elig = torch.ones_like(p1.elig)
    p1.exclusive = torch.ones(p1.J, dtype=torch.bool, device=dev)
    p1.set_node_capacity([0], [1 << 20])
    bench_ticks_sync(p1, T0, 3)  # warm
    lat1 = bench_ticks_sync(p1, T0 + 10, 10 if quick else 60)
    return {"c1_100job_tick_p50_ms": pct(lat1, 50),
            "c1_100job_tick_p99_ms": pct(lat1, 99)}


def config2(specs, quick: bool, dev):
    """Batched next-fire over config 2's mixed specs (``bench.py:287-311``;
    :func:`run_cells` draws them with ``synth.bench_mixed_specs`` from the
    bench's ``rng``, in ``bench.py``'s order).  Returns the keys and the
    next-fire values of every timed call."""
    from ..cron.parser import parse
    from ..ops.schedule_table import build_table
    from ..ops.tick import next_fire
    t2 = build_table([parse(s) for s in specs], phase_epoch_s=T0,
                     device=dev)
    next_fire(t2, T0)  # warm
    ts, values = [], []
    for i in range(3 if quick else 10):
        s = time.perf_counter()
        r = next_fire(t2, T0 + i * 37)
        ts.append((time.perf_counter() - s) * 1000)
        values.append(r)
    return ({"c2_10k_nextfire_p50_ms": round(float(np.median(ts)), 2),
             "c2_10k_nextfire_resolved": int((r >= 0).sum())}, values)


def split_bucket(bucket: int) -> Tuple[int, int]:
    """Half the combined SLA a kind (about half the synthetic rows are
    exclusive), at least 2048 each."""
    return (max(2048, bucket // 2), max(2048, bucket // 2))


def ladder_planner(rng, J, N, fire_rate, caps, bucket, dev):
    """A planner of ``J`` ``@every`` rows whose periods give a fire rate
    near ``fire_rate``, random eligibility over ``N`` nodes, about half the
    rows exclusive (drawn from ``rng``) and every node at ``caps``."""
    import torch
    from ..ops.planner import TickPlanner
    from ..synth import synth_table
    p = TickPlanner(job_capacity=J, node_capacity=N,
                    max_fire_bucket=max(bucket), device=dev)
    period_lo = max(2, int(1 / fire_rate * 0.7))
    period_hi = max(period_lo + 2, int(1 / fire_rate * 1.4))
    p.set_table(synth_table(p.J, period_lo, period_hi, device=dev))
    p.elig = random_bits(1, (p.J, p.N // 32), dev)
    p.exclusive = torch.as_tensor(rng.random(p.J) < 0.5, device=dev)
    p.set_node_capacity(np.arange(p.N), np.full(p.N, caps))
    return p


def ladder(name, p, bucket, ticks) -> dict:
    """One rung of configs 3-5 (``bench.py:314-335``) on ``p``."""
    bench_ticks(p, T0, 3, sla=bucket)  # warm
    sus = bench_ticks(p, T0 + 100, ticks, sla=bucket)
    lat = bench_ticks_sync(p, T0 + 1000, max(5, ticks // 2), sla=bucket)
    fired = p.gather(p.plan_async(T0 + 2000, sla_bucket=bucket)).fired
    return {f"{name}_sustained_ms": round(sus, 2),
            f"{name}_sync_p50_ms": pct(lat, 50),
            f"{name}_sync_p99_ms": pct(lat, 99),
            f"{name}_fired_per_tick": int(len(fired))}


def headline_planner(rng, dev, shapes: Shapes = BENCH_SHAPES):
    """``bench.py:353-359``: ``@every`` periods in [35, 70), random
    eligibility, half the rows exclusive, capacity that never runs out."""
    import torch
    from ..ops.planner import TickPlanner
    from ..synth import EVERY_PERIODS, synth_table
    p = TickPlanner(job_capacity=shapes.headline_jobs,
                    node_capacity=shapes.headline_nodes,
                    max_fire_bucket=shapes.headline_bucket, device=dev)
    p.set_table(synth_table(p.J, *EVERY_PERIODS, device=dev))
    p.elig = random_bits(2, (p.J, p.N // 32), dev)
    p.exclusive = torch.as_tensor(rng.random(p.J) < 0.5, device=dev)
    p.set_node_capacity(np.arange(p.N), np.full(p.N, 1 << 20))
    return p


def headline(p, quick: bool, sla) -> "tuple[dict, float]":
    """Windowed planning at W = 8 (``bench.py:352-384``): p50/p99 over the
    per-window completion intervals of 1 pass of 12 windows (quick) or 2
    passes of 60; then, full runs only, W = 32 over 52 windows."""
    W = 8
    out = {}
    bench_windows(p, T0, 2, W, sla=sla)  # warm
    reps = 1 if quick else 2
    rep_intervals = [
        window_intervals(p, T0 + 10_000 * r, 12 if quick else 60, W, sla=sla)
        for r in range(reps)]
    per_win = np.concatenate(rep_intervals)
    out["headline_rep_p99s_ms"] = [pct(x, 99) for x in rep_intervals]
    p50 = float(np.percentile(per_win, 50))
    p99 = float(np.percentile(per_win, 99))
    fired = p.gather(p.plan_async(T0 + 50000, sla_bucket=sla)).fired
    out["headline_windowed_p50_ms_per_tick"] = round(p50, 2)
    out["headline_windowed_p99_ms_per_tick"] = round(p99, 2)
    out["headline_window_samples"] = int(len(per_win))
    out["headline_window_s"] = W
    out["headline_fired_per_tick"] = int(len(fired))
    out["headline_jobs_per_sec_per_chip"] = int(len(fired) / (p99 / 1000))
    # the throughput-optimal cadence, a secondary figure
    if not quick:
        bench_windows(p, T0 + 80_000, 1, 32, sla=sla)   # warm W=32
        w32 = window_intervals(p, T0 + 90_000, 52, 32, sla=sla)
        out["w32_windowed_p50_ms_per_tick"] = pct(w32, 50)
        out["w32_windowed_p99_ms_per_tick"] = pct(w32, 99)
        out["w32_window_samples"] = int(len(w32))
    return out, p99


def run_cells(quick: bool, dev, shapes: Shapes = BENCH_SHAPES,
              detail: Optional[dict] = None, on_cell=None):
    """Every in-process cell in ``bench.py``'s order, into ``detail``;
    ``on_cell(detail)`` after each.  Returns (detail, headline p99 ms)."""
    detail = {} if detail is None else detail
    on_cell = on_cell or (lambda d: None)
    rng = np.random.default_rng(0)
    detail.update(stream_sync_floor(dev))
    detail.update(kernel_cells(*kernel_inputs(rng, quick, dev, shapes),
                               quick, dev))
    detail["kernel_impls"] = kernel_impls(dev)
    log(f"kernels_equal={detail['kernels_equal']} "
        f"wide={detail.get('kernels_equal_wide', 'n/a')} "
        f"rtt_floor={detail['rtt_floor_ms']}ms")
    log("kernel ms/call: " + " ".join(
        f"{k}={v}" for k, v in sorted(detail.items())
        if k.startswith("kernel_") and k.endswith("_ms")))
    on_cell(detail)
    log("config 1: 100-job single-node tick")
    detail.update(config1(quick, dev))
    log("config 2: 10k mixed cron specs, batched next-fire")
    from ..synth import bench_mixed_specs
    specs = bench_mixed_specs(shapes.c2_specs, rng=rng)
    detail.update(config2(specs, quick, dev)[0])
    on_cell(detail)
    n_ticks = 6 if quick else 30
    for name, J, N, rate, caps, bucket in shapes.ladders:
        log(f"{name}: {J} jobs x {N} nodes, fire~{rate:.0%}")
        bucket = split_bucket(bucket)
        p = ladder_planner(rng, J, N, rate, caps, bucket, dev)
        detail.update(ladder(name, p, bucket, n_ticks))
        del p
        on_cell(detail)
    log("headline: 1M x 10k windowed (W=8)")
    p = headline_planner(rng, dev, shapes)
    keys, p99 = headline(p, quick, shapes.sla)
    del p
    detail.update(keys)
    on_cell(detail)
    return detail, p99


# ---------------------------------------------------------------- planes

@dataclasses.dataclass(frozen=True)
class Plane:
    """One subprocess plane of ``bench.py``: its script, argv in quick
    (None: full runs only) and full runs, timeout, environment over the
    caller's, error key, merge rule (``update``; ``stamped``: the child's
    ``git_rev``/``generated_at_utc`` dropped first; ``native``: the
    ``plane_`` -> ``plane_native_`` renames of ``bench.py:439-457``), the
    sidecar a full run writes (``--out <detail dir>/<out>``), and whether
    the script places a planner (``--device``)."""
    name: str
    script: str
    quick: Optional[tuple]
    full: tuple
    timeout: int
    error: str
    note: str
    env: tuple = ()
    merge: str = "update"
    out: Optional[str] = None
    device: bool = False


_NATIVE = (("BENCH_AGENT", "native"),)

PLANES = (
    Plane("dispatch", "bench_dispatch",
          ("--rates", "500,1000", "--seconds", "3", "--agent-sweep", "1"),
          ("--rates", "2000,10000,40000,80000", "--seconds", "3",
           "--agent-sweep", "1,2,4,8"),
          1800, "dispatch_plane_error",
          "dispatch plane: store+agents end-to-end sweep"),
    Plane("dispatch_native", "bench_dispatch", None,
          ("--rates", "5000,20000,40000,80000", "--seconds", "3",
           "--agent-sweep", "1,2"),
          1800, "dispatch_plane_native_error",
          "dispatch plane: native agents", env=_NATIVE, merge="native"),
    Plane("shard_ladder", "bench_dispatch", None,
          ("--rates", "150000", "--seconds", "3", "--agents", "8",
           "--shard-ladder", "1,2,4"),
          1800, "dispatch_plane_shard_ladder_error",
          "dispatch plane: store shard ladder 1/2/4",
          env=_NATIVE + (("BENCH_STORE", "py"),)),
    Plane("logd_ladder", "bench_dispatch", None,
          ("--rates", "60000", "--seconds", "3", "--agents", "4",
           "--logd-shards", "1,2,4"),
          1800, "result_plane_logd_ladder_error",
          "result plane: logd shard ladder 1/2/4",
          env=_NATIVE + (("BENCH_LOGD", "py"),)),
    Plane("query", "bench_query",
          ("--logd-shards", "1", "--readers", "4", "--seconds", "2"),
          ("--logd-shards", "2", "--readers", "6", "--seconds", "4",
           "--cold-fraction", "0.2"),
          600, "query_plane_error",
          "query plane: concurrent readers under full-drain writes"),
    Plane("push", "bench_push",
          ("--viewers", "150", "--seconds", "3", "--write-rate", "50"),
          ("--viewers", "1000", "--seconds", "8", "--write-rate", "20"),
          600, "push_plane_error",
          "push plane: SSE fan-out vs poll at equal freshness"),
    Plane("push_ladder", "bench_push",
          ("--replicas", "1,2", "--viewers", "100", "--seconds", "3",
           "--write-rate", "20"),
          ("--replicas", "1,2,4", "--viewers", "400", "--seconds", "6",
           "--write-rate", "20"),
          900, "push_ladder_error",
          "push plane: web-replica scale-out ladder", merge="stamped",
          out="PUSH_ladder.json"),
    Plane("store_stall", "bench_store",
          ("--stall-probe", "--stall-keys", "50000"),
          ("--stall-probe", "--stall-keys", "200000"),
          600, "snapshot_stall_probe_error",
          "store: snapshot write-stall probe (full-lock vs staggered)"),
    Plane("mesh", "bench_mesh", ("--quick",),
          ("--devices", "1,2,4,8", "--shapes", "65536x1024"),
          12660, "multichip_ladder_error", "multichip: mesh latency ladder",
          merge="stamped", out="MULTICHIP_ladder.json", device=True),
    Plane("sched", "bench_sched", None,
          ("--jobs", "1000000", "--nodes", "10240", "--steps", "30"),
          3600, "sched_bench_error",
          "scheduler system: full step + failover @ 1M jobs", device=True),
    Plane("partition_ladder", "bench_sched", None,
          ("--partition-ladder", "1,2,4", "--jobs", "200000", "--nodes",
           "1024", "--steps", "6"),
          3600, "partition_ladder_error",
          "partitioned scheduler plane: ladder 1,2,4 @ 200k jobs",
          device=True),
    Plane("dag", "bench_sched", None,
          ("--dag", "--jobs", "50000", "--nodes", "512", "--rounds", "3"),
          3600, "dag_bench_error",
          "workflow DAG plane: chain latency @ 50k jobs x 512 nodes",
          device=True),
    Plane("trace", "bench_sched", None,
          ("--trace", "--jobs", "50000", "--nodes", "512", "--seconds", "8"),
          1800, "trace_bench_error",
          "trace plane: stage breakdown + overhead @ 50k x 512", device=True),
    Plane("herd", "bench_sched", None,
          ("--herd", "--jobs", "50000", "--nodes", "512", "--jitter", "30"),
          1800, "herd_bench_error",
          "herd smearing: minute-boundary A/B @ 50k x 512", device=True),
    Plane("tenants", "bench_sched", None,
          ("--tenants", "--victim-jobs", "2000", "--noisy-rate", "100",
           "--seconds", "60"),
          1800, "tenant_bench_error",
          "multi-tenant admission: skewed-tenant workload", device=True),
)

# the native-agent dispatch keys bench.py renames plane_ -> plane_native_
NATIVE_RENAMED = (
    "dispatch_plane_exec_lag_p50_s", "dispatch_plane_exec_lag_p99_s",
    "dispatch_plane_exec_lag_net_p50_s", "dispatch_plane_exec_lag_net_p99_s",
    "dispatch_plane_exec_lag_offset_s",
    "dispatch_plane_agent_records_per_flush",
    "dispatch_plane_logd_records_per_batch", "dispatch_plane_logd_op_stats",
    "dispatch_plane_records_dropped")


def plane_argv(plane: Plane, quick: bool, out_dir: str,
               device: str = "cuda") -> Optional[list]:
    """The plane's command, or None where this run skips it."""
    args = plane.quick if quick else plane.full
    if args is None:
        return None
    argv = [sys.executable, "-m", f"cronsun_tpu_torch.scripts.{plane.script}",
            *args]
    if plane.out and not quick:
        argv += ["--out", os.path.join(out_dir, plane.out)]
    if plane.device and device == "cpu":
        argv += ["--device", "cpu"]
    return argv


def merge_plane(plane: Plane, detail: dict, res: dict) -> None:
    """Merge a plane's JSON into ``detail`` as ``bench.py`` does."""
    if plane.merge == "native":
        for key in ("backend", "orders_per_sec", "saturation_offered_per_sec",
                    "agent_curve"):
            detail[f"dispatch_plane_native_{key}"] = res.get(
                f"dispatch_plane_{key}")
        for k in NATIVE_RENAMED:
            if k in res:
                detail[k.replace("plane_", "plane_native_")] = res[k]
        return
    if plane.merge == "stamped":
        # the parent's provenance stamp wins over the child's
        res.pop("git_rev", None)
        res.pop("generated_at_utc", None)
    detail.update(res)


def run_planes(detail: dict, quick: bool, out_dir: str, device: str = "cuda",
               run=subprocess.run, on_plane=None) -> None:
    """Every plane this run takes, in order; each one's output to
    ``bench_<name>.log`` in ``out_dir`` and ``on_plane(detail)`` after it."""
    for plane in PLANES:
        argv = plane_argv(plane, quick, out_dir, device)
        if argv is None:
            continue
        log(plane.note)
        kw = {"env": {**os.environ, **dict(plane.env)}} if plane.env else {}
        t = time.perf_counter()
        try:
            proc = run(argv, capture_output=True, text=True,
                       timeout=plane.timeout, cwd=ROOT, **kw)
            _keep_log(out_dir, plane, argv, proc, time.perf_counter() - t)
            if proc.returncode == 0:
                merge_plane(plane, detail, json.loads(proc.stdout))
            else:
                detail[plane.error] = proc.stderr[-500:]
        except Exception as e:  # noqa: BLE001 — the other planes still run
            detail[plane.error] = str(e)
        log(f"  {plane.name}: {time.perf_counter() - t:.1f} s"
            + (f", {plane.error}" if plane.error in detail else ""))
        if on_plane:
            on_plane(detail)


def _keep_log(out_dir, plane, argv, proc, seconds) -> None:
    with open(os.path.join(out_dir, f"bench_{plane.name}.log"), "w") as f:
        f.write(f"# {' '.join(argv)}\n# exit {proc.returncode} after "
                f"{seconds:.1f} s\n# stdout\n{proc.stdout}\n"
                f"# stderr\n{proc.stderr}")


# ---------------------------------------------------------------- main

def write_detail(path: str, detail: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(detail, f, indent=1)
    os.replace(tmp, path)


def header(dev) -> dict:
    import torch
    on_card = dev.type == "cuda"
    return {"backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "nvidia_smi": nvidia_smi_line() if on_card else None,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "git_rev": git_rev(), "generated_at_utc": utc_now()}


def result_line(p99: float) -> dict:
    return {"metric": METRIC, "value": round(p99, 2), "unit": "ms",
            "vs_baseline": round(TARGET_MS / p99, 3)}


def run(quick: bool, dev, detail_path: str = DEFAULT_DETAIL,
        shapes: Shapes = BENCH_SHAPES):
    """The whole bench on ``dev`` (a resolved torch device): the in-process
    cells, then the planes.  Returns (detail, result line)."""
    out_dir = os.path.dirname(os.path.abspath(detail_path))
    os.makedirs(out_dir, exist_ok=True)
    if dev.type == "cuda":
        from ..ops import _build
        log(f"kernels built in {_build.build():.2f} s")
    detail = header(dev)
    check_artifact_provenance(detail["git_rev"], detail_path)

    def save(d):
        write_detail(detail_path, d)
    detail, p99 = run_cells(quick, dev, shapes, detail, on_cell=save)
    run_planes(detail, quick, out_dir, dev.type, on_plane=save)
    save(detail)
    log(json.dumps(detail, indent=1))
    return detail, result_line(p99)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the quick ladder (fewer ticks and windows, no wide "
                         "kernel rung, no W = 32, the quick planes only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the in-process cells run (default: the card)")
    ap.add_argument("--detail", default=DEFAULT_DETAIL, metavar="PATH",
                    help="the detail file (default: %(default)s)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: --device {args.device}: {e}", file=sys.stderr)
        return 1
    _, line = run(args.quick, dev, args.detail)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
