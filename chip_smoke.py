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
   closed, all loads equal, the bench phases' fleets (W32 = 1, 8, 16, and
   313 and 3125, wide and unaligned), and buckets of rows of a larger
   table with ``rows`` (repeats, row 0 as padding) and ``active``
   (random, prefix), at W32 = 1 to 3200.
   K1n bid_argmin_natural against ``bid_block_plain(col0,
   bitplane_ties=False)``, best and choice exactly: node blocks at col0 0,
   32 and 5120, past shared memory, W32 = 5 and 7, one row, all loads
   equal, all nodes closed, W32 = 1 to 3125, and buckets with ``rows``
   and ``active``.
4. kernel_times — on a synthetic tile at the main path's shape (K = 16384,
   N = 10240, no gather): each kernel's time (also timed back to back
   without a pre-filled stream, and with no row to work on), its plain
   version's time, the least time the card could take, and the kernels the
   card ran for one call (torch.profiler); K1n on the 2-D mesh
   headline's per-shard node block (K = 8192, N = 5120, col0 5120).
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
9. plan_equivalence_armed — phase 5's shape with both arms armed: a
   3-stage DAG (every misfire policy) and Zipf tenants with a noisy one
   over quota; caps 2 re-opened every window, so the fair share clamps;
   completions of fired upstream rows are folded between windows.  Every
   TickPlan field (tenant counts too) and the final load, rem_cap,
   dep_last_fire and tb_tokens identical, card against CPU.
10. headline_armed — phase 7's deployment with 2^17 dep rows and 64
   tenants armed (``--windows`` timed windows, dispatched as a
   deployment's normal windows, so tenant tokens carry), completions
   folded from each gathered window, both kernels' launch counts set to 0
   before its run and read after; the plans are checked in numpy against
   the state (due rows fired or shed, no fire neither due nor
   dep-satisfied, the noisy tenant within a replay of its bucket and its
   final tokens equal to the replay's, victims never refused).
   ``--profile`` adds a profiler pass.
11. next_fire — BASELINE config 2 (10k mixed specs): 10 calls in UTC and
   one in America/New_York 3 days before a DST change, card == CPU; then
   2^20 rows of the same mix, timed, held against the CPU on a 65536-row
   slice.
12. service — the port's ``SchedulerService`` over its in-process
   ``MemStore``, seeded with ``scripts/bench_sched.py``'s deployment
   (100 000 jobs x 1024 nodes, ``synth.seed_service_store``) at a pinned
   clock.  One service on the card and one on the CPU cold-load and step
   ``SERVICE_CHECK_WINDOWS`` + 1 windows of 4 s (serial mode); their
   published orders and high-water marks must be byte-identical.  The
   script plays the agents on the card service's orders: each (job,
   second) runs once behind a fence, re-deliveries only of seconds
   re-planned for overflow, exclusive fires one node each on a live
   eligible node, and every (job, second) a scalar evaluation of the
   job's spec says is due in the first ``SERVICE_CHECK_WINDOWS`` windows
   runs.  Then ``SERVICE_TIMED_STEPS`` steps in the pipelined mode are
   timed, with both kernels' launch counts set to 0 before and read after
   (``launches_service``), and a checkpoint of the card service restores
   into a fresh card service on the same store whose first window's
   orders equal the cold-loaded service's.
13. launcher — the same deployment (seeded at the wall clock) served by
   the port's ``StoreServer`` inside this script, and two scheduler
   processes, ``python3 -m cronsun_tpu_torch.bin.sched`` with no
   ``--device`` (so on the card): the leader cold-loads over TCP, the
   standby starts once the leader's first checkpoint is on disk (so it
   restores it); each one's seconds to ``READY``.  The script plays the
   agents on a watch of the order prefix through the port's
   ``RemoteStore`` (phase 12's rules; a lost watch fails).  After
   ``LAUNCHER_WINDOWS`` leader windows every due (job, second) up to the
   high-water mark ran once; then the leader is SIGKILLed, the seconds
   to the new leader's first order are taken, and after
   ``LAUNCHER_WINDOWS`` more windows every due second from the first
   ran once, a second delivered twice is one the new leader re-planned
   from the dead leader's mark (or an overflow re-plan), and neither
   leader skipped a second.  SIGTERM stops the survivor: exit 0, and its
   logged launch counts of both kernels above 0 (``launches_launcher``).
   The first process runs with ``--profile-port``: while it leads, a
   thread of this script takes one ``LAUNCHER_CAPTURE_MS`` capture
   (``stack=0``) over HTTP, opened a second before one of its steps, and
   the trace must hold device events of both kernels and the ranges
   ``cronsun.plan.dispatch``, ``cronsun.fire_mask`` and
   ``cronsun.assign`` on threads other than the server's.  Printed
   (``launcher_capture``): the gzip bytes, the seconds from the session's
   end to the file, the device's busy share over the window, the top five
   device ops and the top five host ranges.
14. mesh_equivalence — the mesh planners with every shard on the card
   (``cuda:0``) against the same planners on the CPU, from phase 5's
   seeded state (65536 jobs x 1024 nodes, W = 4,
   ``MESH_EQUIVALENCE_WINDOWS`` windows, caps 4 re-opened every
   window): the 1-D mesh at D = 2 and the 2-D mesh at
   2 x 2, each bucket-sharded with dense and with compacted demand and
   replicated.  Every TickPlan field, the final load and rem_cap
   identical.
15. mesh_headline — phase 7's deployment (2^20 jobs x 10240 nodes, W = 8,
   rounds 2) on the 1-D mesh at D = 2 and the 2-D mesh at 2 x 2, shards on
   ``cuda:0``, one bucket of 32768 rows (k_local 16384): a warm-up window
   and ``MESH_HEADLINE_WINDOWS`` timed windows, the launch counts set to
   0 before and read after (``launches_mesh``; K1 on the 1-D mesh, K1n on
   the 2-D one, K2 on both), ms per planned second, the plans checked in
   numpy (every due row fired, every fire due, every exclusive fire on an
   eligible node within capacity) and the bytes the collectives moved per
   tick equal to ``estimate_collective_bytes``.
16. mesh_launcher — phase 13's deployment served by the in-script
   ``StoreServer`` to two scheduler processes on the card forming one
   mesh, ``--mesh 2 --mesh-hosts 2 --mesh-proc-id 0|1`` (gloo between
   them): both ranks' seconds to ``READY``; over
   ``MESH_LAUNCHER_WINDOWS`` leader windows every due (job, second) runs
   once; SIGTERM to rank 0: exit 0 with K1 and K2 launched, and the worker
   released with exit 0 and its plan steps logged.
17-22. The port's benches (``cronsun_tpu_torch.scripts``) at their
   deployment shapes, each with the launch counts set to 0 before and read
   after (``launches_<phase>``; K1 and K2 in every ``sched_*`` phase, and
   K1n too in ``mesh_ladder``), its seconds, and the gates of the JAX
   script's own tests.  The first call of each kernel at each shape the
   run gives it (at most ``PATH_CALLS_PER_KERNEL``) keeps its inputs and
   outputs, held against the plain version after the run (``path_checks``;
   every kernel the run launched must have one); a step that ``run_bench``
   retried fails the phase; ``host_clock`` splits each rung or arm's steps
   into wall, thread and process CPU, and collection time, with the
   services' span percentiles.  The full result goes to
   ``chiprun_out/<phase>.json``:
   ``sched_bench`` (``run_bench``, 100 000 jobs x 1024 nodes, 10 steps:
   the warm takeover restores with 0 divergent orders over a non-empty
   window, 0 publish failures), ``sched_dag`` (``run_dag_bench`` at its
   defaults: every dep fire once, no round incomplete, 0 divergence
   after the warm takeover), ``sched_tenants`` (``run_tenant_bench`` at
   its defaults: victims exactly once and never throttled, the noisy
   tenant throttled and within 5 % of its quota), ``sched_partitions``
   (``run_partition_ladder`` at 40 000 x 256, P = 1, 2, 4: 0 divergence
   and the P = 1 fire count on every rung, fairness >= 0.8), ``sched_herd``
   (``run_herd_bench`` at 50 000 x 512, jitter 30: no duplicate, missing
   or off-reference fire in either arm) and ``mesh_ladder``
   (``run_ladder`` at 65536 x 1024, D = 1, 2, 4, then the sparse rungs of
   ``--quick --sparse``; shards share ``cuda:0``: measured collective
   bytes = the byte model on every rung, every divergence check 0).
23. chaos_drills — every drill of ``cronsun_tpu_torch.scripts.bench_chaos``
   (``DRILLS``, at its default seed and size, in order; ``native_smoke``
   only where the native store and result-store binaries are found, else a
   line says it was skipped), every drill's schedulers on the card, then
   the replica drill at seeds 44 and 45 and its unreplicated control arm.
   Held with the JAX tests' gates (``tests/test_chaos.py``,
   ``test_chaos_drills.py``, ``test_repl.py``): no finding, recovery under
   16 s, the brownout bounds, the control arm losing acked probes; K1 and
   K2 launched, the kept calls equal to plain (as in 17-22), and the card's
   allocated bytes back within ``CARD_BYTES_LEFT_BY_DRILLS`` of before once
   every fleet closed.  Per drill: wall seconds, recovery, executions,
   injected faults; for the replica drill at each seed its recovery (to
   the plan cursor passing its end, as the JAX harness clocks it), the
   seconds of the drive's trailing quiesce, and any publisher whose flush
   timed out (a ``publish_flush_timeout`` finding: scheduler, stage,
   windows in flight, high-water mark written and wanted).
24. sched_trace — ``run_trace_bench`` at its defaults (50 000 jobs x 512
   nodes, 64 traced jobs pinned to two node agents, 8 live seconds, 12
   paired steps, W = 4): sampled fires with every wire stage (publish,
   claim, queue, run, record) present and non-negative, both overhead arms
   measured, K1 and K2 launched; the reference's overhead gate (< 2 % + 1
   ms of step p99) is printed, not held.
25. process_fleet — a deployment of the port's processes only, each
   ``python3 -m cronsun_tpu_torch.bin.<role>``: ``store --shards 2
   --wal`` (Python backend), ``logd --shards 2`` (the agents and the web
   get the comma-joined shard set, so the sharded sink is on the path),
   ``sched`` on the card, two ``node`` agents and ``web`` with its HTTP
   noticer pointed at a receiver in this script.  Before the scheduler
   starts the store is seeded through a client with the trace bench's
   deployment (``PROCESS_FLEET_JOBS`` x ``PROCESS_FLEET_NODES`` phantom
   nodes, registered with no agent).  A per-second Common, Alone and
   Interval job on both agents are created through the REST API and
   driven ``PROCESS_FLEET_LIVE_S`` seconds from the first execution
   ``/v1/stream`` shows.  Held: the compute apps nvidia-smi lists hold
   more MiB than before the fleet, and of the fleet's pids only the
   scheduler's holds the card's device file open (its CUDA context; the
   chip machine's nvidia-smi shows every pid as 1), both agents connected at ``/v1/nodes``,
   scheduler steps at ``/v1/metrics``; after a SIGKILL of one agent,
   ``/v1/nodes`` shows it disconnected and its node-down alert reaches
   the receiver within ``node_ttl`` + 5 s; SIGTERM stops every other
   process with exit 0, the scheduler logging K1 and K2 launches; up to
   the crash each (job, second) of the Interval job ran once across the
   agents, the Alone job's at most once (a fire its previous run's
   fleet-wide lock still holds is skipped, as in the reference; counted)
   and the Common job on both every second;
   ``/v1/logs``' total equals the sharded sink's; no local ``log_db``.
   The port's CLI (``python3 -m cronsun_tpu_torch.bin.ctl``) logs in,
   triggers three scheduler checkpoints through the live seconds (the
   scheduler's ``checkpoint_dir``: a base, then deltas), audits the live
   fleet with ``fsck`` over the 2-shard store and result store (exit 0,
   no finding) and, once the scheduler stopped, folds its delta chain
   with ``checkpoint-compact`` (exit 0).
   Printed: each process's READY seconds, the seed seconds, the
   scheduler's step p50/p99, the web's p50/p99 over
   ``PROCESS_FLEET_WEB_REQUESTS`` requests each of ``/v1/logs``,
   ``/v1/nodes`` and ``/v1/metrics``, executions, the alert's delay,
   the card's used MiB before and after.  Process logs go to
   ``chiprun_out/fleet_<name>.log``.
26. demo_ctl — the port's one-process demo, ``cronsun_tpu_torch.demo``
   (``--nodes 4 --port <free port>``, no ``--device``: the scheduler on
   the card, its table at the conf's 65536 jobs x 1024 nodes), run as
   ``python3 -m chip_smoke --demo-child OUT <demo flags>`` (the demo's
   ``main``, with the launch counts set to 0 before it and read after it,
   and one call of each kernel at each shape kept and held against plain
   once it stopped, as in 17-22), driven only through the port's CLI:
   ``login``, ``version``, ``job import`` of ``DEMO_JOBS`` jobs (half
   Common, half Alone, ``*/10 * * * * *`` on the demo's four nodes, each
   run printing its scheduled second),
   ``jobs``, ``nodes``, ``executing``, ``sched status``, ``run`` (a seeded
   job, once), ``checkpoint``, ``tenant set``/``show``, ``slo set``/
   ``show``, ``trace top``, a ``logs --follow`` process through the live
   seconds and ``logs --json`` paged at the end.  After ``DEMO_LIVE_S``
   live seconds: every imported job ran, each Alone (job, second) at
   most once and each Common one on all four nodes (``check_demo_runs``);
   the compute apps hold more MiB than before and the demo's pid holds
   the card's device file, the CLI's does not; SIGTERM: exit 0 and the
   ``executed N runs across M nodes`` line, N at least the runs read and
   M in 1..4 (the nodes of the sink's newest 50 records); K1 and K2
   launched, the kept calls equal to plain.  The processes' logs go to ``demo_<name>.log``
   beside the other phases' (``OUT_DIR``).
27. host_benches — the port's four host-plane benches at the shapes of
   their JAX smoke tests (``tests/test_bench_smoke.py``) on the Python
   store and result store: ``bench_dispatch.run_quick`` (3 s a rung),
   ``bench_store.run_stall_suite`` (100 000 keys), ``bench_query.
   run_query_bench`` (1 shard, 3 readers, 1.5 s, 1000 records) and
   ``bench_push.run_push_bench`` (20 viewers, 1.5 s, 50 records/s, 3
   poll viewers).  Each prints its JSON keys and result; no error row,
   and no process any of them starts holds the card's device file
   (``ChildContexts`` samples every descendant).
28. bench_quick — the port's bench, ``cronsun_tpu_torch.scripts.bench
   --quick``, in this process on the card (its in-process cells: the
   stream-sync floor, K1 and K2 against plain at K = 2048, N = 10240 and
   timed, configs 1-5 and the headline at 2^20 x 10240, W = 8; then its
   quick subprocess planes), with the launch counts set to 0 before and
   read after (``launches_bench``) and the kept calls held against plain
   (as in 17-22).  Held: the result line has exactly ``bench.py``'s four
   keys with a value above 0, ``kernels_equal``, every
   ``*_fired_per_tick`` above 0, no ``*_error`` key but a native-agent
   plane's.  The detail goes to ``chiprun_out/bench_detail_torch.json``.

Then each phase's seconds, the kernels line, the nvidia-smi line, and as
the last line
``{"ok": true, "device": {...}}``.  Any failed check raises before it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
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
EPOCH = 1577836800         # FRAMEWORK_EPOCH: device epochs are relative to it
SPIN_CYCLES = 20_000_000   # ~11 ms at the H100's 1.755 GHz boost clock
PATH_WINDOWS = 4           # headline windows planned before the path capture
# the armed headline: dep rows, the noisy tenant's @every 1s rows, the DAG
# sources' @every periods (4x the headline's, so each window's burst of
# dep fires stays inside the buckets) and the failed share of completions
ARMED_DEP_ROWS = 1 << 17
NOISY_ROWS = 16384
SOURCE_PERIODS = (140, 280)
FAIL_SHARE = 0.1
# the noisy tenant's burst over its rate: above 1 a bucket whose carried
# tokens were lost (reset to full) admits more than the replay allows
NOISY_BURST = 2.0
# profiler events that make the host wait for the device: a tensor's value
# read back (aten::item) and a stream drained
SYNC_EVENTS = ("aten::item", "aten::_local_scalar_dense",
               "cudaStreamSynchronize", "cudaEventSynchronize")
# the service phase: scripts/bench_sched.py's default deployment (its
# --jobs / --nodes / --window); the pinned clock is 20 s before a minute
# boundary, so the checked windows hold the */k herd second
SERVICE_JOBS = 100_000
SERVICE_NODES = 1024
SERVICE_WINDOW = 4
SERVICE_CHECK_WINDOWS = 8
SERVICE_TIMED_STEPS = 30
SERVICE_NOW = T0
# the launcher phase: leader windows checked before the SIGKILL and again
# after the takeover (4, not 8 since the bench phases joined the script:
# each window is 4 s of wall time), and the leader's checkpoint period
# (seconds)
LAUNCHER_WINDOWS = 4
LAUNCHER_CKPT_INTERVAL = 6
LAUNCHER_CAPTURE_MS = 2000
LAUNCHER_RANGES = ("cronsun.plan.dispatch", "cronsun.fire_mask",
                   "cronsun.assign")
# the kernels a single-device planner launches (K1n runs on the 2-D mesh)
SINGLE_DEVICE_KERNELS = ("bid_argmin", "fanout_add")
# the mesh phases: windows each mesh planner plans on the card and on the
# CPU, timed windows of each mesh headline, and the leader windows the
# mesh launcher phase checks
MESH_EQUIVALENCE_WINDOWS = 5
MESH_HEADLINE_WINDOWS = 8
MESH_LAUNCHER_WINDOWS = 4
# the bench phases: run_bench's timed steps (scripts/bench_sched.py's
# --steps default), the partition ladder's rungs and the mesh ladder's
# timed ticks per rung (scripts/bench_mesh.py's --ticks default)
SCHED_BENCH_STEPS = 10
SCHED_PARTITIONS = (1, 2, 4)
MESH_LADDER_TICKS = 20
PATH_CALLS_PER_KERNEL = 16  # calls of each kernel a bench phase keeps
# the chaos drills: card bytes still allocated once every fleet closed
# (one 256 x 64 service's planner holds several MB)
CARD_BYTES_LEFT_BY_DRILLS = 1 << 20


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


def _check_k1n(k, name, packed, load, col0, rows=None, active=None):
    """K1n equal to its plain version (best and choice exactly)."""
    import torch
    best_p, choice_p = k.bid_argmin_natural_plain(packed, load, col0, rows,
                                                  active)
    best, choice = k.bid_argmin_natural(packed, load, col0, rows=rows,
                                        active=active)
    torch.cuda.synchronize()
    if not (torch.equal(choice, choice_p) and torch.equal(best, best_p)):
        bad = int((choice != choice_p).sum())
        raise AssertionError(f"K1n {name}: {bad} choices differ")
    return {"case": name, "K": int(best_p.shape[0]),
            "N": packed.shape[1] * 32, "col0": col0,
            "rows": None if rows is None else int(rows.shape[0]),
            "active": None if active is None else int(active.sum()),
            "no_candidate": int((~torch.isfinite(best_p)).sum()),
            "max_abs": k1_max_abs(best, best_p), "equal": True}


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
             ("one_row", 1, 320),
             # the bench phases' fleets: 8 to 100k nodes
             ("bench_w1", 4096, 1), ("bench_w8", 8192, 8),
             ("bench_w16", 16384, 16), ("bench_w313", 2049, 313),
             ("bench_w3125", 1023, 3125)]
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
            ("bucket_w7", 3000, 999, 7, True),
            ("bucket_w1", 40000, 4096, 1, True),
            ("bucket_w8", 40000, 8191, 8, False),
            ("bucket_w16", 50000, 16384, 16, True),
            ("bucket_w313", 16384, 4095, 313, False),
            ("bucket_w3125", 16384, 2047, 3125, True))):
        table, load, _, _ = _random_tile(J, w32, 100 + seed, dev)
        _, _, w_int, w_frac = _random_tile(K, 1, 200 + seed, dev)
        rows, active = _bucket(K, J, 300 + seed, dev, prefix)
        checks.append(_check_case(k, name, table, load, w_int, w_frac,
                                  rows, active))
    # K1n: node blocks at global offsets (the 2-D mesh's per-block bid)
    k1n = []
    for seed, (name, K, w32, col0) in enumerate((
            ("block_col0_0", 8192, 160, 0), ("block_col0_32", 2048, 160, 32),
            ("block_col0_5120", 8192, 160, 5120),
            ("block_past_48k", 2048, 400, 5120),
            ("block_w5", 999, 5, 32), ("block_w7", 1001, 7, 5120),
            ("block_one_row", 1, 160, 64),
            ("block_w1", 4096, 1, 32), ("block_w8", 8192, 8, 256),
            ("block_w16", 16384, 16, 512), ("block_w313", 2049, 313, 10016),
            ("block_w3125", 1023, 3125, 100000))):
        packed, load, _, _ = _random_tile(K, w32, 400 + seed, dev)
        tiles[name] = (packed, load)
        k1n.append(_check_k1n(k, name, packed, load, col0))
    packed, load = tiles["block_col0_5120"]
    k1n.append(_check_k1n(k, "block_all_loads_equal", packed,
                          torch.zeros_like(load), 5120))
    k1n.append(_check_k1n(k, "block_all_closed", packed,
                          torch.full_like(load, float("inf")), 5120))
    for seed, (name, J, K, w32, col0, prefix) in enumerate((
            ("block_bucket", 65536, 16384, 160, 5120, True),
            ("block_bucket_random_active", 65536, 8191, 160, 0, False),
            ("block_bucket_w5", 3000, 1001, 5, 96, False),
            ("block_bucket_w16", 50000, 16384, 16, 512, True),
            ("block_bucket_w313", 16384, 4095, 313, 0, False),
            ("block_bucket_w3125", 16384, 2047, 3125, 100000, True))):
        table, load, _, _ = _random_tile(J, w32, 500 + seed, dev)
        rows, active = _bucket(K, J, 600 + seed, dev, prefix)
        k1n.append(_check_k1n(k, name, table, load, col0, rows, active))
    emit({"phase": "kernels", "checks": checks, "k1n_checks": k1n})

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
    # K1n at the 2-D headline's per-shard node block: K = 8192, N = 5120
    packed, load = tiles["block_col0_5120"]
    Kn, wn = packed.shape
    best, _ = k.bid_argmin_natural_plain(packed, load, 5120)
    work_n = k1_work(packed, load, best)
    bn, byn = k1_bound(work_n)
    rows.append({
        "name": "bid_argmin_natural", "route": "cuda",
        "source": "cronsun_tpu_torch/csrc/bid_argmin.cu",
        "replaces": "cronsun_tpu/ops/assign.py:55 (bid_block_jnp, "
                    "bitplane_ties=False; called at "
                    "cronsun_tpu/parallel/mesh.py:319)",
        "launches": 0, "max_abs_err": max(c["max_abs"] for c in k1n),
        "ms": cuda_ms(lambda: k.bid_argmin_natural(packed, load, 5120), 50),
        "ms_back_to_back": cuda_ms(
            lambda: k.bid_argmin_natural(packed, load, 5120), 50,
            prefill=False),
        "plain_ms": cuda_ms(
            lambda: k.bid_argmin_natural_plain(packed, load, 5120), 5),
        "bound_ms": bn, "bound_by": byn, "library_ms": None,
        "shape": {"K": Kn, "N": wn * 32, "col0": 5120},
        "work": dict(zip(("bytes", "set_bits", "must_hash"), work_n)),
        "device_kernels_per_call": device_kernels_per_call(
            lambda: k.bid_argmin_natural(packed, load, 5120))})
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
    if not all(counts[n] for n in SINGLE_DEVICE_KERNELS):
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


def profile_windows(p, W, SLA, n=4, name="headline", epoch_s=T0 + 50_000,
                    after_window=None, plan=None):
    """Device time by op over ``n`` headline windows, each gathered before
    the next (``after_window(plans)`` runs after each gather; ``plan(ep)``,
    when given, plans the window at ``ep`` instead of ``p``'s dispatch and
    gather); device operations (kernels, copies, memsets) per planned
    second, and the calls that wait for the device (``SYNC_EVENTS``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for i in range(n):
            plans = (plan(epoch_s + i * W) if plan is not None else
                     p.gather_window(p.plan_window_async(
                         epoch_s + i * W, W, sla_bucket=SLA)))
            if after_window is not None:
                after_window(plans)
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType
    rows, busy_ms, device_ops = [], 0.0, 0
    syncs = dict.fromkeys(SYNC_EVENTS, 0)
    for ev in prof.key_averages():
        if ev.key in syncs:
            syncs[ev.key] += ev.count
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
            device_ops += ev.count
    rows.sort(key=lambda r: -r["device_ms"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.json"), "w") as f:
        json.dump({"wall_ms": wall_ms, "windows": n, "W": W, "rows": rows}, f,
                  indent=1)
    emit({"phase": "profile", "of": name, "windows": n, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "device_ops": device_ops,
          "device_ops_per_planned_second": device_ops / (n * W),
          "host_syncs": syncs, "top": rows[:25]})


def phase_plan_equivalence_armed(dev, J=65536, N=1024, windows=5, W=4,
                                 cap=2):
    """phase_plan_equivalence's shape with both arms armed
    (``synth.arm_mixed``): completions of the fired upstream rows are folded
    into both planners between windows.  Caps are ``cap`` per node,
    re-opened every window: at 4 the exclusive demand (at most ~3.5k a
    second) stays under the 4096 slots and the fair share never clamps.
    Counts the seconds whose fair share clamped a tenant on the card."""
    import torch
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.ops import tenancy
    from cronsun_tpu_torch.synth import arm_mixed, completions, synth_state
    t = time.perf_counter()
    state = synth_state(J, N, seed=11, node_cap=cap, empty_rows=0.02)
    stages = arm_mixed(state, seed=12, n_dep=J // 16, n_noisy=J // 64,
                       start_epoch_s=T0)
    upstream = np.zeros(J, bool)
    upstream[stages["sources"]] = upstream[stages["mids"]] = True
    kw = dict(rounds=2, max_fire_bucket=8192)
    gpu = planner_from_numpy(state, device=dev, **kw)
    cpu = planner_from_numpy(state, device="cpu", **kw)
    clamps, fair_shares = [], tenancy.fair_shares

    def spy(demand, weight, cap):
        shares = fair_shares(demand, weight, cap)
        clamps.append((shares < demand).any())
        return shares
    rng = np.random.default_rng(13)
    n = dict.fromkeys(("fired", "placed", "dep_fired", "throttled", "shed"),
                      0)
    for i in range(windows):
        for p in (gpu, cpu):
            p.set_node_capacity(list(range(N)), [cap] * N)
        tenancy.fair_shares = spy
        try:
            got = gpu.plan_window(T0 + W * i, W)
        finally:
            tenancy.fair_shares = fair_shares
        ref = cpu.plan_window(T0 + W * i, W)
        _compare_plans(ref, got, f"armed window {i}")
        rows, succ, fail = completions(got, upstream, rng, FAIL_SHARE)
        for p in (gpu, cpu):
            p.set_dep_epochs(rows, succ, fail)
        for pl in got:
            n["fired"] += pl.total_fired
            n["placed"] += int((pl.assigned >= 0).sum())
            n["dep_fired"] += int(state["has_dep"][pl.fired].sum())
            n["throttled"] += int(pl.tenant_throttled.sum())
            n["shed"] += int(pl.tenant_shed.sum())
    for name in ("load", "rem_cap", "dep_last_fire", "tb_tokens"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"final {name} differs")
    n["clamped_seconds"] = sum(bool(c) for c in clamps)
    vacuous = [k for k in ("placed", "dep_fired", "throttled",
                           "clamped_seconds") if not n[k]]
    if vacuous:
        raise AssertionError(f"the comparison is vacuous: no {vacuous}")
    emit({"phase": "plan_equivalence_armed", "J": J, "N": N, "W": W,
          "windows": windows, "seconds_planned": windows * W,
          "cap": cap, "dep_rows": int(state["has_dep"].sum()),
          "tenants": len(state["tb_rate"]), **n, "identical": True,
          "wall_s": time.perf_counter() - t})


def armed_headline_state(J, N, n_dep, n_noisy, t_rel0):
    """The headline's state with both arms armed: ``n_dep`` dep rows (a
    3-stage DAG, fan-in 4, skip policy) over time-triggered sources whose
    periods are ``SOURCE_PERIODS``; ``n_noisy`` ``@every 1s`` rows in the
    noisy tenant (rate a tenth of its offer, burst ``NOISY_BURST`` times
    the rate, starting full); every other row in one of 62 Zipf-sized
    victims with 2x headroom; the dep rows in the unlimited default
    tenant.  Returns (state, stages, noisy rows)."""
    from cronsun_tpu_torch.synth import (arm_dag, arm_tenants, every_rates,
                                         set_every, synth_state)
    state = synth_state(J, N, seed=2, specs=None, node_cap=1 << 20)
    stages = arm_dag(state, n_dep, seed=3, t_rel0=t_rel0)
    rng = np.random.default_rng(4)
    src = stages["sources"]
    set_every(state, src, rng.integers(*SOURCE_PERIODS, len(src)),
              rng.integers(0, 1 << 30, len(src)))
    dep = np.concatenate([stages["mids"], stages["sinks"]])
    free = np.ones(J, bool)
    free[src] = free[dep] = False
    noisy = rng.choice(np.flatnonzero(free), n_noisy, replace=False)
    set_every(state, noisy, np.ones(n_noisy, np.int32),
              np.zeros(n_noisy, np.int32))
    arm_tenants(state, seed=5, rates=every_rates(state), noisy_rows=noisy,
                exempt=dep)
    state["tb_burst"][-1] = state["tb_tokens"][-1] = \
        NOISY_BURST * state["tb_rate"][-1]
    return state, stages, noisy


def check_headline_armed(state, noisy, windows, folds, folded):
    """The armed headline's plans against the numpy state, second by second
    in planned order (``folds``: the ``(rows, succ)`` of each fold, in
    order; ``folded[i]``: how many had been folded when window i was
    dispatched): no overflow; every due row fired or counted as shed
    for its tenant; every other fire a dep row whose upstreams all
    succeeded after its previous fire; victims never refused; the noisy
    tenant's fires within a replay of its bucket.  Returns the totals and
    the replay's tokens after the last second."""
    from cronsun_tpu_torch.synth import FAN_IN
    J, T = len(state["active"]), len(state["tb_rate"])
    every = state["is_every"] & state["active"] & ~state["paused"]
    period = state["period"].astype(np.int64)
    phase = state["phase_mod"].astype(np.int64)
    tid, has_dep = state["row_tenant"], state["has_dep"]
    ups = state["dep_cols"][:, :FAN_IN]
    prev = state["dep_last_fire"].copy()
    is_noisy = np.zeros(J, bool)
    is_noisy[noisy] = True
    rate = float(state["tb_rate"][T - 1])
    burst = float(state["tb_burst"][T - 1])
    tokens = float(state["tb_tokens"][T - 1])
    succ = state["dep_succ"].copy()
    n = dict.fromkeys(("fired", "dep_fired", "placed", "throttled", "shed",
                       "noisy_admitted"), 0)
    applied = 0
    for plans, upto in zip(windows, folded):
        for rows, s in folds[applied:upto]:
            np.maximum.at(succ, rows, s)
        applied = upto
        for p in plans:
            t = p.epoch_s - EPOCH
            where = f"second {p.epoch_s}"
            if p.overflow:
                raise AssertionError(f"{where}: overflow {p.overflow}")
            fired = np.zeros(J, bool)
            fired[p.fired] = True
            if fired.sum() != len(p.fired):
                raise AssertionError(f"{where}: a row fired twice")
            due = every & ((phase - t) % period == 0)
            extra = np.flatnonzero(fired & ~due)
            if not has_dep[extra].all():
                raise AssertionError(f"{where}: a row fired that is neither "
                                     f"due nor a dep row")
            if not (succ[ups[extra]] > prev[extra, None]).all():
                raise AssertionError(f"{where}: a dep row fired before all "
                                     f"its upstreams succeeded again")
            prev[extra] = t
            shed = np.bincount(tid[due & ~fired], minlength=T)
            if not np.array_equal(shed, p.tenant_shed):
                raise AssertionError(f"{where}: missed due rows != shed")
            if not np.array_equal(p.tenant_throttled, p.tenant_shed):
                raise AssertionError(f"{where}: a dep fire was refused")
            if p.tenant_throttled[1:T - 1].any():
                raise AssertionError(f"{where}: a victim was throttled")
            tokens = min(burst, tokens + rate)
            adm = int(fired[noisy].sum())
            if adm > np.floor(tokens):
                raise AssertionError(f"{where}: the noisy tenant fired {adm}"
                                     f" with {tokens} tokens")
            tokens -= adm
            n["fired"] += p.total_fired
            n["dep_fired"] += len(extra)
            n["placed"] += int((p.assigned >= 0).sum())
            n["throttled"] += int(p.tenant_throttled.sum())
            n["shed"] += int(p.tenant_shed.sum())
            n["noisy_admitted"] += adm
    return n, tokens


def phase_headline_armed(dev, n_windows, profile, J=1 << 20, N=10240,
                         SLA=(16384, 16384), W=8, n_dep=ARMED_DEP_ROWS,
                         n_noisy=NOISY_ROWS):
    """phase_headline's deployment and method with both arms armed
    (:func:`armed_headline_state`); after each gather the completions of
    the window's fired upstream rows are folded in (``FAIL_SHARE`` fail).
    2 warm-up and ``n_windows`` timed windows, contiguous, with both
    kernels' launch counts set to 0 before and read after; every second is
    checked by :func:`check_headline_armed`.  Windows are dispatched as a
    deployment's normal windows are (no ``sla_bucket``), so the tenant
    tokens carry from window to window; the adaptive buckets are capped at
    ``SLA`` and must stay there, as the plain headline pins them."""
    import torch
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.ops import kernels as k
    from cronsun_tpu_torch.synth import completions
    t = time.perf_counter()
    start = T0 + 2000
    state, stages, noisy = armed_headline_state(J, N, n_dep, n_noisy,
                                                start - EPOCH)
    p = planner_from_numpy(state, device=dev, rounds=2,
                           max_fire_bucket=max(SLA))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    upstream = np.zeros(J, bool)
    upstream[stages["sources"]] = upstream[stages["mids"]] = True
    rng = np.random.default_rng(6)
    folds, folded, windows, buckets = [], [], [], set()

    def fold(plans):
        rows, s, f = completions(plans, upstream, rng, FAIL_SHARE)
        p.set_dep_epochs(rows, s, f)
        folds.append((rows, s))

    def dispatch(epoch_s):
        folded.append(len(folds))
        handle = p.plan_window_async(epoch_s, W)
        buckets.add((handle.kx, handle.kc))
        return handle

    def gather(handle):
        windows.append(p.gather_window(handle))
        fold(windows[-1])

    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()                     # the armed path's run starts
    for i in range(2):                          # warm-up windows
        gather(dispatch(start + i * W))
    handles, stamps = [], []
    for i in range(2, n_windows + 2):
        handles.append(dispatch(start + i * W))
        if len(handles) > 2:
            gather(handles.pop(0))
            stamps.append(time.perf_counter())
    for h in handles:
        gather(h)
    counts = k.launch_counts()                  # ... and ends
    if not all(counts[n] for n in SINGLE_DEVICE_KERNELS):
        raise AssertionError(f"a kernel of the armed path never launched: "
                             f"{counts}")
    peak = torch.cuda.max_memory_allocated()
    per_tick = np.diff(stamps) / W * 1e3
    if buckets != {SLA}:
        raise AssertionError(f"the adaptive buckets left {SLA}: {buckets}")
    n, tokens = check_headline_armed(state, noisy, windows, folds, folded)
    if float(p.tb_tokens[-1]) != tokens:
        raise AssertionError(f"the noisy tenant's carried tokens "
                             f"{float(p.tb_tokens[-1])} != replay {tokens}")
    if not (n["dep_fired"] and n["shed"] and n["placed"]):
        raise AssertionError(f"an arm did nothing: {n}")
    if not torch.isfinite(p.load).all():
        raise AssertionError("non-finite load")
    secs = (n_windows + 2) * W
    emit({"phase": "headline_armed", "J": J, "N": N, "W": W, "sla": list(SLA),
          "rounds": 2, "dep_rows": n_dep, "tenants": p.T,
          "noisy_rows": n_noisy, "noisy_rate": float(p.tb_rate[-1]),
          "noisy_burst": float(p.tb_burst[-1]), "noisy_tokens_end": tokens,
          "timed_windows": n_windows, "interval_samples": int(len(per_tick)),
          "p50_ms_per_tick": float(np.percentile(per_tick, 50)),
          "p99_ms_per_tick": float(np.percentile(per_tick, 99)),
          "mean_ms_per_tick": float(per_tick.mean()),
          **{f"{key}_per_tick": v / secs for key, v in n.items()},
          "seconds_checked": secs, "max_memory_allocated_bytes": peak,
          "setup_s": setup_s, "launches": counts,
          "launches_per_planned_second": {
              name: c / secs for name, c in counts.items()},
          "nvidia_smi": nvidia_smi_line()})
    if profile:
        profile_windows(p, W, None, name="headline_armed",
                        epoch_s=start + (n_windows + 2) * W,
                        after_window=fold)
    return counts


def phase_next_fire(dev, n_specs=10_000, calls=10, big_rows=1 << 20,
                    slice_rows=1 << 16):
    """BASELINE config 2 as bench.py:287-309 runs it (10k mixed specs,
    seed 0, phase at T0; ``calls`` calls at T0 + 37 i in UTC, p50 and the
    resolved count), then one call in America/New_York 3 days before a DST
    change, then ``big_rows`` rows of the same mix: card == CPU, exactly
    (the big table on its first ``slice_rows`` rows)."""
    import datetime as dt
    from zoneinfo import ZoneInfo

    import torch
    from cronsun_tpu_torch.ops import next_fire
    from cronsun_tpu_torch.ops.schedule_table import (build_table,
                                                      table_from_numpy,
                                                      table_to_numpy)
    from cronsun_tpu_torch.ops.tick import NEXT_FIRE_CHUNK
    from cronsun_tpu_torch.synth import bench_mixed_specs
    t = time.perf_counter()
    cpu = build_table(bench_mixed_specs(n_specs, seed=0), phase_epoch_s=T0,
                      device="cpu")
    cols = table_to_numpy(cpu)
    gpu = table_from_numpy(cols, dev)

    def timed(table, after, tz=dt.timezone.utc):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = next_fire(table, after, tz=tz)
        return out, (time.perf_counter() - s) * 1e3

    def same(got, table, after, tz=dt.timezone.utc, where=""):
        if not np.array_equal(got, next_fire(table, after, tz=tz)):
            raise AssertionError(f"next_fire {where} after {after}: card != "
                                 f"CPU")

    timed(gpu, T0)                              # warm
    ms = []
    for i in range(calls):
        got, m = timed(gpu, T0 + 37 * i)
        same(got, cpu, T0 + 37 * i, where="10k UTC")
        ms.append(m)
    resolved = int((got >= 0).sum())
    ny = ZoneInfo("America/New_York")
    after_ny = int(dt.datetime(2025, 10, 30, 12, tzinfo=ny).timestamp())
    got_ny, ms_ny = timed(gpu, after_ny, ny)
    same(got_ny, cpu, after_ny, ny, "10k New York")
    change = (int(dt.datetime(2025, 11, 2, tzinfo=ny).timestamp()),
              int(dt.datetime(2025, 11, 3, tzinfo=ny).timestamp()))
    on_change_day = int(((got_ny >= change[0]) & (got_ny < change[1])).sum())
    if resolved != n_specs or (got_ny >= 0).sum() != n_specs \
            or not on_change_day:
        raise AssertionError("a 10k row went unresolved, or no row fired on "
                             "the day of the DST change")
    idx = np.arange(big_rows) % n_specs
    big = {name: v[idx] for name, v in cols.items()}
    gpu_big = table_from_numpy(big, dev)
    torch.cuda.reset_peak_memory_stats()
    timed(gpu_big, T0)                          # warm
    big_ms = []
    for i in range(3):
        got_big, m = timed(gpu_big, T0 + 37 * i)
        big_ms.append(m)
    peak = torch.cuda.max_memory_allocated()
    same(got_big[:slice_rows],
         table_from_numpy({k: v[:slice_rows] for k, v in big.items()}, "cpu"),
         T0 + 74, where=f"{big_rows} rows, first {slice_rows}")
    if not (got_big >= 0).all():
        raise AssertionError("a row of the big table went unresolved")
    emit({"phase": "next_fire", "specs": n_specs, "calls": calls,
          "p50_ms": float(np.median(ms)), "ms": ms, "resolved": resolved,
          "new_york_ms": ms_ny, "new_york_after": after_ny,
          "new_york_on_change_day": on_change_day,
          "big_rows": big_rows, "big_ms": big_ms,
          "big_p50_ms": float(np.median(big_ms)),
          "big_checked_rows": slice_rows, "chunk_rows": NEXT_FIRE_CHUNK,
          "big_max_memory_allocated_bytes": peak, "identical": True,
          "wall_s": time.perf_counter() - t})


class ServiceFleet:
    """The agents of a service phase, played on the store's orders: every
    dispatch key put or rewritten since the last read is delivered; an
    exclusive bundle runs each member on its node, a Common broadcast runs
    on the job's eligible nodes; each (job, second) runs once, behind a
    fence, as the agents' lock txn makes it.  ``read`` checks each
    delivery against the seeded job documents, read back from the store."""

    def __init__(self, store, ks):
        self.store, self.ks = store, ks
        self.nodes = {kv.key[len(ks.node):] for kv in store.get_prefix(ks.node)}
        self.groups = {kv.key[len(ks.group):]: set(json.loads(kv.value)["nids"])
                       for kv in store.get_prefix(ks.group)}
        self.jobs = {}
        for kv in store.get_prefix(ks.cmd):
            doc = json.loads(kv.value)
            rule, = doc["rules"]
            self.jobs[kv.key[len(ks.cmd):]] = (
                doc["kind"], rule["timer"], set(rule.get("nids") or ()),
                rule.get("gids") or [], set(rule.get("exclude_nids") or ()))
        self.anchors = {}
        for kv in store.get_prefix(ks.phase):
            grp, job, _rule = kv.key[len(ks.phase):].split("/")
            self.anchors[f"{grp}/{job}"] = int(kv.value.rsplit("|", 1)[1])
        self.seen = {}
        self.runs = {}          # (job, second) -> node (None: broadcast)
        self.replanned = set()  # seconds the service re-planned for overflow
        self.n = dict.fromkeys(("deliveries", "bundles", "broadcasts",
                                "fenced_redeliveries"), 0)

    def eligible(self, job, node) -> bool:
        _k, _t, nids, gids, excl = self.jobs[job]
        if node not in self.nodes or node in excl:
            return False
        return node in nids or any(node in self.groups[g] for g in gids)

    def order(self, key, value):
        """(node, second, jobs) of one published order key, held to the
        agents' rules: a broadcast (node None) is of a Common job, a bundle
        runs exclusive jobs on a live node eligible for each."""
        parts = key[len(self.ks.dispatch):].split("/")
        if parts[0] == self.ks.BROADCAST:
            ep, job, node = int(parts[1]), "/".join(parts[2:]), None
            if self.jobs[job][0] != 0:
                raise AssertionError(f"{key}: broadcast of an exclusive job")
            self.n["broadcasts"] += 1
            return node, ep, [job]
        if len(parts) != 2:
            raise AssertionError(f"unexpected order key {key}")
        node, ep = parts[0], int(parts[1])
        # members are "group/job" strings; a sampled bundle also carries
        # one {"tb": ...} trace header, which agents skip
        fires = [e for e in json.loads(value) if not isinstance(e, dict)]
        self.n["bundles"] += 1
        for job in fires:
            if self.jobs[job][0] == 0:
                raise AssertionError(f"{key}: Common job {job} bundled")
            if not self.eligible(job, node):
                raise AssertionError(f"{key}: {job} on a node that is "
                                     f"not live and eligible")
        return node, ep, fires

    def read(self, replanned):
        """Deliver what the last step published; ``replanned``: the seconds
        that step queued for an overflow re-plan."""
        cur = {kv.key: kv.value for kv in self.store.get_prefix(self.ks.dispatch)}
        step = set()
        for key, value in cur.items():
            if self.seen.get(key) == value:
                continue
            node, ep, fires = self.order(key, value)
            for job in fires:
                if (job, ep) in step:
                    raise AssertionError(f"({job}, {ep}) published twice in "
                                         f"one step")
                step.add((job, ep))
                self.n["deliveries"] += 1
                if (job, ep) in self.runs:
                    if ep not in self.replanned:
                        raise AssertionError(f"({job}, {ep}) delivered again, "
                                             f"but {ep} was not re-planned")
                    self.n["fenced_redeliveries"] += 1
                else:
                    self.runs[(job, ep)] = node
        self.seen = cur
        self.replanned |= set(replanned)

    def due(self, lo: int, hi: int) -> set:
        """(job, second) for every second in [lo, hi) at which the job's spec,
        evaluated on its own by the scalar cron schedule (``@every`` from its
        phase anchor), says it fires."""
        import datetime as dt
        from cronsun_tpu_torch.cron.parser import EverySpec, parse
        from cronsun_tpu_torch.cron.schedule import Schedule
        by_timer = {}
        for job, (_k, timer, *_rest) in self.jobs.items():
            by_timer.setdefault(timer, []).append(job)
        out = set()
        for timer, jobs in by_timer.items():
            spec = parse(timer)
            if isinstance(spec, EverySpec):
                for job in jobs:
                    a = self.anchors[job]
                    out.update((job, t) for t in range(
                        lo + (a - lo) % spec.period_s, hi, spec.period_s))
                continue
            sched = Schedule(spec)
            t = dt.datetime.fromtimestamp(lo - 1, dt.timezone.utc)
            while True:
                t = sched.next(t)
                if t is None or t.timestamp() >= hi:
                    break
                out.update((job, int(t.timestamp())) for job in jobs)
        return out


def _service_orders(store, ks):
    return sorted((kv.key, kv.value) for kv in store.get_prefix(ks.dispatch))


def _span_pcts(svc) -> dict:
    return {name: {"p50": ring.percentile(0.5), "p99": ring.percentile(0.99)}
            for name, ring in sorted(svc._span_hist.items())}


class Gen2Collections:
    """Records (step, ms) of each full (generation 2) garbage collection
    while installed; ``step`` is set by the caller."""

    def __init__(self):
        self.step, self.events, self._t0 = 0, [], 0.0

    def __call__(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.events.append((self.step,
                                (time.perf_counter() - self._t0) * 1e3))


def phase_service(dev, check_windows=SERVICE_CHECK_WINDOWS,
                  timed_steps=SERVICE_TIMED_STEPS, n_jobs=SERVICE_JOBS,
                  n_nodes=SERVICE_NODES, W=SERVICE_WINDOW):
    """The service on the card against the service on the CPU, the played
    fleet, the timed steps and the warm takeover (see the module
    docstring, phase 12).  Returns both kernels' launch counts over the
    timed steps."""
    import gc
    import shutil
    import tempfile

    import torch
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.ops import kernels as k
    from cronsun_tpu_torch.sched import SchedulerService
    from cronsun_tpu_torch.store import MemStore
    from cronsun_tpu_torch.synth import seed_service_store
    ks = Keyspace()
    ckpt_dir = tempfile.mkdtemp(prefix="cronsun-ckpt-")
    svcs = []

    def service(store, device, **kw):
        t = time.perf_counter()
        svc = SchedulerService(
            store, ks, job_capacity=n_jobs, node_capacity=n_nodes,
            window_s=W, dispatch_ttl=3600.0, pipelined=False,
            clock=lambda: float(SERVICE_NOW), device=device, **kw)
        svcs.append(svc)
        return svc, time.perf_counter() - t

    def seeded():
        store = MemStore()
        seed_service_store(store, ks, n_jobs, n_nodes, SERVICE_NOW)
        return store

    out = {"phase": "service", "jobs": n_jobs, "nodes": n_nodes, "window_s": W,
           "pinned_clock": SERVICE_NOW}
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        store = seeded()
        out["seed_s"] = time.perf_counter() - t
        card, out["cold_load_s"] = service(store, dev,
                                           checkpoint_dir=ckpt_dir)
        cpu_store = seeded()
        cpu, out["cpu_cold_load_s"] = service(cpu_store, "cpu")
        fleet = ServiceFleet(store, ks)
        # exactness and the fleet: check_windows windows, plus one so the
        # last window's overflow re-plans land
        step_s, t_now = [], SERVICE_NOW
        for i in range(check_windows + 1):
            t = time.perf_counter()
            card.step(now=t_now)
            step_s.append(time.perf_counter() - t)
            fleet.read([ep for ep, _h, _f in card._pending_replans])
            cpu.step(now=t_now)
            if card._next_epoch != cpu._next_epoch:
                raise AssertionError("the services' plan cursors differ")
            t_now = card._next_epoch
        orders = _service_orders(store, ks)
        if orders != _service_orders(cpu_store, ks) or \
                store.get(ks.hwm).value != cpu_store.get(ks.hwm).value:
            raise AssertionError("card service orders != CPU service orders")
        lo = SERVICE_NOW + 1
        hi = lo + check_windows * W
        due = fleet.due(lo, hi)
        ran = {r for r in fleet.runs if lo <= r[1] < hi}
        extra = ran - due
        if extra:
            raise AssertionError(f"{len(extra)} runs not due, e.g. "
                                 f"{sorted(extra)[:3]}")
        # a due fire that never ran: an exclusive one no node could take
        # (a no-capacity skip; the seed's nodes are uncapped) or a lost one
        missing = due - ran
        skipped = sum(fleet.jobs[job][0] != 0 for job, _ep in missing)
        if missing:
            raise AssertionError(f"{len(missing)} due fires never ran "
                                 f"({skipped} exclusive), e.g. "
                                 f"{sorted(missing)[:3]}")
        out.update(identical_windows=check_windows + 1,
                   identical_orders=len(orders), hwm=int(store.get(ks.hwm).value),
                   checked_seconds=[lo, hi], due_fires=len(due),
                   runs=len(ran), no_capacity_skips=skipped,
                   replanned_seconds=sorted(fleet.replanned),
                   overflow_late_fires=card.stats["overflow_late_fires"],
                   overflow_drops=card.stats["overflow_drops"],
                   serial_step_s=step_s, serial_spans_ms=_span_pcts(card),
                   **fleet.n)
        cpu.stop()
        if card.stats["overflow_drops"]:
            raise AssertionError(f"overflow drops {card.stats}")
        # the services' background warm-ups (one window and the escalated
        # single-second bucket each) finish before the timed steps
        t = time.perf_counter()
        for th in (cpu._warm_thread, card._warm_thread):
            if th is not None:
                th.join()
        out["warm_join_s"] = time.perf_counter() - t

        # timed steps, pipelined: the first pays the mode switch
        card.pipelined = True
        t = time.perf_counter()
        card.step(now=t_now)
        out["first_step_s"] = time.perf_counter() - t
        t_now = card._next_epoch
        card.reset_latency_stats()
        d0 = card.stats["dispatches_total"]
        gen2 = Gen2Collections()
        gc.callbacks.append(gen2)
        # the window the untimed step handed to the dispatch thread lands
        # before the counts start: they cover the timed steps' windows
        card._resolve_handle(card._pending_plan[1])
        k.reset_launch_counts()                 # the service's run starts
        ms = []
        try:
            for gen2.step in range(timed_steps):
                t = time.perf_counter()
                card.step(now=t_now)
                ms.append((time.perf_counter() - t) * 1e3)
                t_now = card._next_epoch
        finally:
            gc.callbacks.remove(gen2)
        card._builder.flush()
        card.publisher.flush()
        card._drain_build_acct()
        # the window the last step handed to the dispatch thread
        card._resolve_handle(card._pending_plan[1])
        counts = k.launch_counts()              # ... and ends
        if not all(counts[n] for n in SINGLE_DEVICE_KERNELS):
            raise AssertionError(f"a kernel never launched in the service's "
                                 f"steps: {counts}")
        out.update(
            timed_steps=timed_steps, step_ms=ms,
            step_p50_ms=float(np.percentile(ms, 50)),
            step_p99_ms=float(np.percentile(ms, 99)),
            spans_ms=_span_pcts(card),
            dispatches_per_step=(card.stats["dispatches_total"] - d0)
            / timed_steps, launches_service=counts,
            gc_gen2_step_ms=gen2.events,
            overflow_late_fires_total=card.stats["overflow_late_fires"])

        # warm takeover: a fresh card service restores the card service's
        # checkpoint; both plan the next window from the same capacities
        save = card.checkpoint_save(kind="full")
        out["checkpoint_save_ms"] = save["ms"]
        warm, out["takeover_s"] = service(store, dev, checkpoint_dir=ckpt_dir)
        if not warm.checkpoint_restored:
            raise AssertionError("the checkpoint did not restore")

        def first_window(svc):
            svc.reconcile_capacity()
            svc._flush_device()
            secs = []
            for p in svc.planner.plan_window(t_now, W, sla_bucket=1 << 16):
                svc._build_plan_orders(p, secs, [])
            return [(ep, kv) for ep, os_ in secs for kv in os_]
        cold_first = first_window(card)
        if first_window(warm) != cold_first or not cold_first:
            raise AssertionError("warm takeover's first window != cold load's")
        # the plan alone: windows dispatched and gathered on this thread
        # with no other thread of the service running
        alone = []
        for i in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            card.planner.plan_window(t_now + (i + 1) * W, W)
            alone.append((time.perf_counter() - t) * 1e3)
        out.update(takeover_first_window_orders=len(cold_first),
                   plan_alone_ms_per_window=alone,
                   buckets=[card.planner._bx.cur_k, card.planner._bc.cur_k],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                   nvidia_smi=nvidia_smi_line())
    finally:
        for svc in svcs:
            svc.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit(out)
    return counts


class Proc:
    """One ``python3 -m <mod>`` process (``args`` its flags, ``name`` its
    log's name, else ``mod``): its output is drained into ``lines``,
    ``ready_s`` is its seconds from spawn to ``READY``."""

    def __init__(self, mod, *args, name=None):
        self.mod, self.node_id = mod, name or mod
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self._t0 = time.perf_counter()
        self.p = subprocess.Popen(
            [sys.executable, "-m", mod, *args], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines, self.ready_s, self._ready = [], None, None
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self):
        for line in self.p.stdout:
            if self.ready_s is None and line.startswith("READY"):
                self._ready = line.split(None, 1)[1].strip()
                self.ready_s = time.perf_counter() - self._t0
            self.lines.append(line)

    def check_alive(self):
        if self.p.poll() is not None:
            raise AssertionError(f"{self.node_id} exited rc {self.p.returncode}:"
                                 f"\n{''.join(self.lines[-40:])}")

    def ready(self, timeout=120) -> str:
        """What the ``READY`` line says, once it came and the process
        still runs."""
        deadline = time.perf_counter() + timeout
        while self.ready_s is None:
            self.check_alive()
            if time.perf_counter() > deadline:
                raise AssertionError(f"{self.node_id}: no READY within "
                                     f"{timeout} s:\n{self.output()}")
            time.sleep(0.05)
        self.check_alive()
        return self._ready

    def output(self) -> str:
        return "".join(self.lines)

    def wait(self, timeout=30) -> int:
        rc = self.p.wait(timeout=timeout)
        self._reader.join(timeout)
        return rc

    def stop(self, sig=signal.SIGTERM, timeout=60.0) -> int:
        """Signal ``sig``, then the exit code (SIGKILL past ``timeout``)."""
        if self.p.poll() is None:
            self.p.send_signal(sig)
        try:
            rc = self.p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.p.send_signal(signal.SIGKILL)
            rc = self.p.wait(timeout=timeout)
            self.lines.append(f"chip_smoke: no exit within {timeout} s of "
                              f"signal {sig}; killed\n")
        self._reader.join(timeout)
        return rc

    def save_log(self, prefix="launcher"):
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"{prefix}_{self.node_id}.log"),
                  "w") as f:
            f.writelines(self.lines)


def port_proc(role, name, *args) -> Proc:
    """``python3 -m cronsun_tpu_torch.bin.<role>``."""
    return Proc(f"cronsun_tpu_torch.bin.{role}", *args, name=name)


class SchedProc(Proc):
    """A scheduler process on the card (no ``--device``; ``extra`` flags
    appended)."""

    def __init__(self, addr, conf, node_id, *extra):
        super().__init__("cronsun_tpu_torch.bin.sched", "--store", addr,
                         "--conf", conf, "--node-id", node_id, *extra,
                         name=node_id)


class WatchedAgents:
    """The launcher phase's agents, played on a watch of the order prefix
    through the port's ``RemoteStore``: a thread only queues each batch of
    events with its arrival time, and :meth:`process` delivers them by
    ``ServiceFleet``'s rules (each order checked by ``fleet.order``, each
    (job, second) run once; a re-delivery is recorded for the caller to
    judge).  A lost watch fails the phase."""

    def __init__(self, fleet, client):
        import collections
        import threading
        self.fleet = fleet
        self.w = client.watch(fleet.ks.dispatch)
        self.seen = {}
        self.redelivered = []         # (job, second), each fenced
        self.min_ep = None
        self.first_after, self.first_t = None, None
        self.error = None
        self._q = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        try:
            while not self._stop.is_set():
                ev = self.w.get(timeout=0.2)
                if ev is not None:
                    self._q.append((time.perf_counter(), [ev] + self.w.drain()))
        except Exception as e:  # noqa: BLE001 — WatchLost or the wire: fatal
            self.error = e

    def process(self):
        from cronsun_tpu_torch.store import PUT
        if self.error is not None:
            raise AssertionError(f"the order watch failed: {self.error!r}")
        runs = self.fleet.runs
        while self._q:
            t, batch = self._q.popleft()
            for ev in batch:
                if ev.type != PUT:
                    continue
                if self.first_t is None and self.first_after is not None \
                        and t >= self.first_after:
                    self.first_t = t
                key, value = ev.kv.key, ev.kv.value
                if self.seen.get(key) == value:
                    continue
                self.seen[key] = value
                node, ep, fires = self.fleet.order(key, value)
                self.min_ep = ep if self.min_ep is None else min(self.min_ep, ep)
                for job in fires:
                    self.fleet.n["deliveries"] += 1
                    if (job, ep) in runs:
                        self.fleet.n["fenced_redeliveries"] += 1
                        self.redelivered.append((job, ep))
                    else:
                        runs[(job, ep)] = node

    def close(self):
        self._stop.set()
        self._thread.join(5)
        self.w.close()


def _check_due(fleet, lo, hi, where):
    """Every (job, second) in [lo, hi) the scalar evaluation calls due ran,
    and nothing else did."""
    due = fleet.due(lo, hi)
    ran = {r for r in fleet.runs if lo <= r[1] < hi}
    if ran - due:
        raise AssertionError(f"{where}: {len(ran - due)} runs not due, e.g. "
                             f"{sorted(ran - due)[:3]}")
    if due - ran:
        raise AssertionError(f"{where}: {len(due - ran)} due fires never ran, "
                             f"e.g. {sorted(due - ran)[:3]}")
    return len(due)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_capture(port, start_at, into):
    """Thread body: one ``LAUNCHER_CAPTURE_MS`` capture of the scheduler
    process serving ``port``, requested at wall-clock ``start_at``, its
    events and info put into ``into`` (or the exception under ``error``)."""
    from cronsun_tpu_torch.scripts.profile_sched import fetch_capture
    time.sleep(max(0.0, start_at - time.time()))
    try:
        into["events"], into["info"] = fetch_capture(
            "127.0.0.1", port, LAUNCHER_CAPTURE_MS, timeout=300)
    except Exception as e:  # noqa: BLE001 — judged by check_launcher_capture
        into["error"] = e


def check_launcher_capture(cap, node_id) -> dict:
    """The capture holds both kernels' device events and the planner's
    ranges on threads other than the server's; returns the line to print."""
    from cronsun_tpu_torch.scripts.profile_sched import capture_summary
    if "error" in cap or "info" not in cap:
        raise AssertionError(f"{node_id}'s capture failed: "
                             f"{cap.get('error', 'no answer')!r}")
    info, events = cap["info"], cap["events"]
    summary = capture_summary(events, LAUNCHER_CAPTURE_MS)
    kernels = {}
    for e in events:
        if e.cat == "kernel":
            for k in ("bid_argmin_kernel", "fanout_add_kernel"):
                if k in e.key:
                    kernels[k] = kernels.get(k, 0) + 1
    if len(kernels) != 2:
        raise AssertionError(f"{node_id}'s capture lacks a kernel's device "
                             f"events: {kernels}")
    threads = summary.pop("range_threads")
    for r in LAUNCHER_RANGES:
        tids = threads.get(r, [])
        if not tids or info["server_tid"] in tids:
            raise AssertionError(f"{node_id}'s capture: range {r} on "
                                 f"threads {tids}, the server's "
                                 f"{info['server_tid']}")
    return {"phase": "launcher_capture", "of": node_id,
            "ms": LAUNCHER_CAPTURE_MS, "gz_bytes": info["gz_bytes"],
            "export_s": info["export_s"], "request_s": info["request_s"],
            "events": len(events), "kernel_events": kernels,
            "range_threads": {r: threads[r] for r in LAUNCHER_RANGES},
            **summary}


def phase_launcher(n_jobs=SERVICE_JOBS, n_nodes=SERVICE_NODES, W=SERVICE_WINDOW,
                   windows=LAUNCHER_WINDOWS):
    """Two scheduler processes on the card against the port's TCP store,
    played agents, a SIGKILL failover (see the module docstring, phase 13).
    Returns the survivor's kernel launch counts."""
    import shutil
    import signal
    import tempfile

    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.store import MemStore, RemoteStore, StoreServer
    from cronsun_tpu_torch.synth import seed_service_store
    ks = Keyspace()
    tmp = tempfile.mkdtemp(prefix="cronsun-launcher-")
    ckpt = os.path.join(tmp, "ckpt")
    out = {"phase": "launcher", "jobs": n_jobs, "nodes": n_nodes,
           "window_s": W, "windows_checked": windows}
    procs, server, client, agents = {}, None, None, None
    try:
        t = time.perf_counter()
        store = MemStore()
        seed_service_store(store, ks, n_jobs, n_nodes, int(time.time()))
        fleet = ServiceFleet(store, ks)
        server = StoreServer(store).start()
        addr = f"{server.host}:{server.port}"
        client = RemoteStore(server.host, server.port)
        agents = WatchedAgents(fleet, client)
        out["seed_s"] = time.perf_counter() - t
        conf = os.path.join(tmp, "conf.json")
        with open(conf, "w") as f:
            json.dump({"window_s": W, "job_capacity": n_jobs,
                       "node_capacity": n_nodes, "checkpoint_dir": ckpt,
                       "checkpoint_interval": LAUNCHER_CKPT_INTERVAL,
                       "log_db": os.path.join(tmp, "unused.db")}, f)

        def pump(cond, timeout, what):
            """Deliver orders until ``cond()`` holds; fails past ``timeout``
            s or when a scheduler process not killed on purpose exits."""
            deadline = time.perf_counter() + timeout
            while True:
                agents.process()
                if cond():
                    return
                for p in procs.values():
                    if p.p.returncode is None:
                        p.check_alive()
                if time.perf_counter() > deadline:
                    raise AssertionError(f"launcher: {what} not within "
                                         f"{timeout} s")
                time.sleep(0.05)

        def leader():
            kv = client.get(ks.leader)
            return kv.value if kv is not None else None

        def hwm():
            """The leader's high-water mark; 0 before its first window's
            orders are all published."""
            kv = client.get(ks.hwm)
            return int(kv.value) if kv is not None else 0

        def snapshot(node_id):
            kv = client.get(ks.metrics_key("sched", node_id))
            return json.loads(kv.value) if kv is not None else {}

        # the leader cold-loads; the standby starts once the leader's first
        # checkpoint is on disk, so its start restores it
        prof_port = free_port()
        procs["sched-a"] = SchedProc(addr, conf, "sched-a", "--profile-port",
                                     str(prof_port))
        pump(lambda: procs["sched-a"].ready_s is not None, 300, "sched-a READY")
        pump(lambda: leader() == "sched-a", 60, "sched-a leading")
        pump(lambda: os.path.exists(os.path.join(ckpt, "sched.ckpt")), 120,
             "the leader's first checkpoint")
        procs["sched-b"] = SchedProc(addr, conf, "sched-b")
        pump(lambda: procs["sched-b"].ready_s is not None, 300, "sched-b READY")
        out["ready_s"] = {k: p.ready_s for k, p in procs.items()}
        if leader() != "sched-a":
            raise AssertionError(f"{leader()} leads before the capture")

        # before the kill: `windows` leader windows, each due second once;
        # the leader's capture is taken while they are pumped
        capture = {}
        # the leader steps 1.5 s before its high-water mark (the service
        # loop plans ahead) and is idle between steps: the capture opens a
        # second before a step
        start_at = hwm() - 2.5
        while start_at < time.time() + 0.2:
            start_at += W
        cap_thread = threading.Thread(target=launcher_capture,
                                      args=(prof_port, start_at, capture),
                                      daemon=True)
        cap_thread.start()
        pump(lambda: agents.min_ep is not None
             and hwm() >= agents.min_ep + windows * W, 60 + 2 * windows * W,
             f"{windows} leader windows")
        pump(lambda: not cap_thread.is_alive(), 300, "the leader's capture")
        emit(check_launcher_capture(capture, "sched-a"))
        lo, hi = agents.min_ep, hwm()
        t = time.perf_counter()
        pump(lambda: time.perf_counter() > t + 1.0, 10, "in-flight orders")
        out["before_kill"] = {"seconds": [lo, hi],
                              "due_fires": _check_due(fleet, lo, hi,
                                                      "before the kill")}
        old = leader()
        new = ({"sched-a", "sched-b"} - {old}).pop()
        old_snap = snapshot(old)

        # failover: SIGKILL the leader; no order can come from it a second
        # after its death, and none from the standby before the lease ends
        procs[old].stop(signal.SIGKILL)
        t_kill = time.perf_counter()
        agents.first_after = t_kill + 1.0
        hwm_dead = hwm()
        pump(lambda: leader() == new, 60, f"{new} leading")
        lease_s = time.perf_counter() - t_kill
        pump(lambda: agents.first_t is not None, 60, "the new leader's first order")
        out.update(killed=old, survivor=new, hwm_at_kill=hwm_dead,
                   lease_wait_s=lease_s, takeover_s=agents.first_t - t_kill)

        pump(lambda: hwm() >= hwm_dead + windows * W, 60 + 2 * windows * W,
             f"{windows} windows of the new leader")
        hi2 = hwm()
        t = time.perf_counter()
        pump(lambda: time.perf_counter() > t + 1.0, 10, "in-flight orders")
        due = _check_due(fleet, lo, hi2, "across the failover")
        snap = snapshot(new)
        # a (job, second) delivered twice ran once (the played fence); the
        # second delivery is allowed for a second at or past the dead
        # leader's high-water mark (re-planned by its successor) or when a
        # leader re-planned seconds for overflow
        overflow = (old_snap.get("overflow_late_fires_total", 0)
                    + snap.get("overflow_late_fires_total", 0))
        bad = [r for r in agents.redelivered if r[1] < hwm_dead]
        if bad and not overflow:
            raise AssertionError(f"{len(bad)} re-deliveries of seconds before "
                                 f"the dead leader's mark, e.g. {bad[:3]}")
        if snap.get("skipped_seconds_total", 0) or \
                old_snap.get("skipped_seconds_total", 0):
            raise AssertionError(f"skipped seconds: {old_snap} {snap}")
        restored = any("checkpoint RESTORED" in ln for ln in procs[new].lines)
        out.update(
            checked_seconds=[lo, hi2], due_fires=due,
            runs=len([r for r in fleet.runs if lo <= r[1] < hi2]),
            orders=len(agents.seen), **fleet.n,
            failover_redeliveries=len(agents.redelivered),
            overflow_late_fires=overflow,
            skipped_seconds_total=snap.get("skipped_seconds_total"),
            takeover_restored=restored,
            checkpoint_restored_snapshot=snap.get("checkpoint_restored"),
            step_p50_ms=snap.get("sched_step_p50_ms"),
            step_p99_ms=snap.get("sched_step_p99_ms"),
            tick_p50_ms=snap.get("tick_p50_ms"),
            tick_p99_ms=snap.get("tick_p99_ms"),
            killed_leader_step_p50_ms=old_snap.get("sched_step_p50_ms"),
            killed_leader_step_p99_ms=old_snap.get("sched_step_p99_ms"))

        # the survivor exits 0 on SIGTERM and logs both kernels' launches
        rc = procs[new].stop(signal.SIGTERM)
        if rc != 0:
            raise AssertionError(f"{new} exited {rc} on SIGTERM:\n"
                                 f"{''.join(procs[new].lines[-40:])}")
        line = [ln for ln in procs[new].lines if "kernel launch counts:" in ln]
        if not line:
            raise AssertionError(f"{new} logged no launch counts")
        counts = json.loads(line[-1].split("kernel launch counts:", 1)[1])
        if not all(counts.get(n) for n in SINGLE_DEVICE_KERNELS):
            raise AssertionError(f"a kernel never launched in {new}: {counts}")
        out.update(launches_launcher=counts, nvidia_smi=nvidia_smi_line())
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL, timeout=30)
            p.save_log()
        if agents is not None:
            agents.close()
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return counts


def _mesh_grid(shape, dev):
    return np.array([dev] * int(np.prod(shape)), dtype=object).reshape(shape)


MESHES = (("1d_D2", "ShardedTickPlanner", (2,)),
          ("2d_2x2", "Sharded2DTickPlanner", (2, 2)))


def phase_mesh_equivalence(dev, J=65536, N=1024,
                           windows=MESH_EQUIVALENCE_WINDOWS, W=4):
    """The mesh planners with their shards on the card against the same
    planners on the CPU, from one seeded state at the config-sample shape:
    the 1-D mesh at D = 2 and the 2-D mesh at 2 x 2, each with the
    bucket-sharded reconcile in both demand formats and the replicated
    one; caps 4 re-opened every window.  Every TickPlan field, the final
    load and rem_cap identical."""
    import torch
    from cronsun_tpu_torch.convert import install_mesh_state
    from cronsun_tpu_torch.parallel import mesh as pm
    from cronsun_tpu_torch.synth import synth_state
    state = synth_state(J, N, seed=7, node_cap=4, empty_rows=0.02)
    t = time.perf_counter()
    runs = []
    for name, cls, shape in MESHES:
        for kw in (dict(shard_bids=True, demand_format="dense"),
                   dict(shard_bids=True, demand_format="compacted"),
                   dict(shard_bids=False)):
            pair = []
            for d in (dev, torch.device("cpu")):
                p = getattr(pm, cls)(pm.Mesh(_mesh_grid(shape, d)), J, N,
                                     max_fire_bucket=16384, **kw)
                install_mesh_state(p, state)
                pair.append(p)
            gpu, cpu = pair
            fired = placed = 0
            for i in range(windows):
                for p in pair:
                    p.set_node_capacity(list(range(N)), [4] * N)
                got = gpu.plan_window(T0 + W * i, W)
                ref = cpu.plan_window(T0 + W * i, W)
                _compare_plans(ref, got, f"mesh {name} {kw} window {i}")
                fired += sum(p.total_fired for p in got)
                placed += sum(int((p.assigned >= 0).sum()) for p in got)
            if not (torch.equal(gpu.load.cpu(), cpu.load)
                    and torch.equal(gpu.rem_cap.cpu(), cpu.rem_cap)):
                raise AssertionError(f"mesh {name} {kw}: load / rem_cap "
                                     f"differ")
            if placed == 0:
                raise AssertionError("nothing was placed: vacuous")
            runs.append({"mesh": name, **kw, "fired": fired,
                         "placed": placed, "identical": True})
    emit({"phase": "mesh_equivalence", "J": J, "N": N, "W": W,
          "windows": windows, "runs": runs,
          "wall_s": time.perf_counter() - t})


def _check_mesh_headline(state, plans, N):
    """Every fire is due and every due row fired (no overflow at this
    bucket); every exclusive fire placed on an eligible node within its
    capacity, every Common fire unplaced."""
    t_rel = np.int64(plans[0].epoch_s - EPOCH)
    period = state["period"].astype(np.int64)
    phase = state["phase_mod"].astype(np.int64)
    for i, p in enumerate(plans):
        due = np.nonzero((phase - (t_rel + i)) % period == 0)[0]
        if p.overflow:
            raise AssertionError(f"overflow {p.overflow} at the mesh headline")
        if not np.array_equal(np.sort(p.fired), due):
            raise AssertionError(f"second {p.epoch_s}: fire set != due rows")
        ex = state["exclusive"][p.fired]
        a = p.assigned
        if (a[~ex] != -1).any() or (a[ex] < 0).any() or (a >= N).any():
            raise AssertionError(f"second {p.epoch_s}: a placement is "
                                 f"missing, out of range or of a Common job")
        xs, ax = p.fired[ex], a[ex]
        words = state["elig"][xs, ax // 32]
        if not ((words >> (ax % 32).astype(np.uint32)) & 1).all():
            raise AssertionError("placement on an ineligible node")
        if (np.bincount(ax, minlength=N) > state["rem_cap"]).any():
            raise AssertionError("placements over a node's capacity")


def phase_mesh_headline(dev, n_windows=MESH_HEADLINE_WINDOWS,
                        profile=False, J=1 << 20, N=10240, SLA=32768, W=8):
    """The headline deployment on the mesh planners, every shard on the
    card: the 1-D mesh at D = 2 and the 2-D mesh at 2 x 2, rounds 2.  One
    bucket of ``SLA`` rows holds both kinds (the mesh planners do not
    split them), so k_local = 16384 per jobs shard takes a second's ~20.8k
    fires.  One warm-up window, then ``n_windows`` timed windows with the
    kernels' launch counts set to 0 before and read after; plans checked
    in numpy (:func:`_check_mesh_headline`), and the bytes the collectives
    moved per tick against the estimate; ``profile`` adds a profiler pass
    of 2 windows per mesh.  Returns {mesh: launch counts}."""
    import torch
    from cronsun_tpu_torch.convert import install_mesh_state
    from cronsun_tpu_torch.ops import kernels as k
    from cronsun_tpu_torch.parallel import mesh as pm
    from cronsun_tpu_torch.synth import synth_state
    state = synth_state(J, N, seed=2, specs=None, node_cap=1 << 20)
    out, counts_by = {"phase": "mesh_headline", "J": J, "N": N, "W": W,
                      "sla": SLA, "rounds": 2, "timed_windows": n_windows,
                      "meshes": []}, {}
    for name, cls, shape in MESHES:
        t = time.perf_counter()
        p = getattr(pm, cls)(pm.Mesh(_mesh_grid(shape, dev)), J, N, rounds=2,
                             max_fire_bucket=SLA)
        install_mesh_state(p, state)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        p.plan_window(T0, W)                    # warm-up
        k.reset_launch_counts()                 # the mesh's run starts
        ms, plans = [], []
        for i in range(n_windows):
            t = time.perf_counter()
            plans.append(p.plan_window(T0 + 1000 + i * W, W))
            ms.append((time.perf_counter() - t) * 1e3 / W)
        counts = k.launch_counts()              # ... and ends
        need = ("bid_argmin_natural" if p.Dn > 1 else "bid_argmin",
                "fanout_add")
        if not all(counts[n] for n in need):
            raise AssertionError(f"{name}: a kernel of the path never "
                                 f"launched: {counts}")
        for i in (0, n_windows // 2, n_windows - 1):
            _check_mesh_headline(state, plans[i], N)
        if not torch.isfinite(p.load).all():
            raise AssertionError("non-finite load")
        est = p.estimate_collective_bytes(
            k_local=p._last_k_local, demand_format=p._last_demand_format)
        if p.measured_collective_bytes() != est["per_tick"]:
            raise AssertionError(f"{name}: collective bytes "
                                 f"{p.measured_collective_bytes()} != "
                                 f"estimate {est['per_tick']}")
        ticks = [pl for win in plans for pl in win]
        counts_by[name] = counts
        out["meshes"].append({
            "mesh": name, "shards": int(p.mesh.devices.size),
            "k_local": p._last_k_local,
            "demand_format": p._last_demand_format,
            "setup_s": setup_s, "ms_per_tick": ms,
            "p50_ms_per_tick": float(np.percentile(ms, 50)),
            "p99_ms_per_tick": float(np.percentile(ms, 99)),
            "fired_per_tick": float(np.mean([pl.total_fired for pl in ticks])),
            "placed_per_tick": float(np.mean(
                [(pl.assigned >= 0).sum() for pl in ticks])),
            "launches": counts,
            "launches_per_planned_second": {
                n: c / (n_windows * W) for n, c in counts.items()},
            "collective_bytes_per_tick": p.measured_collective_bytes(),
            "estimated_bytes_per_tick": est["per_tick"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        if profile:
            profile_windows(p, W, SLA, n=2, name=f"mesh_{name}",
                            plan=lambda ep: p.plan_window(ep, W))
        del p, plans, ticks
        torch.cuda.empty_cache()
    out["nvidia_smi"] = nvidia_smi_line()
    emit(out)
    return counts_by


def phase_mesh_launcher(n_jobs=SERVICE_JOBS, n_nodes=SERVICE_NODES,
                        W=SERVICE_WINDOW, windows=MESH_LAUNCHER_WINDOWS):
    """The service deployment served by the port's in-script
    ``StoreServer`` to a 2-process mesh of ``cronsun_tpu_torch.bin.sched``
    on the card: ``--mesh 2 --mesh-hosts 2 --mesh-proc-id 0|1`` (gloo
    rendezvous on a free local port), one shard a process.  Each rank's
    seconds to ``READY``; over ``windows`` leader windows the played agents
    (the launcher phase's rules) see every due (job, second) run once.
    SIGTERM to rank 0: it exits 0 and logs K1 and K2 launched; the worker
    is released, exits 0 and logs its plan steps.  Returns rank 0's launch
    counts."""
    import shutil
    import signal
    import tempfile

    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.store import MemStore, RemoteStore, StoreServer
    from cronsun_tpu_torch.synth import seed_service_store
    ks = Keyspace()
    tmp = tempfile.mkdtemp(prefix="cronsun-mesh-launcher-")
    out = {"phase": "mesh_launcher", "jobs": n_jobs, "nodes": n_nodes,
           "window_s": W, "windows_checked": windows, "mesh": 2, "hosts": 2}
    procs, server, client, agents = {}, None, None, None
    try:
        t = time.perf_counter()
        store = MemStore()
        seed_service_store(store, ks, n_jobs, n_nodes, int(time.time()))
        fleet = ServiceFleet(store, ks)
        server = StoreServer(store).start()
        addr = f"{server.host}:{server.port}"
        client = RemoteStore(server.host, server.port)
        agents = WatchedAgents(fleet, client)
        out["seed_s"] = time.perf_counter() - t
        conf = os.path.join(tmp, "conf.json")
        with open(conf, "w") as f:
            json.dump({"window_s": W, "job_capacity": n_jobs,
                       "node_capacity": n_nodes,
                       "log_db": os.path.join(tmp, "unused.db")}, f)
        coord = f"127.0.0.1:{free_port()}"
        mesh = ("--mesh", "2", "--mesh-hosts", "2", "--mesh-coordinator",
                coord)
        procs["mesh-leader"] = SchedProc(addr, conf, "mesh-leader", *mesh,
                                         "--mesh-proc-id", "0")
        procs["mesh-worker"] = SchedProc(addr, conf, "mesh-worker", *mesh,
                                         "--mesh-proc-id", "1")

        def pump(cond, timeout, what):
            deadline = time.perf_counter() + timeout
            while True:
                agents.process()
                if cond():
                    return
                for p in procs.values():
                    p.check_alive()
                if time.perf_counter() > deadline:
                    raise AssertionError(f"mesh launcher: {what} not within "
                                         f"{timeout} s")
                time.sleep(0.05)

        def hwm():
            kv = client.get(ks.hwm)
            return int(kv.value) if kv is not None else 0

        pump(lambda: all(p.ready_s is not None for p in procs.values()), 300,
             "both ranks READY")
        out["ready_s"] = {k: p.ready_s for k, p in procs.items()}
        pump(lambda: agents.min_ep is not None
             and hwm() >= agents.min_ep + windows * W, 120 + 4 * windows * W,
             f"{windows} leader windows")
        lo, hi = agents.min_ep, hwm()
        t = time.perf_counter()
        pump(lambda: time.perf_counter() > t + 1.0, 10, "in-flight orders")
        out.update(checked_seconds=[lo, hi],
                   due_fires=_check_due(fleet, lo, hi, "mesh launcher"),
                   redeliveries=len(agents.redelivered), orders=len(agents.seen),
                   **fleet.n)
        if agents.redelivered:
            raise AssertionError(f"re-deliveries with one leader: "
                                 f"{agents.redelivered[:3]}")
        kv = client.get(ks.metrics_key("sched", "mesh-leader"))
        snap = json.loads(kv.value) if kv is not None else {}
        kv = client.get(ks.metrics_key("mesh", "mesh-leader"))
        mesh_snap = json.loads(kv.value) if kv is not None else {}
        out.update(step_p50_ms=snap.get("sched_step_p50_ms"),
                   step_p99_ms=snap.get("sched_step_p99_ms"),
                   tick_p50_ms=snap.get("tick_p50_ms"),
                   tick_p99_ms=snap.get("tick_p99_ms"),
                   mesh_snapshot=mesh_snap)

        # SIGTERM rank 0: it releases the worker on its way out
        leader, worker = procs["mesh-leader"], procs["mesh-worker"]
        rc = leader.stop(signal.SIGTERM)
        if rc != 0:
            raise AssertionError(f"the mesh leader exited {rc} on SIGTERM:\n"
                                 f"{''.join(leader.lines[-40:])}")
        rc = worker.stop(signal.SIGTERM)   # its first SIGTERM is ignored
        released = [ln for ln in worker.lines if "released after" in ln]
        if rc != 0 or not released:
            raise AssertionError(f"the mesh worker exited {rc}, released: "
                                 f"{released}:\n{''.join(worker.lines[-40:])}")
        steps = int(released[-1].split("released after ")[1].split()[0])
        line = [ln for ln in leader.lines if "kernel launch counts:" in ln]
        if not line:
            raise AssertionError("the mesh leader logged no launch counts")
        counts = json.loads(line[-1].split("kernel launch counts:", 1)[1])
        if not all(counts.get(n) for n in SINGLE_DEVICE_KERNELS):
            raise AssertionError(f"a kernel never launched in the mesh "
                                 f"leader: {counts}")
        out.update(worker_plan_steps=steps, launches_mesh_launcher=counts,
                   nvidia_smi=nvidia_smi_line())
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL, timeout=30)
            p.save_log()
        if agents is not None:
            agents.close()
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return counts


# --------------------------------------------------------- the port's benches

class PathCalls:
    """While entered, the kernel wrappers as the planners call them (the
    names in ``ops.assign`` and ``parallel.mesh``) keep the inputs and
    outputs of one call at each (kernel, K, W32, col0, rows given, active
    given), at most ``PATH_CALLS_PER_KERNEL`` a kernel: the first, or, while
    the kept one had no work (no active row, no nonzero weight), the next
    that has some, which costs a host read per call until then.  A call
    with ``rows`` keeps the bucket's rows gathered from the table, which
    the plain version reads the same way (the tie hash takes the row's
    place in the bucket).  :meth:`check` holds them against the plain
    versions after the run, so no comparison launches a kernel inside it."""

    def __init__(self):
        import threading
        self.calls, self._kept, self._lock = [], {}, threading.Lock()

    def __enter__(self):
        import inspect
        from cronsun_tpu_torch.ops import assign
        from cronsun_tpu_torch.parallel import mesh
        self._orig = [(mod, name, getattr(mod, name)) for mod, names in (
            (assign, ("bid_argmin", "fanout_add")),
            (mesh, ("bid_argmin", "bid_argmin_natural", "fanout_add")))
            for name in names]
        for mod, name, fn in self._orig:
            setattr(mod, name, self._wrap(name, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)

    def _wrap(self, name, fn, sig):
        import torch
        vec_name = list(sig.parameters)[1]

        def call(*a, **kw):
            arg = sig.bind(*a, **kw).arguments
            packed, rows, active = (arg["packed"], arg.get("rows"),
                                    arg.get("active"))
            col0 = int(arg.get("col0", 0))
            key = (name, len(packed) if rows is None else len(rows),
                   packed.shape[1], col0, rows is None, active is None)
            with self._lock:
                kept = self._kept.get(key)
                fresh = kept is None and sum(
                    c["kernel"] == name for c in self.calls
                ) < PATH_CALLS_PER_KERNEL
            if not (fresh or (kept is not None and not kept["work"])):
                return fn(*a, **kw)
            work = bool(arg[vec_name].any() if name == "fanout_add"
                        else active is None or active.any())
            if not (fresh or work):
                return fn(*a, **kw)
            got = {"kernel": name, "col0": col0, "rows": rows is not None,
                   "work": work,
                   "tile": (packed.clone() if rows is None
                            else packed[rows.to(torch.int64)]),
                   "vec": arg[vec_name].clone(),
                   "active": None if active is None else active.clone()}
            out = fn(*a, **kw)
            got["out"] = (out.clone() if name == "fanout_add"
                          else tuple(t.clone() for t in out))
            with self._lock:
                self.calls = [got if c is kept else c for c in self.calls
                              ] + ([got] if fresh else [])
                self._kept[key] = got
            return out
        return call

    def check(self, phase) -> list:
        """Each kept call against its plain version: K1 and K1n best and
        choice exactly; K2 exactly on integer weights, else rtol 1e-5 (the
        two sum in different orders), as phase 3 holds them."""
        import torch
        from cronsun_tpu_torch.ops import kernels as k
        out = []
        for c in self.calls:
            tile, vec, act = c["tile"], c["vec"], c["active"]
            where = (f"{phase}: {c['kernel']} at K {len(tile)}, "
                     f"W32 {tile.shape[1]}, col0 {c['col0']}")
            if c["kernel"] == "fanout_add":
                ref, got = k.fanout_add_plain(tile, vec), c["out"]
                integral = bool(torch.equal(vec, vec.round()))
                if integral and not torch.equal(got, ref):
                    raise AssertionError(f"{where}: integer weights not "
                                         "exact")
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                                           msg=where)
                err = float((got - ref).abs().max())
            else:
                ref = (k.bid_argmin_plain(tile, vec, None, act)
                       if c["kernel"] == "bid_argmin" else
                       k.bid_argmin_natural_plain(tile, vec, c["col0"], None,
                                                  act))
                got = c["out"]
                if not (torch.equal(got[0], ref[0])
                        and torch.equal(got[1], ref[1])):
                    raise AssertionError(f"{where}: "
                                         f"{int((got[1] != ref[1]).sum())} "
                                         "choices differ from plain")
                err, integral = k1_max_abs(got[0], ref[0]), None
            out.append({"kernel": c["kernel"], "K": len(tile),
                        "W32": tile.shape[1], "col0": c["col0"],
                        "rows": c["rows"], "active": None if act is None
                        else int(act.sum()), "integer_weights": integral,
                        "work": c["work"], "max_abs_err": err})
        self.calls, self._kept = [], {}
        return out


class HostClock:
    """Where a bench's host time goes, while entered: every garbage
    collection (``gc.callbacks``), every ``SchedulerService.step`` as
    ``cronsun_tpu_torch.sched`` exports it (its wall time and the calling
    thread's CPU time), and the bench's log lines, which split the run
    into segments (a rung, an arm, a stage) and count the steps that
    ``run_bench`` retried; each service's span percentiles when it stops.
    It costs one callback per collection and three clock reads per step.
    """

    def __init__(self):
        self.gcs, self.steps, self.marks, self.spans = [], [], [], []
        self.retried, self._gc_t0 = 0, 0.0

    def log(self, *a) -> None:
        msg = " ".join(str(x) for x in a)
        print(msg, file=sys.stderr, flush=True)
        self.retried += msg.startswith("step retried")
        self.marks.append((time.perf_counter(), msg))

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gcs.append((self._gc_t0, info["generation"],
                             (time.perf_counter() - self._gc_t0) * 1e3))

    def __enter__(self):
        import gc
        import cronsun_tpu_torch.sched as sched
        clock, self._cls = self, sched.SchedulerService

        class Clocked(self._cls):
            def step(self, *a, **kw):
                t0, c0, p0 = (time.perf_counter(), time.thread_time(),
                              time.process_time())
                try:
                    return super().step(*a, **kw)
                finally:
                    clock.steps.append((t0, time.perf_counter(),
                                        (time.thread_time() - c0) * 1e3,
                                        (time.process_time() - p0) * 1e3,
                                        self.node_id))

            def stop(self, *a, **kw):
                clock.spans.append((time.perf_counter(), self.node_id,
                                    _span_pcts(self)))
                return super().stop(*a, **kw)
        sched.SchedulerService = Clocked
        gc.callbacks.append(self._gc)
        self.marks.append((time.perf_counter(), "start"))
        return self

    def __exit__(self, *exc):
        import gc
        import cronsun_tpu_torch.sched as sched
        sched.SchedulerService = self._cls
        gc.callbacks.remove(self._gc)

    def _gc_in(self, t0, t1, gen=None) -> "tuple[float, int]":
        sel = [ms for t, g, ms in self.gcs
               if t0 <= t < t1 and (gen is None or g == gen)]
        return sum(sel), len(sel)

    def summary(self) -> dict:
        """Per segment with steps: their count, wall, CPU ms of the calling
        thread and of the whole process (every thread: the service's
        workers, an in-process store), collection ms (collections on any
        thread hold the GIL) and full collections, wall by service, the
        slowest step's own split, and the span percentiles of the services
        whose last step is in it; then every collection of the run by
        generation."""
        bounds = [t for t, _ in self.marks[1:]] + [float("inf")]
        seg_of = [next(i for i, t1 in enumerate(bounds) if s[0] < t1)
                  for s in self.steps]
        spans = {}                  # by the segment of the service's last step
        for t, node, pcts in self.spans:
            last = [i for s, i in zip(self.steps, seg_of)
                    if s[4] == node and s[0] <= t]
            if last:
                spans.setdefault(last[-1], {})[node] = pcts
        segs = {}
        for i, (_, msg) in enumerate(self.marks):
            steps = [s for s, j in zip(self.steps, seg_of) if j == i]
            if not steps:
                continue
            by_svc = {}
            for s in steps:
                by_svc[s[4]] = by_svc.get(s[4], 0.0) + (s[1] - s[0]) * 1e3
            slow = max(steps, key=lambda s: s[1] - s[0])
            segs[f"{i:03d} {msg[:60]}"] = {
                "steps": len(steps),
                "wall_ms": sum((s[1] - s[0]) * 1e3 for s in steps),
                "thread_cpu_ms": sum(s[2] for s in steps),
                "process_cpu_ms": sum(s[3] for s in steps),
                "gc_ms": sum(self._gc_in(s[0], s[1])[0] for s in steps),
                "full_gcs": sum(self._gc_in(s[0], s[1], 2)[1]
                                for s in steps),
                "wall_ms_by_service": by_svc,
                "slowest": {"wall_ms": (slow[1] - slow[0]) * 1e3,
                            "thread_cpu_ms": slow[2],
                            "process_cpu_ms": slow[3],
                            "gc_ms": self._gc_in(slow[0], slow[1])[0]},
                "spans": spans.get(i, {})}
        gcs = {}
        for _, g, ms in self.gcs:
            n, tot, top = gcs.get(g, (0, 0.0, 0.0))
            gcs[g] = (n + 1, tot + ms, max(top, ms))
        return {"segments": segs, "gc_by_generation": {
            str(g): {"count": n, "ms": tot, "max_ms": top}
            for g, (n, tot, top) in sorted(gcs.items())}}


def _run_bench_phase(name, run, check, summary=None):
    """Drive one bench of ``cronsun_tpu_torch.scripts``, ``run(on_log)``,
    with every launch count set to 0 just before and read just after;
    ``check`` raises on a failed gate.  Every kernel the run launched is
    held against its plain version on inputs kept from the run
    (``PathCalls``), and no step may have been retried.  The full result
    goes to ``chiprun_out/<name>.json``, the phase line carries ``summary``
    of it (default: all of it) and ``HostClock``'s split.  Returns the
    launch counts and the path checks."""
    from cronsun_tpu_torch.ops import kernels as k
    with PathCalls() as calls, HostClock() as clock:
        k.reset_launch_counts()             # the bench's run starts
        t = time.perf_counter()
        res = run(clock.log)
        seconds = time.perf_counter() - t
        counts = k.launch_counts()          # ... and ends
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as f:
        json.dump(res, f, indent=1)
    path = calls.check(name)
    unchecked = {n for n, c in counts.items() if c} - {
        c["kernel"] for c in path}
    if unchecked:
        raise AssertionError(f"{name}: no call of {unchecked} was kept")
    if clock.retried:
        raise AssertionError(f"{name}: {clock.retried} steps retried")
    check(res, counts)
    emit({"phase": name, "seconds": seconds, f"launches_{name}": counts,
          "checks": "held", "steps_retried": clock.retried,
          "path_checks": path, **(summary(res) if summary else res),
          "host_clock": clock.summary(), "nvidia_smi": nvidia_smi_line()})
    return counts, path


def _need_launched(name, counts, kernels) -> None:
    if not all(counts[n] for n in kernels):
        raise AssertionError(f"{name}: a kernel of the path never launched: "
                             f"{counts}")


def _need_equal(name, res, want: dict) -> None:
    bad = {k: res.get(k) for k, v in want.items() if res.get(k) != v}
    if bad:
        raise AssertionError(f"{name}: {bad}, want {want}")


def phase_sched_bench(dev, steps=SCHED_BENCH_STEPS):
    """``run_bench`` at the deployment default, 100 000 jobs x 1024 nodes:
    cold load, the delta-checkpoint ladder, a checkpoint-restore warm
    takeover whose first window equals the cold-loaded service's, ``steps``
    timed pipelined steps and the serial baseline, the herd-second order
    build, and a warm standby's takeover."""
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        _need_equal("sched_bench", res, {
            "failover_warm_restored": 1,
            "failover_warm_divergence_orders": 0,
            "sched_publish_failures": 0})
        if not res["failover_warm_window_orders"] > 0:
            raise AssertionError("sched_bench: the compared window is empty")
        _need_launched("sched_bench", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_bench",
        lambda log: bs.run_bench(SERVICE_JOBS, SERVICE_NODES, steps,
                                 on_log=log, device=dev),
        check, lambda res: {k: v for k, v in res.items()
                            if k != "sched_store_op_stats"})


def phase_sched_dag(dev):
    """``run_dag_bench`` at its defaults (50 000 jobs x 512 nodes, 3
    rounds, fan-in 4): every dep fire once, no round incomplete, and a
    delta-chain warm takeover with zero divergence."""
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        if res["dag_fires_total"] != res["dag_expected_fires"]:
            raise AssertionError(f"sched_dag: {res['dag_fires_total']} fires, "
                                 f"{res['dag_expected_fires']} expected")
        _need_equal("sched_dag", res, {
            "dag_duplicate_fires": 0, "dag_missing_fires": 0,
            "dag_incomplete_rounds": 0, "dag_publish_failures": 0,
            "dag_warm_restored": 1, "dag_warm_divergence_orders": 0})
        _need_launched("sched_dag", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_dag", lambda log: bs.run_dag_bench(on_log=log, device=dev),
        check)


def phase_sched_tenants(dev):
    """``run_tenant_bench`` at its defaults: victims fire exactly once and
    are never throttled, and the noisy tenant is throttled and held to its
    quota (the reference gate's ±5 %, ``tests/test_tenancy.py:963-967``).
    """
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        _need_equal("sched_tenants", res, {
            "tenant_victim_missing_fires": 0,
            "tenant_victim_duplicate_fires": 0,
            "tenant_victim_throttled_fires": 0})
        if not res["tenant_noisy_throttled_fires"] > 0:
            raise AssertionError("sched_tenants: the noisy tenant was never "
                                 "throttled")
        if abs(res["tenant_noisy_clamp_ratio"] - 1.0) > 0.05:
            raise AssertionError(f"sched_tenants: noisy admitted "
                                 f"{res['tenant_noisy_admitted_rate']}/s "
                                 f"against a quota of "
                                 f"{res['tenant_noisy_quota_rate']}/s")
        _need_launched("sched_tenants", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_tenants",
        lambda log: bs.run_tenant_bench(on_log=log, device=dev), check)


def phase_sched_partitions(dev, parts=SCHED_PARTITIONS):
    """``run_partition_ladder`` at 40 000 jobs x 256 nodes over ``parts``
    partition leaders: every rung plans exactly the P = 1 fire set, and the
    FNV split gives each partition at least 0.8 of the largest one's fires
    (``tests/test_partition.py:393-397``)."""
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        rungs = res["sched_partition_ladder"]
        base = rungs[str(min(parts))]["fires"]
        bad = {p: r for p, r in rungs.items()
               if r["divergence"] or r["fires"] != base or r["fairness"] < 0.8}
        if bad or not base:
            raise AssertionError(f"sched_partitions: rungs {bad} diverge, "
                                 f"plan other than {base} fires or split "
                                 "below 0.8")
        _need_launched("sched_partitions", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_partitions",
        lambda log: bs.run_partition_ladder(40_000, 256, parts=parts,
                                            on_log=log, device=dev),
        check)


def phase_sched_herd(dev):
    """``run_herd_bench`` at 50 000 jobs x 512 nodes, jitter 30: both arms
    without a duplicate or missing fire, at the reference's epochs."""
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        _need_equal("sched_herd", res, {
            f"herd_{k}_{arm}": 0 for arm in ("unsmeared", "smeared")
            for k in ("duplicate_fires", "missing_fires",
                      "reference_divergence")})
        _need_launched("sched_herd", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_herd",
        lambda log: bs.run_herd_bench(50_000, 512, jitter=30, on_log=log,
                                      device=dev), check)


def phase_mesh_ladder(dev, ticks=MESH_LADDER_TICKS):
    """``run_ladder`` at 65536 jobs x 1024 nodes over D = 1, 2, 4 shards
    (1-D, and 2-D (D/2) x 2 from D = 4, each bucket-sharded and
    replicated), then ``run_sparse_ladder`` as ``--quick --sparse`` runs
    it; shards past the card count share the card.  Every rung's measured
    collective bytes equal the byte model, every divergence check is 0, and
    the 2-D rungs launch K1n."""
    from cronsun_tpu_torch.scripts import bench_mesh as bm

    def run(log):
        ladder = bm.run_ladder([1, 2, 4], [(65536, 1024)], ticks, False,
                               on_log=log, device=dev)
        sparse = bm.run_sparse_ladder([2], True, on_log=log,
                                      device=dev)
        return {"multichip_ladder": ladder, "multichip_sparse_ladder": sparse}

    def rungs(res):
        return [r for part in ("multichip_ladder", "multichip_sparse_ladder")
                for r in res[part] if r["path"] != "compare"]

    def check(res, counts):
        for r in rungs(res):
            if r["measured_bytes_per_tick"] != r["predicted_bytes_per_tick"] \
                    or r.get("fire_set_divergence", 0) or not r["fired_per_tick"]:
                raise AssertionError(f"mesh_ladder: rung {r}")
        if not any("fire_set_divergence" in r for r in rungs(res)):
            raise AssertionError("mesh_ladder: no divergence check ran")
        _need_launched("mesh_ladder", counts,
                       SINGLE_DEVICE_KERNELS + ("bid_argmin_natural",))

    keep = ("devices", "mesh", "path", "jobs", "nodes", "k_local",
            "fired_per_tick", "tick_p50_ms", "tick_p99_ms",
            "windowed_ms_per_tick", "demand_format", "measured_bytes_per_tick",
            "shards_per_device", "fire_fraction", "fire_set_divergence",
            "phase_bid_ms", "phase_gather_ms", "phase_reconcile_ms")
    return _run_bench_phase(
        "mesh_ladder", run, check,
        lambda res: {"ticks": ticks, "rungs": [
            {k: r[k] for k in keep if k in r} for r in rungs(res)]})


# ------------------------------------------- the chaos drills and the trace bench

def _need(name, cond, what) -> None:
    if not cond:
        raise AssertionError(f"{name}: {what}")


def check_drills(res) -> None:
    """The JAX tests' gates of each drill (``tests/test_chaos.py:706-712``,
    ``tests/test_chaos_drills.py``, ``tests/test_repl.py:644-675``)."""
    name = "chaos_drills"
    _need(name, res["total_findings"] == 0,
          {k: v["findings"] for k, v in res.items()
           if isinstance(v, dict) and v.get("findings")})
    smoke = res["smoke"]["info"]
    _need(name, smoke["schedule_deterministic"], "smoke: schedules differ")
    _need(name, smoke["executions"] > 0, "smoke: nothing ran")
    _need(name, smoke["injected"].get("store.rpc:reply_lost", 0) > 0
          and smoke["injected"].get("logsink.rpc:reply_lost", 0) > 0,
          f"smoke: faults not injected {smoke['injected']}")
    for d in ("leader_kill9", "partition_leader_kill"):
        info = res[d]["info"]
        _need(name, info["recovery_s"] < 16.0,
              f"{d}: recovery {info['recovery_s']} s")
        _need(name, info["executions"] > 0, f"{d}: nothing ran")
    _need(name, all(n > 0 for n in
                    res["partition_leader_kill"]["info"]["slice_sizes"]
                    .values()), "partition_leader_kill: an empty slice")
    _need(name, res["shard_partition"]["info"]["executions"] > 0,
          "shard_partition: nothing ran")
    b = res["brownout"]["info"]
    _need(name, b["degraded_p99_ms"] >= b["delay_ms"] * 0.8,
          f"brownout: no stall induced {b['degraded_p99_ms']} ms")
    _need(name, b["hardened_p99_ms"] <= max(2.0 * b["baseline_p99_ms"],
                                            20.0),
          f"brownout: hardened p99 {b['hardened_p99_ms']} ms over "
          f"max(2 x {b['baseline_p99_ms']}, 20)")
    d = res["brownout_dispatch"]["info"]
    _need(name, d["lost_fires"] == 0, "brownout_dispatch: lost fires")
    _need(name, d["healthy_fires"] > 0 and d["degraded_fires"] > 0,
          "brownout_dispatch: a population is empty")
    _need(name, d["degraded_fire_p99_ms"] >= d["delay_ms"],
          f"brownout_dispatch: degraded p99 {d['degraded_fire_p99_ms']} ms "
          f"under the {d['delay_ms']} ms delay")
    _need(name, d["slow_waterfalls"] and {"publish", "claim"} <= set(
        d["slow_waterfalls"][0]["stages"]),
        "brownout_dispatch: no slow waterfall with publish and claim")
    if "native_smoke" in res:
        n = res["native_smoke"]["info"]
        _need(name, n.get("backend") == "native" and n["executions"] > 0,
              f"native_smoke: {n}")
    for seed, r in res["replica_leader_kill_seeds"].items():
        _need(name, r["findings"] == [] and r["info"]["acked_probes"] > 0,
              f"replica_leader_kill seed {seed}: {r['findings']}")
    codes = {f["code"] for f in res["replica_leader_kill_unreplicated"]
             ["findings"]}
    _need(name, "acked_record_lost" in codes,
          f"replica_leader_kill unreplicated: {codes} (must lose acked "
          "probes)")


def threads_left(before, grace_s=10.0):
    """Names of the threads started since ``before`` (a set of threads)
    that are still alive after up to ``grace_s`` seconds."""
    deadline = time.monotonic() + grace_s
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            return sorted(t.name for t in left)
        time.sleep(0.2)


def phase_chaos_drills(dev):
    """Every drill of ``bench_chaos.DRILLS`` at its default seed and size,
    in order, its schedulers on ``dev`` (``native_smoke`` only where both
    native binaries are found); then the replica drill at the two further
    seeds of its gate and its unreplicated control arm, which must lose
    acked probes.  The card's allocated bytes are read before and after
    (a killed service's tensors must not outlive its fleet), and no thread
    started by the drills may outlive them (a killed agent's or
    scheduler's included).  Each drill's ``agent_redeliveries`` says how
    many orders its agents re-read after a failed claim."""
    import gc
    import torch
    from cronsun_tpu_torch.scripts import bench_chaos as bc
    names = list(bc.DRILLS)
    if not bc.native_available():
        names.remove("native_smoke")
        print("chaos_drills: native_smoke skipped: the native cronsun-stored "
              "and cronsun-logd binaries are not found and do not build here",
              flush=True)
    bc.warm_device(dev)
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    threads_before = set(threading.enumerate())

    def replica(seed, log):
        n = bc.Fleet.agent_redeliveries
        r = bc.drill_replica_leader_kill(seed=seed, on_log=log, device=dev)
        r["info"]["agent_redeliveries"] = bc.Fleet.agent_redeliveries - n
        return r

    def run(log):
        res = bc.run_drills(names, on_log=log, device=dev)
        res["replica_leader_kill_seeds"] = {
            seed: replica(seed, log) for seed in (44, 45)}
        res["replica_leader_kill_unreplicated"] = \
            bc.drill_replica_leader_kill(replicated=False, on_log=log,
                                         device=dev)
        return res

    def check(res, counts):
        check_drills(res)
        _need_launched("chaos_drills", counts, SINGLE_DEVICE_KERNELS)
        gc.collect()
        grown = torch.cuda.memory_allocated(dev) - before
        _need("chaos_drills", grown <= CARD_BYTES_LEFT_BY_DRILLS,
              f"{grown} bytes stay allocated on the card after every "
              "fleet closed (a service's tensors outlive it)")
        left = threads_left(threads_before)
        _need("chaos_drills", not left,
              f"threads outlive the drills' fleets: {left}")

    def summary(res):
        keep = ("recovery_s", "executions", "injected", "sink_total",
                "baseline_p99_ms", "degraded_p99_ms", "hardened_p99_ms",
                "healthy_fire_p99_ms", "degraded_fire_p99_ms",
                "acked_probes", "lost_probes", "saves", "skipped",
                "agent_redeliveries", "quiesce_s")
        gc.collect()
        return {"drills": {
            k: {"wall_s": v.get("wall_s"), "findings": len(v["findings"]),
                **{f: v["info"][f] for f in keep if f in v["info"]}}
            for k, v in res.items() if isinstance(v, dict) and "info" in v},
            "total_findings": res["total_findings"],
            "replica_seeds": {
                s: {"findings": len(r["findings"]),
                    "agent_redeliveries": r["info"]["agent_redeliveries"],
                    "recovery_s": r["info"].get("recovery_s"),
                    "quiesce_s": r["info"].get("quiesce_s")}
                for s, r in res["replica_leader_kill_seeds"].items()},
            # the replica drills' publishers that did not land in time
            "publish_flush_timeout": {
                str(s): [{k: f[k] for k in ("sched", "stage", "inflight",
                                            "hwm_done", "hwm_want")}
                         for f in r["info"].get("flush_timeouts", [])]
                for s, r in [(43, res["replica_leader_kill"]),
                             *res["replica_leader_kill_seeds"].items()]},
            "unreplicated_codes": sorted({
                f["code"] for f in
                res["replica_leader_kill_unreplicated"]["findings"]}),
            "card_bytes_before": before,
            "card_bytes_after": torch.cuda.memory_allocated(dev)}

    return _run_bench_phase("chaos_drills", run, check, summary)


TRACE_STAGES = ("publish", "claim", "queue", "run", "record")


def phase_sched_trace(dev):
    """``run_trace_bench`` at its defaults (50 000 jobs x 512 nodes, 64
    traced jobs, 8 live seconds, 12 paired steps, W = 4): sampled fires
    with every wire stage of the waterfall (``tests/test_bench_smoke.py:
    297-303``), both overhead arms; the reference's slow timing gate
    (``:318``, sampling adds < 2 % + 1 ms to step p99) is printed, not
    held."""
    from cronsun_tpu_torch.scripts import bench_sched as bs

    def check(res, counts):
        name = "sched_trace"
        _need(name, res["trace_stage_fires"] > 0, "no sampled fire")
        stages = res["trace_stage_p99_ms"]
        _need(name, all(st in stages and stages[st] >= 0.0
                        for st in TRACE_STAGES), f"stages {stages}")
        _need(name, res["trace_overhead_on_p99_ms"] > 0
              and res["trace_overhead_off_p99_ms"] > 0, "an empty arm")
        _need_launched(name, counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase(
        "sched_trace", lambda log: bs.run_trace_bench(on_log=log, device=dev),
        check)


PROCESS_FLEET_JOBS = 50_000    # scripts/bench_sched.py:886-887, the trace
PROCESS_FLEET_NODES = 512      # bench's deployment
PROCESS_FLEET_LIVE_S = 20
PROCESS_FLEET_NODE_TTL = 5     # tests/test_multiprocess.py's
PROCESS_FLEET_WEB_REQUESTS = 50
FLEET_JOBS = {"pf-common": 0, "pf-alone": 1, "pf-interval": 2}


def compute_apps() -> list:
    """[(pid, MiB)] as nvidia-smi lists the compute apps on the card.  On
    the chip machine the pids are of another namespace (every process of
    the container shows as pid 1), so only the MiB say something here."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    out = []
    for ln in r.stdout.strip().splitlines():
        pid, _, mib = ln.partition(",")
        if pid.strip().isdigit():
            out.append((int(pid), float(mib.strip() or 0)))
    return out


def card_device_files(pid) -> list:
    """The card device files (``/dev/nvidia<N>``) that ``pid`` holds open:
    a process holds its card's once it has a CUDA context on it.  The
    chip machine's nvidia-smi lists compute apps by pids of another
    namespace, so this is how a fleet process is matched to a context."""
    import re
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            out.add(target)
    return sorted(out)


def card_mib_used() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return float(r.stdout.strip().splitlines()[0])


class Receiver:
    """An HTTP noticer's target on the loopback: every POSTed JSON body as
    (arrival time, path, Content-Type, body), in arrival order."""

    def __init__(self):
        import http.server
        got = self.posts = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                got.append((time.perf_counter(), self.path,
                            self.headers.get("Content-Type"),
                            json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_port}/"
        self._thread = threading.Thread(target=self.srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def bodies(self, path="/"):
        return [b for _t, p, _c, b in self.posts if p == path]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self._thread.join(10)


class WebClient:
    """A logged-in session against a fleet's web process."""

    def __init__(self, addr, email="admin@admin.com", password="admin"):
        import http.cookiejar
        import urllib.parse
        import urllib.request
        self.base = f"http://{addr}"
        self.op = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))
        q = urllib.parse.urlencode({"email": email, "password": password})
        with self.op.open(f"{self.base}/v1/session?{q}", timeout=30) as r:
            r.read()

    def call(self, method, path, body=None):
        import urllib.request
        req = urllib.request.Request(
            self.base + path, method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with self.op.open(req, timeout=30) as r:
            raw = r.read()
            json_body = "json" in r.headers.get("Content-Type", "")
        return json.loads(raw) if json_body and raw else raw.decode()


class SseWatch:
    """One ``/v1/stream`` viewer: the seconds from its start to the first
    event of one of ``jobs``."""

    def __init__(self, web, jobs):
        import threading
        self.jobs, self.first, self.events, self.error = jobs, None, 0, None
        self._t0 = time.perf_counter()
        self._resp = web.op.open(web.base + "/v1/stream", timeout=60)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        try:
            for raw in self._resp:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                self.events += 1
                ev = json.loads(line[5:])
                if ev.get("jobId") in self.jobs:
                    self.first = (time.perf_counter() - self._t0, ev)
                    return
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.error = e

    def close(self):
        self._resp.close()
        self._thread.join(10)


def _fleet_records(sink, job):
    """Every record of ``job`` in the result store, paged."""
    out, page = [], 1
    while True:
        recs, total = sink.query_logs(job_ids=[job], page=page, page_size=500)
        out += recs
        if not recs or len(out) >= total:
            return out
        page += 1


def _check_fleet_runs(sink, nodes, lo_cap, t_jobs):
    """From the first second both agents ran the Common job up to
    ``lo_cap`` (exclusive; the crash's seconds come after): the Common
    job ran on both agents every second, the Interval job once a second
    across them, and the Alone job at most once a second.  An Alone fire
    is skipped while the job's previous run still holds its fleet-wide
    lock (reference job.go:87-123; two due seconds claimed together run
    at once), so its skipped seconds are counted, not failed.  Returns
    the executions counted."""
    from collections import Counter
    runs = {}
    for job in FLEET_JOBS:
        recs = _fleet_records(sink, job)
        if not recs or not all(r.success for r in recs):
            raise AssertionError(f"process_fleet: {job}: {len(recs)} records, "
                                 "a failed one or none")
        runs[job] = [(int(r.output.strip()), r.node) for r in recs]
    common = runs["pf-common"]
    lo = max(min(ts for ts, n in common if n == node) for node in nodes)
    seconds = range(lo, lo_cap)
    if len(seconds) < 5:
        raise AssertionError(f"process_fleet: only {len(seconds)} seconds "
                             f"checked ({lo}..{lo_cap}), the first "
                             f"{lo - t_jobs:.1f} s after the jobs' PUT")
    ran = {(ts, n) for ts, n in common}
    missing = [(ts, n) for ts in seconds for n in nodes if (ts, n) not in ran]
    if missing:
        raise AssertionError(f"process_fleet: the Common job missed "
                             f"{len(missing)} (second, node), e.g. {missing[:4]}")
    skipped = {}
    for job in ("pf-alone", "pf-interval"):
        count = Counter(ts for ts, _ in runs[job])
        twice = sorted(ts for ts, c in count.items() if c > 1)
        if twice:
            raise AssertionError(f"process_fleet: {job} ran twice at "
                                 f"{twice[:4]}")
        skipped[job] = [ts for ts in seconds if ts not in count]
    if skipped["pf-interval"]:
        raise AssertionError(f"process_fleet: pf-interval never ran at "
                             f"{len(skipped['pf-interval'])} seconds, e.g. "
                             f"{skipped['pf-interval'][:4]}")
    return {"checked_seconds": [lo, lo_cap],
            "alone_skipped_seconds": len(skipped["pf-alone"]),
            "first_run_after_put_s": lo - t_jobs,
            **{job: len(r) for job, r in runs.items()}}


def phase_process_fleet(n_jobs=PROCESS_FLEET_JOBS, n_nodes=PROCESS_FLEET_NODES,
                        live_s=PROCESS_FLEET_LIVE_S,
                        node_ttl=PROCESS_FLEET_NODE_TTL,
                        requests=PROCESS_FLEET_WEB_REQUESTS, sched_args=(),
                        on_card=True):
    """A fleet of the port's processes around the scheduler on the card
    (see the module docstring, phase 25).  Returns the scheduler's kernel
    launch counts.  ``sched_args`` and ``on_card=False`` (``--device cpu``,
    no nvidia-smi) run it where there is no card."""
    import shutil
    import signal
    import tempfile

    from cronsun_tpu_torch.bin.common import connect_store
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.logsink.sharded import connect_sharded_sink
    from cronsun_tpu_torch.scripts.bench_sched import seed
    ks = Keyspace()
    tmp = tempfile.mkdtemp(prefix="cronsun-fleet-")
    local_db = os.path.join(tmp, "local-UNUSED.db")
    ckpt_dir = os.path.join(tmp, "ckpt")
    session = os.path.join(tmp, "ctl-session")
    nodes = ["pf-node-0", "pf-node-1"]
    out = {"phase": "process_fleet", "jobs": n_jobs, "nodes": n_nodes,
           "live_s": live_s, "node_ttl": node_ttl}
    procs, client, sink, sse = {}, None, None, None
    recv = Receiver()
    try:
        if on_card:
            apps_before = compute_apps()
            out["card_mib_before"] = card_mib_used()
        conf = os.path.join(tmp, "conf.json")
        with open(conf, "w") as f:
            json.dump({"log_db": local_db, "window_s": 4, "node_ttl": node_ttl,
                       "job_capacity": n_jobs + 256,
                       "node_capacity": n_nodes + 8, "proc_req": 0,
                       "checkpoint_dir": ckpt_dir,
                       "mail": {"enable": True, "http_api": recv.url}}, f)
        procs["store"] = port_proc(
            "store", "store", "--shards", "2", "--port", "0", "--wal",
            os.path.join(tmp, "store.wal"))
        procs["logd"] = port_proc(
            "logd", "logd", "--shards", "2", "--port", "0", "--db",
            os.path.join(tmp, "logd.db"))
        store_addr = procs["store"].ready(60)
        logd_addr = procs["logd"].ready(60)

        # phantom nodes registered without an agent, as in the trace bench
        t = time.perf_counter()
        client = connect_store(store_addr)
        seed(client, ks, n_jobs, n_nodes, lambda m: None)
        out["seed_s"] = time.perf_counter() - t

        wired = ["--store", store_addr, "--logsink", logd_addr, "--conf", conf]
        procs["sched"] = SchedProc(store_addr, conf, "pf-sched", *sched_args)
        for n in nodes:
            procs[n] = port_proc("node", n, *wired, "--node-id", n)
        procs["web"] = port_proc("web", "web", *wired, "--port", "0")
        for name in ("sched", *nodes, "web"):
            procs[name].ready(300)
        out["ready_s"] = {k: p.ready_s for k, p in procs.items()}

        web = WebClient(procs["web"].ready())
        web_url = f"http://{procs['web'].ready()}"
        ctl_ok(web_url, session, "login", "admin@admin.com", "--password",
               "admin")
        sse = SseWatch(web, set(FLEET_JOBS))
        for job, kind in FLEET_JOBS.items():
            web.call("PUT", "/v1/job", {
                "id": job, "name": job, "kind": kind, "group": "default",
                "command": "sh -c 'echo $CRONSUN_SCHEDULED_TS'",
                "rules": [{"timer": "* * * * * *", "nids": nodes}]})
        t_jobs = time.time()
        # the live seconds count from the first execution the stream shows
        deadline = time.perf_counter() + 60
        while sse.first is None and sse.error is None and \
                time.perf_counter() < deadline:
            for p in procs.values():
                p.check_alive()
            time.sleep(0.1)
        if sse.first is None:
            raise AssertionError(f"process_fleet: no execution event on "
                                 f"/v1/stream ({sse.events} events, "
                                 f"{sse.error!r})")
        out["sse_first_event_s"] = sse.first[0]
        t_live = time.time()
        if on_card:
            time.sleep(min(5.0, live_s / 2))
            apps = compute_apps()
            holders = {k: card_device_files(p.p.pid)
                       for k, p in procs.items()}
            out["card_contexts"] = {
                "compute_apps_before": apps_before, "compute_apps": apps,
                "device_files": {k: v for k, v in holders.items() if v}}
            if sum(m for _, m in apps) <= sum(m for _, m in apps_before) \
                    or [k for k, v in holders.items() if v] != ["sched"]:
                raise AssertionError(
                    f"process_fleet: CUDA contexts {out['card_contexts']}, "
                    f"want a new one, held by the scheduler alone")
        # scheduler checkpoints through the CLI through the live seconds:
        # a base, then deltas
        triggers = []
        while time.time() < t_live + live_s:
            for p in procs.values():
                p.check_alive()
            if len(triggers) < 3 and (not triggers or
                                      time.time() > triggers[-1] + 5.0):
                ctl_ok(web_url, session, "checkpoint")
                triggers.append(time.time())
            time.sleep(0.5)

        # the CLI's offline audit of the live fleet's 2-shard store and
        # result store: no finding
        t = time.perf_counter()
        rc, text, err = run_ctl(web_url, session, "fsck", "--store",
                                store_addr, "--logsink", logd_addr)
        out["fsck"] = {"rc": rc, "s": time.perf_counter() - t,
                       "out": text.strip().splitlines()[:5]}
        if rc != 0 or "clean" not in text:
            raise AssertionError(f"process_fleet: fsck exit {rc}:\n"
                                 f"{text}{err}")

        listed = {n["id"]: n for n in web.call("GET", "/v1/nodes")}
        if not all(listed.get(n, {}).get("connected") for n in nodes):
            raise AssertionError(f"process_fleet: agents not connected: "
                                 f"{[listed.get(n) for n in nodes]}")
        metrics = web.call("GET", "/v1/metrics")
        steps = [ln for ln in metrics.splitlines()
                 if ln.startswith("cronsun_sched_steps_total{")]
        if not steps or int(float(steps[0].rsplit(" ", 1)[1])) <= 0 or \
                "cronsun_sched_tick_p99_ms" not in metrics:
            raise AssertionError(f"process_fleet: no scheduler steps in "
                                 f"/v1/metrics: {steps}")
        lat = {}
        for path in ("/v1/logs", "/v1/nodes", "/v1/metrics"):
            ms = []
            for _ in range(requests):
                t = time.perf_counter()
                web.call("GET", path)
                ms.append((time.perf_counter() - t) * 1e3)
            lat[path] = {"p50_ms": float(np.percentile(ms, 50)),
                         "p99_ms": float(np.percentile(ms, 99))}
        out["web_ms"] = lat
        snap = json.loads(client.get(ks.metrics_key("sched", "pf-sched")).value)
        out.update(step_p50_ms=snap.get("sched_step_p50_ms"),
                   step_p99_ms=snap.get("sched_step_p99_ms"),
                   tick_p50_ms=snap.get("tick_p50_ms"),
                   tick_p99_ms=snap.get("tick_p99_ms"))

        # agent crash: the web shows it gone, its noticer pages the receiver
        t_kill = time.perf_counter()
        kill_ts = int(time.time())
        procs["pf-node-1"].stop(signal.SIGKILL)
        seen_down = alert = None
        while time.perf_counter() < t_kill + node_ttl + 5:
            if seen_down is None and not {
                    n["id"]: n for n in web.call("GET", "/v1/nodes")
            }["pf-node-1"].get("connected"):
                seen_down = time.perf_counter() - t_kill
            alert = next((t for t, _p, _c, n in recv.posts
                          if "pf-node-1" in n.get("subject", "")), None)
            if alert is not None and seen_down is not None:
                break
            time.sleep(0.1)
        if alert is None or seen_down is None:
            raise AssertionError(
                f"process_fleet: after the SIGKILL, disconnected at "
                f"{seen_down} s, alert {alert} (notices {recv.bodies()})")
        out.update(disconnected_after_s=seen_down, alert_delay_s=alert - t_kill)

        # shutdown: the scheduler first, with its launch counts
        rcs = {"pf-node-1": "SIGKILL"}
        rcs["sched"] = procs["sched"].stop(signal.SIGTERM)
        line = [ln for ln in procs["sched"].lines
                if "kernel launch counts:" in ln]
        if rcs["sched"] != 0 or not line:
            raise AssertionError(f"process_fleet: the scheduler exited "
                                 f"{rcs['sched']}:\n"
                                 f"{''.join(procs['sched'].lines[-40:])}")
        counts = json.loads(line[-1].split("kernel launch counts:", 1)[1])
        # the stopped scheduler's delta chain, folded by the CLI
        out["checkpoint_files"] = sorted(os.listdir(ckpt_dir))
        out["checkpoint_compact"] = ctl_ok(
            web_url, session, "checkpoint-compact", ckpt_dir).strip()
        if on_card and not all(counts.get(n) for n in SINGLE_DEVICE_KERNELS):
            raise AssertionError(f"a kernel never launched in the fleet's "
                                 f"scheduler: {counts}")
        rcs["pf-node-0"] = procs["pf-node-0"].stop(signal.SIGTERM)
        sink = connect_sharded_sink(logd_addr.split(","))
        out["executions"] = _check_fleet_runs(sink, nodes, kill_ts - 2, t_jobs)
        api_total = web.call("GET", "/v1/logs")["total"]
        sink_total = sink.stat_overall()["total"]
        if api_total != sink_total or sink.query_logs()[1] != sink_total:
            raise AssertionError(f"process_fleet: /v1/logs total {api_total}"
                                 f", the sink's {sink_total}")
        out["executions_total"] = sink_total
        sse.close()
        sse = None
        for name in ("web", "logd", "store"):
            rcs[name] = procs[name].stop(signal.SIGTERM)
        out["exit_codes"] = rcs
        if any(rc != 0 for k, rc in rcs.items() if k != "pf-node-1"):
            raise AssertionError(f"process_fleet: exit codes {rcs}")
        if os.path.exists(local_db):
            raise AssertionError("process_fleet: a process wrote the local "
                                 "log_db")
        out["launches_process_fleet"] = counts
        if on_card:
            out["card_mib_after"] = card_mib_used()
            out["nvidia_smi"] = nvidia_smi_line()
    finally:
        if sse is not None:
            sse.close()
        for p in procs.values():
            p.stop(signal.SIGKILL, timeout=30)
            p.save_log("fleet")
        for c in (client, sink):
            if c is not None:
                c.close()
        recv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return counts


DEMO_NODES = 4
DEMO_JOBS = 200         # imported through the CLI: half Common, half Alone
DEMO_PERIOD = 10        # ``*/10 * * * * *`` on every demo node
DEMO_LIVE_S = 30


def demo_jobs(n=DEMO_JOBS, nodes=DEMO_NODES, period=DEMO_PERIOD) -> list:
    """``job import``'s file: ``n`` jobs due every ``period`` seconds on
    every demo node (``node-<i>``), even ones Common, odd ones Alone; each
    run prints the second it was scheduled for."""
    return [{"name": f"dc{i:04d}", "group": "demo",
             "command": "sh -c 'echo $CRONSUN_SCHEDULED_TS'",
             "kind": i % 2,
             "rules": [{"timer": f"*/{period} * * * * *",
                        "nids": [f"node-{k}" for k in range(nodes)]}]}
            for i in range(n)]


def check_demo_runs(records, kinds, nodes, period, t_read, margin=3.0):
    """Hold ``/v1/logs`` records (dicts with ``jobId``, ``node``,
    ``beginTime``, ``output``) of the jobs in ``kinds`` (job id -> 0
    Common, 1 Alone), each due every ``period`` seconds: every job ran;
    from a job's first second up to ``t_read - margin``, a Common job ran
    on each of ``nodes`` once a second and an Alone job at most once a
    second (a second its previous run's fleet-wide lock still holds is
    skipped, as in the reference: counted).  A run's second is the one
    its output names (a job echoing ``$CRONSUN_SCHEDULED_TS``), else its
    begin time rounded to the period.  Raises on a miss; returns the
    counts."""
    by = {}
    for r in records:
        if r["jobId"] in kinds:
            out = r.get("output", "").strip()
            sec = int(out) if out.isdigit() else \
                int(round(r["beginTime"] / period)) * period
            by.setdefault(r["jobId"], {}).setdefault(sec, []).append(
                r["node"])
    last = int((t_read - margin) // period * period)
    never = sorted(set(kinds) - set(by))
    dupes, gaps, skipped, seconds = [], [], 0, 0
    for jid, secs in by.items():
        for sec in range(min(secs), last + 1, period):
            got = sorted(secs.get(sec, []))
            seconds += 1
            if kinds[jid] == 1:
                if len(got) > 1:
                    dupes.append((jid, sec, got))
                skipped += not got
            elif got != sorted(nodes):
                gaps.append((jid, sec, got))
    if never or dupes or gaps:
        raise AssertionError(f"demo runs: never ran {never[:5]} "
                             f"({len(never)}), Alone twice {dupes[:5]}, "
                             f"Common off its nodes {gaps[:5]}")
    return {"jobs": len(kinds), "job_seconds_checked": seconds,
            "alone_skipped_seconds": skipped,
            "records": sum(len(v) for s in by.values() for v in s.values())}


def run_ctl(url, session, *args, timeout=120):
    """One ``python3 -m cronsun_tpu_torch.bin.ctl`` run against ``url``:
    (exit code, stdout, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run([sys.executable, "-m", "cronsun_tpu_torch.bin.ctl",
                        "--url", url, "--session", session, *args],
                       cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def ctl_ok(url, session, *args) -> str:
    rc, out, err = run_ctl(url, session, *args)
    if rc != 0:
        raise AssertionError(f"cronsun-ctl {' '.join(args)}: exit {rc}\n"
                             f"{out}{err}")
    return out


def demo_child(out_path, argv) -> int:
    """The demo process of phase ``demo_ctl``: ``cronsun_tpu_torch.demo``'s
    ``main(argv)`` with the kernels' launch counts set to 0 before it and
    read after it, and one call of each kernel at each shape the demo gave
    it kept (``PathCalls``) and held against its plain version once the
    demo has stopped; written to ``out_path`` as JSON."""
    from cronsun_tpu_torch import demo
    from cronsun_tpu_torch.ops import kernels as k
    with PathCalls() as calls:
        k.reset_launch_counts()
        rc = demo.main(argv)
        counts = k.launch_counts()
    path = calls.check("demo_ctl")
    with open(out_path, "w") as f:
        json.dump({"rc": rc, "launches": counts, "path_checks": path}, f)
    return rc


def phase_demo_ctl(nodes=DEMO_NODES, n_jobs=DEMO_JOBS, live_s=DEMO_LIVE_S):
    """The port's one-process demo on the card, driven by the port's CLI
    (see the module docstring, phase 26).  Returns its launch counts and
    path checks."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="cronsun-demo-")
    session = os.path.join(tmp, "session")
    child_out = os.path.join(tmp, "demo.json")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    out = {"phase": "demo_ctl", "nodes": nodes, "jobs": n_jobs,
           "live_s": live_s}
    demo = follow = None
    try:
        apps_before = compute_apps()
        out["card_mib_before"] = card_mib_used()
        t = time.perf_counter()
        demo = Proc("chip_smoke", "--demo-child", child_out, "--nodes",
                    str(nodes), "--port", str(port), name="demo")
        deadline = time.perf_counter() + 300
        while not any(ln.startswith("cronsun-tpu demo up:")
                      for ln in demo.lines):
            demo.check_alive()
            if time.perf_counter() > deadline:
                raise AssertionError(f"demo_ctl: not up:\n{demo.output()}")
            time.sleep(0.1)
        out["up_s"] = time.perf_counter() - t
        ctl_ok(url, session, "login", "admin@admin.com", "--password",
               "admin")
        out["version"] = ctl_ok(url, session, "version").strip()
        jobs_file = os.path.join(tmp, "jobs.json")
        with open(jobs_file, "w") as f:
            json.dump(demo_jobs(n_jobs, nodes), f)
        t = time.perf_counter()
        imported = ctl_ok(url, session, "job", "import", jobs_file)
        out["import_s"] = time.perf_counter() - t
        if f"{n_jobs} job(s) imported" not in imported:
            raise AssertionError(f"demo_ctl: import said {imported[-200:]}")
        t_live = time.time()
        listed = json.loads(ctl_ok(url, session, "--json", "jobs"))
        kinds = {j["id"]: j["kind"] for j in listed if j["group"] == "demo"}
        seeded = [j for j in listed if j["group"] != "demo"]
        if len(kinds) != n_jobs or len(seeded) != 2:
            raise AssertionError(f"demo_ctl: {len(kinds)} imported and "
                                 f"{len(seeded)} seeded jobs listed")
        # a CLI process streams the logs through the live seconds; it (and
        # every CLI run) must hold no CUDA context, the demo must hold one
        follow = Proc("cronsun_tpu_torch.bin.ctl", "--url", url,
                      "--session", session, "logs", "--follow",
                      "--interval", "1", name="ctl-follow")
        time.sleep(min(8.0, live_s / 2))
        apps = compute_apps()
        holders = {"demo": card_device_files(demo.p.pid),
                   "ctl-follow": card_device_files(follow.p.pid)}
        out["card_contexts"] = {"compute_apps_before": apps_before,
                                "compute_apps": apps,
                                "device_files": holders}
        if sum(m for _, m in apps) <= sum(m for _, m in apps_before) or \
                not holders["demo"] or holders["ctl-follow"]:
            raise AssertionError(f"demo_ctl: CUDA contexts "
                                 f"{out['card_contexts']}, want a new one, "
                                 "held by the demo alone")
        cmds = {}
        for args in (["nodes"], ["executing"], ["sched", "status"],
                     ["run", seeded[0]["group"] + "-" + seeded[0]["id"],
                      "--node", "node-0"],
                     ["checkpoint"],
                     ["tenant", "set", "demo-tenant", "--rate", "50"],
                     ["tenant", "show", "demo-tenant"],
                     ["slo", "set", "demo-slo", "--target", "0.99"],
                     ["slo", "show"], ["trace", "top"]):
            t = time.perf_counter()
            text = ctl_ok(url, session, *args)
            cmds[" ".join(args[:2])] = {"s": time.perf_counter() - t,
                                        "lines": len(text.splitlines())}
        out["ctl"] = cmds
        if sum(ln.startswith("node-") and " up " in ln for ln in
               ctl_ok(url, session, "nodes").splitlines()) != nodes:
            raise AssertionError("demo_ctl: not every demo node is up")
        while time.time() < t_live + live_s:
            demo.check_alive()
            time.sleep(0.5)
        t_read = time.time()
        records, page = {}, 1
        while True:
            got = json.loads(ctl_ok(url, session, "--json", "logs",
                                    "--size", "500", "--page", str(page)))
            # by id: records landing while the pages are read push older
            # ones down a page, so one can be listed twice
            records.update((r["id"], r) for r in got["list"])
            if len(got["list"]) < 500:
                break
            page += 1
        records = list(records.values())
        out["log_total"] = got["total"]
        out["runs"] = check_demo_runs(records, kinds,
                                      [f"node-{k}" for k in range(nodes)],
                                      DEMO_PERIOD, t_read,
                                      margin=DEMO_PERIOD)
        follow_rc = follow.stop(signal.SIGINT, timeout=30)
        rc = demo.stop(signal.SIGTERM, timeout=120)
        summary = [ln for ln in demo.lines if ln.startswith("executed ")]
        import re
        # the demo counts the nodes of the sink's newest page of 50 records
        # (as the reference's does), so with 200 jobs it may name fewer than
        # ``nodes``; check_demo_runs above held every node's runs
        m = summary and re.fullmatch(r"executed (\d+) runs across (\d+) "
                                     r"nodes\n", summary[-1])
        if rc != 0 or not m or int(m.group(1)) < len(records) \
                or not 1 <= int(m.group(2)) <= nodes:
            raise AssertionError(f"demo_ctl: the demo exited {rc}:\n"
                                 f"{''.join(demo.lines[-40:])}")
        with open(child_out) as f:
            child = json.load(f)
        counts = child["launches"]
        if not all(counts.get(n) for n in SINGLE_DEVICE_KERNELS):
            raise AssertionError(f"demo_ctl: a kernel of the path never "
                                 f"launched: {counts}")
        unchecked = {n for n, c in counts.items() if c} - {
            c["kernel"] for c in child["path_checks"]}
        if unchecked:
            raise AssertionError(f"demo_ctl: no call of {unchecked} kept")
        out.update(summary=summary[-1].strip(), exit_codes={
            "demo": rc, "ctl-follow": follow_rc},
            launches_demo=counts, path_checks=child["path_checks"],
            card_mib_after=card_mib_used(), nvidia_smi=nvidia_smi_line())
    finally:
        for p in (follow, demo):
            if p is not None:
                p.stop(signal.SIGKILL, timeout=30)
                p.save_log("demo")
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return counts, child["path_checks"]


class ChildContexts:
    """While entered, samples every descendant process of this one (every
    0.2 s): the pids seen and any that held the card's device file open
    (a CUDA context; ``card_device_files``)."""

    def __init__(self):
        self.seen, self.holders = set(), {}

    def _children(self, pid):
        out = []
        try:
            for task in os.listdir(f"/proc/{pid}/task"):
                with open(f"/proc/{pid}/task/{task}/children") as f:
                    out += [int(c) for c in f.read().split()]
        except OSError:
            pass
        return out

    def _poll(self):
        while not self._stop.is_set():
            todo = self._children(os.getpid())
            while todo:
                pid = todo.pop()
                self.seen.add(pid)
                try:
                    held = card_device_files(pid)
                except OSError:
                    held = []
                if held:
                    self.holders[pid] = held
                todo += self._children(pid)
            self._stop.wait(0.2)

    def __enter__(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)


def _bench_errors(name, res):
    """The error rows of a host bench's result: an ``error`` entry or a
    nonzero ``*_errors`` / ``records_dropped`` count."""
    bad = {k: v for k, v in res.items()
           if k == "error" or ((k.endswith("_errors") or
                                k == "records_dropped") and v)}
    if bad:
        raise AssertionError(f"host_benches: {name}: {bad}")


def phase_host_benches():
    """The port's four host-plane benches at the shapes of their JAX smoke
    tests, on the Python store and result store (see the module
    docstring, phase 27).  Returns their seconds."""
    from cronsun_tpu_torch.scripts import (bench_dispatch, bench_push,
                                           bench_query, bench_store)
    env = {"BENCH_STORE": "py", "BENCH_LOGD": "py", "BENCH_AGENT": "py"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)
    runs = (
        ("bench_dispatch", lambda: bench_dispatch.run_quick(
            seconds=3, on_log=log)),
        ("bench_store", lambda: bench_store.run_stall_suite(
            n_keys=100_000, on_log=log)),
        ("bench_query", lambda: bench_query.run_query_bench(
            logd_shards=1, readers=3, seconds=1.5, seed_records=1000,
            on_log=log)),
        ("bench_push", lambda: bench_push.run_push_bench(
            viewers=20, seconds=1.5, write_rate=50, poll_viewers=3,
            on_log=log)))
    out, seconds = {"phase": "host_benches"}, {}
    try:
        for name, run in runs:
            with ChildContexts() as ctx:
                t = time.perf_counter()
                res = run()
                seconds[name] = time.perf_counter() - t
            _bench_errors(name, res)
            if ctx.holders:
                raise AssertionError(f"host_benches: {name}: processes "
                                     f"with a CUDA context {ctx.holders}")
            out[name] = {"seconds": seconds[name], "keys": sorted(res),
                         "child_processes": len(ctx.seen), "result": res}
        need = (out["bench_dispatch"]["result"]["agg_1_agent_per_s"] > 0,
                out["bench_store"]["result"].get(
                    "snapshot_stall_ratio_py") is not None,
                all(out["bench_query"]["result"][f"query_plane_{s}_qps"] > 0
                    for s in ("latest", "history", "stat_days")),
                out["bench_push"]["result"][
                    "push_plane_viewers_connected"] == 20)
        if not all(need):
            raise AssertionError(f"host_benches: gates {need}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["nvidia_smi"] = nvidia_smi_line()
    emit(out)
    return seconds


def phase_bench_quick(dev):
    """The port's bench at ``--quick`` in this process (see the module
    docstring, phase 28).  Returns the launch counts and the path checks."""
    from cronsun_tpu_torch.scripts import bench
    native = {p.error for p in bench.PLANES
              if dict(p.env).get("BENCH_AGENT") == "native"}
    cells = set()

    def run(log):
        detail, line = bench.run(True, dev, os.path.join(
            OUT_DIR, "bench_detail_torch.json"))
        cells.update(k for k in detail if k.startswith(
            ("rtt_", "kernel", "c1_", "c2_", "c3_", "c4_", "c5_",
             "headline_")))
        return {**detail, "result_line": line}

    def check(res, counts):
        line = res["result_line"]
        fired = {k: v for k, v in res.items()
                 if k.endswith("_fired_per_tick")}
        errors = {k: v for k, v in res.items()
                  if k.endswith("_error") and k not in native}
        need = {"result keys": set(line) == {"metric", "value", "unit",
                                             "vs_baseline"},
                "value > 0": line["value"] > 0,
                "kernels_equal": res["kernels_equal"] is True,
                "fired": len(fired) == 4 and all(v > 0
                                                 for v in fired.values()),
                "no error key": not errors}
        if not all(need.values()):
            raise AssertionError(f"bench_quick: {need}, errors {errors}")
        _need_launched("bench_quick", counts, SINGLE_DEVICE_KERNELS)

    return _run_bench_phase("bench_quick", run, check, lambda res: {
        "result_line": res["result_line"],
        **{k: res[k] for k in sorted(cells)}})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--demo-child"]:
        return demo_child(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=100,
                    help="timed windows of each headline, plain and armed "
                         "(default 100)")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler passes over headline windows")
    args = ap.parse_args(argv)

    smi = phase_device()
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seconds = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t, 3)
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, dev)
    timed("plan_equivalence", phase_plan_equivalence, dev)
    counts, path = timed("headline", phase_headline, dev, args.windows,
                         args.profile)
    timed("plan_equivalence_armed", phase_plan_equivalence_armed, dev)
    armed = timed("headline_armed", phase_headline_armed, dev, args.windows,
                  args.profile)
    timed("next_fire", phase_next_fire, dev)
    service = timed("service", phase_service, dev)
    launcher = timed("launcher", phase_launcher)
    timed("mesh_equivalence", phase_mesh_equivalence, dev)
    mesh = timed("mesh_headline", phase_mesh_headline, dev,
                 profile=args.profile)
    mesh_launcher = timed("mesh_launcher", phase_mesh_launcher)
    benches = {name: timed(name, fn, dev) for name, fn in (
        ("sched_bench", phase_sched_bench), ("sched_dag", phase_sched_dag),
        ("sched_tenants", phase_sched_tenants),
        ("sched_partitions", phase_sched_partitions),
        ("sched_herd", phase_sched_herd), ("mesh_ladder", phase_mesh_ladder),
        ("chaos_drills", phase_chaos_drills),
        ("sched_trace", phase_sched_trace))}
    fleet = timed("process_fleet", phase_process_fleet)
    demo, demo_path = timed("demo_ctl", phase_demo_ctl)
    timed("host_benches", phase_host_benches)
    bench_counts, bench_path = timed("bench_quick", phase_bench_quick, dev)
    emit({"phase_seconds": seconds, "total": round(sum(seconds.values()), 3)})
    bench_checks = [t for _, checked in benches.values() for t in checked
                    ] + demo_path + bench_path
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["launches_armed"] = armed[r["name"]]
        r["launches_service"] = service[r["name"]]
        r["launches_launcher"] = launcher.get(r["name"], 0)
        r["launches_mesh"] = {m: c[r["name"]] for m, c in mesh.items()}
        r["launches_mesh_launcher"] = mesh_launcher.get(r["name"], 0)
        for phase, (c, _) in benches.items():
            r[f"launches_{phase}"] = c[r["name"]]
        r["launches_process_fleet"] = fleet.get(r["name"], 0)
        r["launches_demo"] = demo.get(r["name"], 0)
        r["launches_bench"] = bench_counts[r["name"]]
        if r["name"] == "bid_argmin_natural":
            # K1n's path is the 2-D mesh: its launches are that run's
            r["launches"] = mesh["2d_2x2"][r["name"]]
        r["path"] = [{key: t[key] for key in ("ms", "bound_ms", "plain_ms")}
                     for t in path if t["name"] == r["name"]]
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            t["max_abs_err"] for t in path if t["name"] == r["name"]] + [
            t["max_abs_err"] for t in bench_checks
            if t["kernel"] == r["name"]])
        r["calls_checked_in_benches"] = sum(
            t["kernel"] == r["name"] for t in bench_checks)
        r.pop("work")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
