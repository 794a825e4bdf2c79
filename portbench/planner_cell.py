"""The ``planner`` runner: a ``TickPlanner`` of the port planning windows
back to back, as a planner that plans ahead of the clock does (a closed
loop: each window is dispatched as soon as the pipeline has room).

Set-up installs the rows drawn by :func:`portbench.gen.planner_inputs`,
warms the cell's one bucket shape and fills the pipeline.  The timed
window keeps ``pipeline`` windows in flight; each gather is stamped.  A
traced run then profiles ``trace_windows`` more windows.  Every window
since the planner was built, warm-up and drain included, goes to the
reference.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import gen, reference
from .trace import profiled


def _second(pl) -> reference.Second:
    return (int(pl.epoch_s), pl.fired, pl.assigned, int(pl.n_excl),
            int(pl.total_fired), int(pl.overflow))


def _install(inp: gen.PlannerInputs, cfg: dict, device):
    """A TickPlanner of the port holding ``inp``."""
    from cronsun_tpu_torch.ops.planner import TickPlanner
    from cronsun_tpu_torch.ops.schedule_table import (FRAMEWORK_EPOCH,
                                                      build_table, make_row)
    J, N = inp.jobs, inp.nodes
    p = TickPlanner(job_capacity=J, node_capacity=N,
                    rounds=int(cfg["rounds"]),
                    max_fire_bucket=int(cfg["max_fire_bucket"]), device=device)
    if p.J != J or p.N != N:
        raise ValueError(f"the planner holds {p.J} x {p.N}, the cell "
                         f"{J} x {N}: jobs must be a power of two")
    table = build_table([], capacity=J, device=device)
    table.active.fill_(True)
    table.is_every.copy_(inp.is_every)
    table.period.copy_(inp.period.to(torch.int32))
    table.phase_mod.copy_(torch.remainder(inp.anchor - FRAMEWORK_EPOCH,
                                          inp.period).to(torch.int32))
    for i, fam in enumerate(inp.families):
        if "cron" not in fam:
            continue
        rows = inp.family == i
        for k, v in make_row(fam["cron"]).items():
            col = getattr(table, k)
            if isinstance(v, tuple):
                v = torch.tensor(v, dtype=col.dtype, device=col.device)
            elif col.dtype == torch.int32 and v >= 2**31:
                v -= 2**32            # a uint32 word as its int32 bits
            col[rows] = v
    p.set_built_state(table, inp.elig, inp.exclusive, inp.cost)
    p.set_node_capacity(np.arange(N), inp.node_cap.cpu().numpy())
    return p


class _Loop:
    """Windows dispatched back to back with ``pipeline`` in flight."""

    def __init__(self, p, epoch: int, W: int, sla, pipeline: int):
        self.p, self.epoch, self.W, self.sla = p, epoch, W, sla
        self.pipeline = pipeline
        self.inflight = collections.deque()
        self.seconds = []

    def step(self):
        """Dispatch one window; gather the oldest once more than
        ``pipeline`` are in flight.  Returns its plans or None."""
        self.inflight.append(self.p.plan_window_async(
            self.epoch, self.W, sla_bucket=self.sla))
        self.epoch += self.W
        if len(self.inflight) <= self.pipeline:
            return None
        plans = self.p.gather_window(self.inflight.popleft())
        self.seconds.extend(_second(pl) for pl in plans)
        return plans

    def drain(self):
        while self.inflight:
            self.seconds.extend(_second(pl) for pl in
                                self.p.gather_window(self.inflight.popleft()))


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of a planner cell; returns the context the metric readers
    and the harness read."""
    cfg, mix = spec.config, spec.traffic
    dev = torch.device(device)
    inp = gen.planner_inputs(cfg, mix, seed, dev)
    p = _install(inp, cfg, dev)
    W, pipeline = int(cfg["window_s"]), int(cfg["pipeline"])
    sla = tuple(int(x) for x in mix["sla_bucket"])
    loop = _Loop(p, int(mix["start_epoch"]), W, sla, pipeline)
    for _ in range(int(cfg["warm_windows"]) + pipeline):
        loop.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx = SimpleNamespace(kind="planner", W=W, bucket=sla,
                          w32=inp.elig.shape[1], rounds=int(cfg["rounds"]),
                          setup_s=time.perf_counter() - t0)
    stamps, placed = [], 0
    t_open = time.perf_counter()
    while True:
        plans = loop.step()
        if plans is None:
            continue
        now = time.perf_counter()
        stamps.append(now)
        for pl in plans:
            placed += int(np.count_nonzero(pl.assigned[:pl.n_excl] >= 0))
            placed += len(pl.fired) - int(pl.n_excl)
        if now - t_open >= seconds:
            break
    ctx.intervals_s = np.diff(np.asarray([t_open] + stamps))
    ctx.window_wall_s = stamps[-1] - t_open
    ctx.placed_fires = placed
    ctx.windows = len(stamps)
    loop.drain()
    ctx.trace = None
    if trace:
        first = len(loop.seconds)
        with profiled(dev.type) as got:
            for _ in range(int(cfg["trace_windows"])):
                loop.step()
            loop.drain()
        ctx.trace = got[0]
        ctx.traced = [(s[3], len(s[1]) - s[3]) for s in loop.seconds[first:]]
        ctx.traced_seconds = len(ctx.traced)
    ctx.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    load = p.load.cpu().numpy()
    rem_cap = p.rem_cap.cpu().numpy()
    done = loop.seconds
    del p, loop, inp
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = {"windows": ctx.windows, "placed_fires": ctx.placed_fires,
               "tick_ms_p50": float(np.percentile(ctx.intervals_s, 50))
               / W * 1e3}

    def check():
        checks, attempted, failed = reference.check_planner(
            gen.planner_inputs(cfg, mix, seed, dev), sla, done, load,
            rem_cap, cfg["limits"], seed)
        return checks, attempted, failed, dict(
            summary, checked_seconds=[done[0][0], done[-1][0] + 1])
    ctx.check = check
    return ctx
