"""The ``binpack`` runner: the ``planner`` runner's closed loop (windows of
W seconds dispatched back to back, ``pipeline`` in flight) on a planner
whose nodes have a few slots each, with the executors played.

Every exclusive placement and every Common fire runs for its row's run
time (:func:`portbench.binpack_reference.run_seconds`), and the runner
releases it by the cell's rule: before window k is dispatched, every
gathered run that has ended by its first second e_k goes back through the
planner's bulk releases, ``jobs_finished`` (slots and load) and
``commons_finished`` (load).  So slots taken in a window free at later
boundaries.  The reference replays them from the record of each dispatch
(e_k and the seconds gathered by then).

The host clock times the program alone: the planner's calls, the bulk
releases among them, are on it; the executors' own bookkeeping (filing
each gathered run by the boundary that releases it, and collecting a
boundary's runs) is taken off it, as a deployment's executors run on
other hosts.  Under a profiler that bookkeeping is the range
:data:`EXECUTORS`, so the trace names its gaps.

A program without the bulk releases cannot run the cell: the runner
exits at once, before it draws or installs anything.
"""

from __future__ import annotations

import collections
import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from . import binpack_reference as bref
from . import gen, planner_cell
from .planner_cell import _install, _second
from .trace import profiled

# the profiler range of the executors' bookkeeping
EXECUTORS = "portbench.executors"


class _Executors:
    """The runs the planner placed, each held until the dispatch that
    releases it: filed at gather by the first window boundary at or after
    its end."""

    def __init__(self, p, run: np.ndarray, cost: np.ndarray, start: int,
                 W: int):
        self.p, self.start, self.W = p, start, W
        # one cost for every row (the configurations' [1, 1]) is passed as
        # a scalar, saving a gather a run
        self.cost = cost[0] if len(cost) and (cost == cost[0]).all() \
            else cost
        # q[j, row]: how many boundaries after the one that opens its
        # window a run of ``row`` fired at its j-th second is released,
        # ceil((j + run) / W): one small gather a run at filing
        q = -(-(np.arange(W)[:, None] + run[None, :]) // W)
        self.q = q.astype(np.uint8 if q.max() < 256 else np.uint16)
        # boundary index -> [[exclusive cols, their rows], ...] and
        # -> [[Common rows], ...]
        self.x_due: dict = collections.defaultdict(list)
        self.c_due: dict = collections.defaultdict(list)
        self.off_clock = 0.0     # seconds of bookkeeping, off the clock

    @contextlib.contextmanager
    def _bookkeeping(self):
        t = time.perf_counter()
        with record_function(EXECUTORS):
            yield
        self.off_clock += time.perf_counter() - t

    def gathered(self, plans) -> None:
        """File the runs of a gathered window."""
        with self._bookkeeping():
            first = plans[0].epoch_s
            cols, xrows, xq, crows, cq = [], [], [], [], []
            for pl in plans:
                q = self.q[pl.epoch_s - first]
                nx = pl.n_excl
                a = pl.assigned[:nx]
                ok = a >= 0
                r = pl.fired[:nx][ok]
                cols.append(a[ok])
                xrows.append(r)
                xq.append(q[r])
                c = pl.fired[nx:]
                crows.append(c)
                cq.append(q[c])
            k = (first - self.start) // self.W
            self._file(self.x_due, k, np.concatenate(xq),
                       np.concatenate(cols), np.concatenate(xrows))
            self._file(self.c_due, k, np.concatenate(cq),
                       np.concatenate(crows))

    @staticmethod
    def _file(due: dict, k: int, q: np.ndarray, *cols) -> None:
        """File entries at boundary ``k + q``: one stable radix sort by
        ``q``, then slices."""
        order = np.argsort(q, kind="stable")
        cols = [c[order] for c in cols]
        lo = 0
        for i, hi in enumerate(np.cumsum(np.bincount(q)).tolist()):
            if hi > lo:
                due[k + i].append([c[lo:hi] for c in cols])
            lo = hi

    @staticmethod
    def _pop(due: dict, k: int):
        ready = [i for i in due if i <= k]
        return [b for i in ready for b in due.pop(i)]

    def release(self, epoch: int) -> None:
        """Release every filed run that has ended by ``epoch``, a window
        boundary."""
        with self._bookkeeping():
            k = (epoch - self.start) // self.W
            xs, cs = self._pop(self.x_due, k), self._pop(self.c_due, k)
            if xs:
                cols = np.concatenate([b[0] for b in xs])
                xcost = self._costs(np.concatenate([b[1] for b in xs]))
            if cs:
                rows = np.concatenate([b[0] for b in cs])
                ccost = self._costs(rows)
        if xs:
            self.p.jobs_finished(cols, xcost)
        if cs:
            self.p.commons_finished(rows, ccost)

    def _costs(self, rows: np.ndarray):
        return self.cost if np.ndim(self.cost) == 0 else self.cost[rows]


class _Loop(planner_cell._Loop):
    """The planner runner's loop, each dispatch preceded by the releases
    it is due and each gathered window filed with the executors."""

    def __init__(self, p, epoch: int, W: int, sla, pipeline: int,
                 execs: _Executors):
        super().__init__(p, epoch, W, sla, pipeline)
        self.execs = execs
        self.releases = []       # (e_k, seconds gathered), one a dispatch

    def step(self):
        self.releases.append((self.epoch, len(self.seconds)))
        self.execs.release(self.epoch)
        plans = super().step()
        if plans is not None:
            self.execs.gathered(plans)
        return plans

    def drain(self):
        while self.inflight:
            plans = self.p.gather_window(self.inflight.popleft())
            self.seconds.extend(_second(pl) for pl in plans)
            self.execs.gathered(plans)


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float):
    """One run of a bin-packing cell; returns the context the metric
    readers and the harness read."""
    from cronsun_tpu_torch.ops.planner import TickPlanner
    if not hasattr(TickPlanner, "jobs_finished"):
        raise SystemExit("portbench: the binpack runner needs the planner's "
                         "bulk releases (TickPlanner.jobs_finished, "
                         "commons_finished); this program has none")
    cfg, mix = spec.config, spec.traffic
    dev = torch.device(device)
    inp = gen.planner_inputs(cfg, mix, seed, dev)
    p = _install(inp, cfg, dev)
    W, pipeline = int(cfg["window_s"]), int(cfg["pipeline"])
    sla = tuple(int(x) for x in mix["sla_bucket"])
    start = int(mix["start_epoch"])
    execs = _Executors(p, bref.run_seconds(cfg, inp, seed).cpu().numpy(),
                       inp.cost.cpu().numpy(), start, W)
    loop = _Loop(p, start, W, sla, pipeline, execs)
    for _ in range(int(cfg["warm_windows"]) + pipeline):
        loop.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx = SimpleNamespace(kind="binpack", W=W, bucket=sla,
                          w32=inp.elig.shape[1], rounds=int(cfg["rounds"]),
                          setup_s=time.perf_counter() - t0)
    # the stamps are on the program's clock: the wall less the executors'
    # bookkeeping; the run lasts ``seconds`` of wall
    stamps, placed, excl, unplaced, short = [], 0, 0, 0, 0
    t_open = time.perf_counter()
    off_open = execs.off_clock
    while True:
        plans = loop.step()
        if plans is None:
            continue
        now = time.perf_counter()
        stamps.append(now - (execs.off_clock - off_open))
        missed = 0
        for pl in plans:
            n_placed = int(np.count_nonzero(pl.assigned[:pl.n_excl] >= 0))
            placed += n_placed + len(pl.fired) - int(pl.n_excl)
            excl += int(pl.n_excl)
            missed += int(pl.n_excl) - n_placed
        unplaced += missed
        short += missed > 0
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
    done, releases = loop.seconds, loop.releases
    del p, loop, inp, execs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = {"windows": ctx.windows, "placed_fires": ctx.placed_fires,
               "tick_ms_p50": float(np.percentile(ctx.intervals_s, 50))
               / W * 1e3,
               "timed_unplaced_share": unplaced / max(1, excl),
               "timed_windows_with_unplaced": short / max(1, ctx.windows)}

    def check():
        inp2 = gen.planner_inputs(cfg, mix, seed, dev)
        checks, attempted, failed, shares = bref.check_binpack(
            inp2, sla, W, done, releases, bref.run_seconds(cfg, inp2, seed),
            load, rem_cap, cfg["limits"], seed)
        return checks, attempted, failed, dict(
            summary, **shares, checked_seconds=[done[0][0],
                                                done[-1][0] + 1])
    ctx.check = check
    return ctx
