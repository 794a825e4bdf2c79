"""TickPlanner: the device-resident scheduling state + the windowed plan
(counterpart of ``cronsun_tpu/ops/planner.py``).

One planner holds every job's compiled schedule, the bit-packed eligibility
matrix and the per-node loads and capacities on one device, and answers
"who fires in each second of this window, and where does each run":

    fire mask [J, W] (once per window) -> per second: compact fired rows
    into an exclusive and a Common bucket -> Common fan-out into node load
    (K2) -> ``rounds`` bid (K1) / waterfill-accept rounds on the exclusive
    bucket

The per-second loop carries ``load`` and ``rem_cap``; every op in it is
functional, so a dispatched window never writes the planner's live tensors —
the window's results are assigned back once, in dispatch order.  On the card
nothing in :meth:`TickPlanner.plan_window_async` synchronizes: the outputs of
the whole window are packed into one int32 block and copied to pinned host
memory behind an event, which :meth:`TickPlanner.gather_window` waits on.

The workflow-DAG and tenant-admission arms of the JAX planner are not
ported yet; their switches raise.
"""

from __future__ import annotations

import dataclasses
import threading
from datetime import timezone
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import DeviceLike, resolve_device
from .assign import _assign_excl, _fanout_load, choose_impl
from .schedule_table import ScheduleTable, build_table, update_rows
from .tick import _fire_mask, window_field_matrix

_UTC = timezone.utc


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


_CB = 256   # compact block width


def _compact(fire: torch.Tensor, k: int):
    """Indices of up to k fired jobs + validity mask + overflow count, in
    ``nonzero`` order, without a sort: per-block fire counts and a short
    block-level cumsum locate each output's block by binary search; a
    [k, block] gather + row-wise running count finds the exact element.
    Tables whose J is not a multiple of the block use a plain cumsum +
    searchsorted.  Returns (idx [k] int32, valid [k] bool, total int32)."""
    J = fire.shape[0]
    dev = fire.device
    t = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    if J % _CB:
        counts = torch.cumsum(fire.to(torch.int32), 0, dtype=torch.int32)
        total = counts[-1] if J else torch.zeros((), dtype=torch.int32,
                                                  device=dev)
        idx = torch.searchsorted(counts, t, side="left").to(torch.int32)
        valid = t <= total
        return torch.where(valid, idx, 0), valid, total
    nb = J // _CB
    f2 = fire.reshape(nb, _CB).to(torch.int32)
    bcum = torch.cumsum(f2.sum(dim=1, dtype=torch.int32), 0, dtype=torch.int32)
    total = bcum[-1]
    blk = torch.searchsorted(bcum, t, side="left").clamp(max=nb - 1)
    rows = f2[blk]                                          # [k, _CB]
    rcum = torch.cumsum(rows, 1, dtype=torch.int32)
    prev = torch.where(blk > 0, bcum[(blk - 1).clamp(min=0)], 0)
    off = (rcum < (t - prev)[:, None]).sum(dim=1, dtype=torch.int32)
    idx = (blk * _CB + off).to(torch.int32)
    valid = t <= total
    return torch.where(valid, idx, 0), valid, total


def _plan_window_step(table: ScheduleTable, fields_w: torch.Tensor,
                      elig: torch.Tensor, exclusive: torch.Tensor,
                      cost: torch.Tensor, load: torch.Tensor,
                      rem_cap: torch.Tensor, kx: int, kc: int, rounds: int):
    """W seconds, exactly the semantics of W consecutive single ticks.

    The fire mask for all W seconds is one pass before the loop (the [J]
    table streams from memory once per window); fired rows compact into
    separate buckets by kind, so only exclusive fires (bucket kx) pay the
    ``rounds`` bid sweeps and Common fires (bucket kc) one fan-out.  Both
    kernels take the bucket's row indices and read the eligibility table
    themselves: no gathered tile is built.

    Returns (out [W, 2 + kx + kc + A] int32, load, rem_cap): per second the
    two fire totals, the exclusive then Common row indices, and the
    exclusive placements — int16 pairs packed into int32 words when node
    columns fit int16 (A = ceil(kx / 2)), else int32 (A = kx)."""
    with record_function("cronsun.fire_mask"):
        fire_w = _fire_mask(table, *fields_w.unbind(1)).T.contiguous()  # [W, J]
    n_cols = elig.shape[1] * 32
    adt = torch.int16 if n_cols <= 32767 else torch.int32
    not_excl = ~exclusive
    outs = []
    for fire_col in fire_w:
        with record_function("cronsun.compact"):
            xidx, xvalid, xtotal = _compact(fire_col & exclusive, kx)
            cidx, cvalid, ctotal = _compact(fire_col & not_excl, kc)
        with record_function("cronsun.fanout"):
            load = _fanout_load(elig, cvalid, cost[cidx], load, rows=cidx)
        with record_function("cronsun.assign"):
            assigned, load, rem_cap = _assign_excl(
                xvalid, elig, load, rem_cap, cost[xidx], rounds, rows=xidx)
        a = assigned.to(adt)
        if adt == torch.int16:
            a = F.pad(a, (0, kx % 2)).view(torch.int32)
        outs.append(torch.cat([torch.stack([xtotal, ctotal]), xidx, cidx, a]))
    return torch.stack(outs), load, rem_cap


class _AdaptiveBucket:
    """Adaptive fired-bucket size: ~1.3x headroom over the last observed
    fire count (overflowed ticks bounce back because ``feed`` reports the
    true total, not the truncated bucket).  Grows immediately; shrinks to a
    size never used before only after 300 consecutive smaller ticks, and to
    one already used at once."""

    def __init__(self, max_bucket: int, cap: int):
        self.max_bucket = max_bucket
        self.cap = cap
        self.last_total = max_bucket
        self.cur_k = 0
        self._shrink_streak = 0
        self._ticks_pending = 0
        self.seen: set = set()

    def feed(self, total: int, ticks: int):
        self.last_total = total
        self._ticks_pending += ticks

    def _want(self) -> int:
        """~1.3x headroom over the last observed fire count, snapped to a
        power of two within [2048, min(max_bucket->pow2, cap)]."""
        want = max(2048, self.last_total + (self.last_total >> 2)
                   + (self.last_total >> 4))
        return min(_next_pow2(min(want, self.max_bucket)), self.cap)

    def peek(self) -> int:
        """The size the next ``size(None)`` call would return, without
        mutating the hysteresis state."""
        return self.cur_k or self._want()

    def size(self, sla: Optional[int]) -> int:
        if sla is not None:
            # an explicit SLA overrides, clamped only by the structural cap
            return min(_next_pow2(sla), self.cap)
        ticks = max(1, self._ticks_pending)
        self._ticks_pending = 0
        want = self._want()
        if not self.cur_k or want > self.cur_k:
            self.cur_k = want
            self._shrink_streak = 0
        elif want < self.cur_k:
            self._shrink_streak += ticks
            if want in self.seen or self._shrink_streak >= 300:
                self.cur_k = want
                self._shrink_streak = 0
        else:
            self._shrink_streak = 0
        self.seen.add(self.cur_k)
        return self.cur_k


@dataclasses.dataclass
class TickPlan:
    """Result of one planning step (host-side views)."""
    epoch_s: int
    fired: np.ndarray        # [F] job rows that fired (valid entries)
    assigned: np.ndarray     # [F] node column for exclusive jobs, -1 for
                             #     Common (fan-out) or no-capacity skips
    overflow: int            # fired jobs beyond the bucket SLA
    total_fired: int = 0     # TRUE fire count this second (>= len(fired))
    n_excl: int = 0          # fired[:n_excl] are the exclusive placements
    # per-tenant refusal counts: None until tenant admission is ported
    tenant_throttled: Optional[np.ndarray] = None
    tenant_shed: Optional[np.ndarray] = None


@dataclasses.dataclass
class _WindowHandle:
    epoch_s: int
    kx: int
    kc: int
    adt: np.dtype            # numpy dtype of the packed placements
    out: torch.Tensor        # [W, 2 + kx + kc + A] int32 on the host
    ready: Optional[torch.cuda.Event]   # set when ``out`` has landed


class TickPlanner:
    """Owns device state; call :meth:`plan` once per second (or a window).

    Capacity model: ``rem_cap[n]`` is the node's remaining concurrency
    budget for exclusive placements.  The solve reserves a slot at plan time;
    executors release it with :meth:`job_finished`.  Common fan-out runs
    contribute load only (released with :meth:`common_finished`).

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch path.  Eligibility rows are int32 bit patterns of the uint32
    words the JAX planner holds.
    """

    def __init__(self, job_capacity: int, node_capacity: int,
                 tz=_UTC, rounds: int = 2,
                 max_fire_bucket: int = 65536, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.impl = choose_impl(self.device)
        self.tz = tz
        self.rounds = rounds
        self.max_fire_bucket = max_fire_bucket
        self.J = _next_pow2(job_capacity)
        self.N = ((node_capacity + 31) // 32) * 32
        dev = self.device
        self.table: ScheduleTable = build_table([], capacity=self.J, device=dev)
        self.elig = torch.zeros((self.J, self.N // 32), dtype=torch.int32,
                                device=dev)
        self.exclusive = torch.zeros(self.J, dtype=torch.bool, device=dev)
        self.cost = torch.ones(self.J, dtype=torch.float32, device=dev)
        self.load = torch.zeros(self.N, dtype=torch.float32, device=dev)
        self.rem_cap = torch.zeros(self.N, dtype=torch.int32, device=dev)
        # adaptive fired-buckets, one per kind
        self._bx = _AdaptiveBucket(max_fire_bucket, self.J)
        self._bc = _AdaptiveBucket(max_fire_bucket, self.J)
        # dispatch and gather may run on two threads; this lock covers the
        # adaptive buckets' hysteresis counters they both touch
        self._bucket_mu = threading.Lock()
        self._warmed_single: set = set()

    # -- state maintenance (fixed-shape, in-place scatters) -----------------

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def set_table(self, table: ScheduleTable):
        if table.capacity != self.J:
            raise ValueError(f"table capacity {table.capacity} != {self.J}")
        if table.device != self.device:
            raise ValueError(f"table on {table.device}, planner on {self.device}")
        self.table = table

    def update_table_rows(self, rows: np.ndarray, vals) -> None:
        """Scatter schedule-row updates into the table (in place)."""
        self.set_table(update_rows(self.table, rows, vals))

    def set_load(self, loads: np.ndarray) -> None:
        self.load = torch.as_tensor(np.asarray(loads, np.float32),
                                    device=self.device).clone()

    def set_eligibility_rows(self, rows: np.ndarray, values: np.ndarray):
        """``values`` [R, W32] uint32 words (or their int32 bit patterns)."""
        if len(rows):
            v = np.ascontiguousarray(values)
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            self.elig[self._rows(rows)] = torch.as_tensor(
                v.astype(np.int32, copy=False), device=self.device)

    def set_job_meta(self, rows: np.ndarray, exclusive: np.ndarray,
                     cost: np.ndarray):
        if len(rows):
            r = self._rows(rows)
            self.exclusive[r] = torch.as_tensor(np.asarray(exclusive, bool),
                                                device=self.device)
            self.cost[r] = torch.as_tensor(np.asarray(cost, np.float32),
                                           device=self.device)

    def set_node_capacity(self, cols: Sequence[int], caps: Sequence[int]):
        if len(cols):
            self.rem_cap[self._rows(cols)] = torch.as_tensor(
                np.asarray(caps, np.int32), device=self.device)

    @property
    def dep_enabled(self) -> bool:
        return False

    def set_dep_enabled(self, flag: bool = True):
        if flag:
            raise NotImplementedError(
                "workflow-DAG deps are not ported to the torch planner yet "
                "(ROADMAP queue 1, item 9: ops/deps.py and the use_deps arm)")

    @property
    def tenants_enabled(self) -> bool:
        return False

    def set_tenants_enabled(self, flag: bool = True):
        if flag:
            raise NotImplementedError(
                "tenant admission is not ported to the torch planner yet "
                "(ROADMAP queue 1, item 10: ops/tenancy.py and the "
                "use_tenants arm)")

    def job_finished(self, node_col: int, cost: float):
        """Exclusive execution completed: release the capacity slot the
        solve reserved and retire its load."""
        self.rem_cap[node_col] += 1
        self.load[node_col] -= float(cost)

    def common_finished(self, node_col: int, cost: float):
        """Common (fan-out) execution completed: retire load only."""
        self.load[node_col] -= float(cost)

    def decay_load(self, factor: float = 0.99):
        self.load = self.load * factor

    # -- the tick ------------------------------------------------------------

    def plan_async(self, epoch_s: int, sla_bucket: Optional[int] = None):
        """Dispatch one tick (a one-second window) without synchronizing."""
        return self.plan_window_async(epoch_s, 1, sla_bucket)

    def gather(self, handle) -> TickPlan:
        return self.gather_window(handle)[0]

    def plan(self, epoch_s: int, sla_bucket: Optional[int] = None) -> TickPlan:
        """Fire + place every job due at ``epoch_s`` (one-second tick)."""
        return self.gather(self.plan_async(epoch_s, sla_bucket))

    # -- windowed planning ---------------------------------------------------

    def _dispatch(self, epoch_s: int, window_s: int, kx: int, kc: int):
        """Enqueue one window and its copy to the host; returns
        (handle, load, rem_cap) without touching the planner's state."""
        fields_w = torch.from_numpy(
            window_field_matrix(epoch_s, window_s, self.tz)).to(self.device)
        out, load, rem_cap = _plan_window_step(
            self.table, fields_w, self.elig, self.exclusive, self.cost,
            self.load, self.rem_cap, kx, kc, self.rounds)
        adt = np.int16 if self.N <= 32767 else np.int32
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = out, None
        return _WindowHandle(epoch_s, kx, kc, adt, host, ready), load, rem_cap

    def plan_window_async(self, epoch_s: int, window_s: int,
                          sla_bucket: Optional[int] = None):
        """Dispatch one window of ``window_s`` consecutive seconds.

        ``sla_bucket`` pins both buckets: an int pins each to it, a
        (kx, kc) tuple pins them separately.  Handles may be pipelined:
        carried load/capacity chain in dispatch order.  Dispatch must stay
        on ONE thread; gather may run on another."""
        if isinstance(sla_bucket, tuple):
            sla_x, sla_c = sla_bucket
        else:
            sla_x = sla_c = sla_bucket
        with self._bucket_mu:
            kx = self._bx.size(sla_x)
            kc = self._bc.size(sla_c)
        with record_function("cronsun.plan.dispatch"):
            handle, self.load, self.rem_cap = self._dispatch(
                epoch_s, window_s, kx, kc)
        return handle

    def gather_window(self, handle: _WindowHandle):
        """Materialize a window dispatch into a list of TickPlans.

        Exclusive placements come first in ``fired``/``assigned``; Common
        fires follow with assigned = -1 (fan-out is the dispatcher's job)."""
        kx, kc = handle.kx, handle.kc
        with record_function("cronsun.plan.gather"):
            if handle.ready is not None:
                handle.ready.synchronize()
            o = handle.out.numpy()
        W = o.shape[0]
        oa = np.ascontiguousarray(o[:, 2 + kx + kc:]).view(handle.adt)[:, :kx]
        plans = []
        for w in range(W):
            xt, ct = int(o[w, 0]), int(o[w, 1])
            nx, nc = min(xt, kx), min(ct, kc)
            fired = np.concatenate([o[w, 2:2 + nx], o[w, 2 + kx:2 + kx + nc]])
            assigned = np.concatenate(
                [oa[w, :nx].astype(np.int32), np.full(nc, -1, np.int32)])
            plans.append(TickPlan(
                epoch_s=handle.epoch_s + w, fired=fired, assigned=assigned,
                overflow=max(0, xt - kx) + max(0, ct - kc),
                total_fired=xt + ct, n_excl=nx))
        if W:
            with self._bucket_mu:
                self._bx.feed(int(o[:, 0].max()), W)
                self._bc.feed(int(o[:, 1].max()), W)
        return plans

    def plan_window(self, epoch_s: int, window_s: int,
                    sla_bucket: Optional[int] = None):
        return self.gather_window(
            self.plan_window_async(epoch_s, window_s, sla_bucket))

    def warm_window(self, epoch_s: int, window_s: int) -> None:
        """Run one window at the buckets a fresh leader's first plan would
        use WITHOUT mutating carried state or bucket hysteresis: builds the
        kernels and fills the allocator's caches before a takeover."""
        with self._bucket_mu:
            kx, kc = self._bx.peek(), self._bc.peek()
        handle, _, _ = self._dispatch(epoch_s, window_s, kx, kc)
        if handle.ready is not None:
            handle.ready.synchronize()

    def warm_escalation(self, epoch_s: int, factor: int = 4) -> int:
        """Run the single-second overflow replan at the escalated bucket a
        cron-herd burst will request, without mutating carried state;
        records and returns the warmed bucket size."""
        with self._bucket_mu:
            k = min(_next_pow2(max(self._bx.peek(),
                                   self._bc.peek()) * factor), self.J)
        handle, _, _ = self._dispatch(epoch_s, 1, k, k)
        if handle.ready is not None:
            handle.ready.synchronize()
        self._warmed_single.add(k)
        return k

    def snap_escalation(self, want: int) -> int:
        """Smallest warmed single-second bucket >= ``want``, else ``want``."""
        cands = [s for s in self._warmed_single if s >= want]
        return min(cands) if cands else want
