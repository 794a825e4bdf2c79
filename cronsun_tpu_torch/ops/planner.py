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
:meth:`TickPlanner.plan_window_async` reads no tensor value back: each accept
round is one kernel launch (``ops.assign``), and the one wait for the
stream is the window's pageable upload of the field matrix.  The outputs of
the whole window
are packed into one int32 block and copied to pinned host memory behind an
event, which :meth:`TickPlanner.gather_window` waits on.

Every stage of the path is a span of :mod:`.spans` (``cronsun.plan.dispatch``,
``cronsun.fire_mask``, ..., ``cronsun.plan.gather``), recorded in the
planner's :attr:`TickPlanner.spans` per window, and a profiler range while
a profiler runs; each call that waits for the stream is a ``cronsun.sync``.

The setters, however, write the live tensors in place (``update_rows``
scatters into the table, ``set_eligibility_rows`` into ``elig``), and a
window is issued op by op: the fire mask reads the table once, the dep arm
reads ``dep_cols`` every second, K1 and K2 read ``elig`` every round.  A
write issued while a window is being issued would land between two of its
seconds, and the window would plan half on the old state and half on the
new.  So the planner owns one lock, :attr:`TickPlanner.lock`: a dispatch
holds it while it issues the window and installs the carried state, and
every state setter holds it too.  On the card all of them issue on the
planner's stream, so stream order is issue order whatever the calling
thread's current stream is.  A write issued before a dispatch is seen by
it, and one issued after is not — the JAX planner's snapshot semantics,
without a copy of ``elig``.

Two arms fold into each second when armed (``set_dep_enabled``,
``set_tenants_enabled``): the workflow-DAG trigger (:mod:`.deps`) ORs dep
fires into the time fires and carries ``dep_last_fire``; tenant admission
(:mod:`.tenancy`) clamps each tenant's fires to its token bucket and fair
share and carries ``tb_tokens``.  A disarmed arm is a Python branch not
taken: the step reads none of its tensors and issues none of its ops.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from datetime import timezone
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .assign import _assign_excl, _fanout_load, choose_impl
from .deps import NEVER, dep_ready
from .kernels import fanout_add
from .schedule_table import (ScheduleTable, build_table, column_numpy,
                             column_tensor, table_to_numpy, update_rows)
from .spans import RELEASE, SYNC, UNPLACED, SpanRecorder, Window, span
from .tenancy import TenantOrder, admit
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


@dataclasses.dataclass
class _DepArm:
    """The dep arm's operands for one window: the folded epochs, the gate,
    the carried ``last_fire``, and each second's framework-relative
    epoch."""
    succ: torch.Tensor
    fail: torch.Tensor
    block: torch.Tensor
    last_fire: torch.Tensor
    t_rel: Sequence[int]


@dataclasses.dataclass
class _TenantArm:
    """The tenant arm's operands for one window: the row order, the
    bucket columns and the carried tokens."""
    order: TenantOrder
    rate: torch.Tensor
    burst: torch.Tensor
    limited: torch.Tensor
    weight: torch.Tensor
    tokens: torch.Tensor


def _plan_window_step(table: ScheduleTable, fields_w: torch.Tensor,
                      elig: torch.Tensor, exclusive: torch.Tensor,
                      cost: torch.Tensor, load: torch.Tensor,
                      rem_cap: torch.Tensor, kx: int, kc: int, rounds: int,
                      deps: Optional[_DepArm] = None,
                      tenants: Optional[_TenantArm] = None):
    """W seconds, exactly the semantics of W consecutive single ticks.

    The fire mask for all W seconds is one pass before the loop (the [J]
    table streams from memory once per window); fired rows compact into
    separate buckets by kind, so only exclusive fires (bucket kx) pay the
    ``rounds`` bid sweeps and Common fires (bucket kc) one fan-out.  Both
    kernels take the bucket's row indices and read the eligibility table
    themselves: no gathered tile is built.

    ``deps`` ORs each second's dep fires into the time fires and advances
    the carried ``last_fire``; ``tenants`` then admits the fires through
    the token buckets and the fair share, carrying the tokens.  A dep fire
    that admission refuses does not advance its ``last_fire``: it retries.

    Returns (out [W, 2 + kx + kc + A (+ 2T)] int32, load, rem_cap,
    last_fire, tokens): per second the two fire totals, the exclusive then
    Common row indices, the exclusive placements — int16 pairs packed into
    int32 words when node columns fit int16 (A = ceil(kx / 2)), else int32
    (A = kx) — and, with tenants, the per-tenant throttled then shed
    counts.  ``last_fire``/``tokens`` are None for a disarmed arm."""
    with span("cronsun.fire_mask"):
        fire_w = _fire_mask(table, *fields_w.unbind(1)).T.contiguous()  # [W, J]
    n_cols = elig.shape[1] * 32
    adt = torch.int16 if n_cols <= 32767 else torch.int32
    not_excl = ~exclusive
    last_fire = deps.last_fire if deps is not None else None
    tokens = tenants.tokens if tenants is not None else None
    if tenants is not None:
        ex_p = exclusive[tenants.order.perm]
    outs = []
    for w, fire_col in enumerate(fire_w):
        time_col = fire_col
        if deps is not None:
            with span("cronsun.deps"):
                dep_f, consume, round_max = dep_ready(
                    table, deps.succ, deps.fail, deps.block, last_fire)
                fire_col = fire_col | dep_f
        if tenants is not None:
            with span("cronsun.tenants"):
                admitted, tokens, thr, shed = admit(
                    fire_col, time_col, ex_p, tokens, tenants.rate,
                    tenants.burst, tenants.limited, tenants.weight, rem_cap,
                    tenants.order)
                fire_col = fire_col & admitted
        if deps is not None:
            with span("cronsun.deps"):
                # advance to the newest consumed upstream epoch, not just
                # the tick; a throttled dep fire does not advance
                eff = dep_f & fire_col if tenants is not None else dep_f
                last_fire = torch.where(eff | consume,
                                        round_max.clamp(min=deps.t_rel[w]),
                                        last_fire)
        with span("cronsun.compact"):
            xidx, xvalid, xtotal = _compact(fire_col & exclusive, kx)
            cidx, cvalid, ctotal = _compact(fire_col & not_excl, kc)
        with span("cronsun.fanout"):
            load = _fanout_load(elig, cvalid, cost[cidx], load, rows=cidx)
        with span("cronsun.assign"):
            assigned, load, rem_cap = _assign_excl(
                xvalid, elig, load, rem_cap, cost[xidx], rounds, rows=xidx)
        a = assigned.to(adt)
        if adt == torch.int16:
            a = F.pad(a, (0, kx % 2)).view(torch.int32)
        parts = [torch.stack([xtotal, ctotal]), xidx, cidx, a]
        if tenants is not None:
            parts += [thr, shed]
        outs.append(torch.cat(parts))
    return torch.stack(outs), load, rem_cap, last_fire, tokens


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
    # per-tenant-id refusal counts this second ([T] int32; None while the
    # tenant arm is disarmed): throttled = all refused fires, shed = the
    # time-triggered subset (refused dep fires retry)
    tenant_throttled: Optional[np.ndarray] = None
    tenant_shed: Optional[np.ndarray] = None


@dataclasses.dataclass
class _WindowHandle:
    epoch_s: int
    kx: int
    kc: int
    adt: np.dtype            # numpy dtype of the packed placements
    nt: int                  # tenant ids in the per-tenant counts, 0 if none
    out: torch.Tensor        # [W, 2 + kx + kc + A + 2 nt] int32 on the host
    ready: Optional[torch.cuda.Event]   # set when ``out`` has landed
    window: Optional[Window] = None     # its spans (None for a warm-up)


class TickPlanner:
    """Owns device state; call :meth:`plan` once per second (or a window).

    Capacity model: ``rem_cap[n]`` is the node's remaining concurrency
    budget for exclusive placements.  The solve reserves a slot at plan time;
    executors release it with :meth:`job_finished`.  Common fan-out runs
    contribute load only (released with :meth:`common_finished`).  A fleet
    whose runs end by the thousand a second releases them in bulk
    (:meth:`jobs_finished`, :meth:`commons_finished`): one upload and a few
    launches a call, no wait for the stream.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch path.  Eligibility rows are int32 bit patterns of the uint32
    words the JAX planner holds.

    Thread safety: :attr:`lock` (reentrant) serializes window dispatch
    against every state write, so a dispatched window sees either all or
    none of a write (see the module docstring).  On the card the planner
    issues on the stream that was current on its device when it was built
    (the default stream unless the caller chose another): tensors callers
    build or read on that stream stay ordered with the planner's work
    without a ``record_stream``.
    """

    def __init__(self, job_capacity: int, node_capacity: int,
                 tz=_UTC, rounds: int = 2,
                 max_fire_bucket: int = 65536, tenant_capacity: int = 64,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.impl = choose_impl(self.device)
        self.lock = threading.RLock()
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
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
        # workflow DAG state: folded completion epochs, the carried
        # last-fire vector and the max_in_flight gate
        self.dep_succ = torch.full((self.J,), NEVER, dtype=torch.int32,
                                   device=dev)
        self.dep_fail = torch.full((self.J,), NEVER, dtype=torch.int32,
                                   device=dev)
        self.dep_last_fire = torch.zeros(self.J, dtype=torch.int32,
                                         device=dev)
        self.dep_block = torch.zeros(self.J, dtype=torch.bool, device=dev)
        self._dep_enabled = False
        # tenant admission state: per-tenant bucket columns (tokens carried
        # through the window) and the host row->tenant snapshot the
        # admission order derives from, recomputed when it changes
        self.T = _next_pow2(max(2, tenant_capacity))
        self.tb_rate = torch.zeros(self.T, dtype=torch.float32, device=dev)
        self.tb_burst = torch.zeros(self.T, dtype=torch.float32, device=dev)
        self.tb_limited = torch.zeros(self.T, dtype=torch.bool, device=dev)
        self.tb_weight = torch.ones(self.T, dtype=torch.float32, device=dev)
        self.tb_tokens = torch.zeros(self.T, dtype=torch.float32, device=dev)
        self._tenants_enabled = False
        self._tenant_np = np.zeros(self.J, np.int32)
        self._tn_order: Optional[TenantOrder] = None
        # adaptive fired-buckets, one per kind
        self._bx = _AdaptiveBucket(max_fire_bucket, self.J)
        self._bc = _AdaptiveBucket(max_fire_bucket, self.J)
        # dispatch and gather may run on two threads; this lock covers the
        # adaptive buckets' hysteresis counters they both touch
        self._bucket_mu = threading.Lock()
        self._warmed_single: set = set()
        # the spans of the windows it planned, and their running totals
        self.spans = SpanRecorder()
        # pinned host buffers of the bulk releases' uploads, each kept
        # until the event recorded behind its copy has passed
        self._uploads: collections.deque = collections.deque()

    # -- state maintenance (fixed-shape, in-place scatters) -----------------

    @contextlib.contextmanager
    def issuing(self):
        """Hold :attr:`lock` and issue on the planner's stream (after
        whatever the calling thread's stream has already enqueued)."""
        with self.lock:
            if self._stream is None:
                yield
                return
            cur = torch.cuda.current_stream(self.device)
            if cur != self._stream:
                self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                yield

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def set_table(self, table: ScheduleTable):
        if table.capacity != self.J:
            raise ValueError(f"table capacity {table.capacity} != {self.J}")
        if table.device != self.device:
            raise ValueError(f"table on {table.device}, planner on {self.device}")
        with self.issuing():
            self.table = table

    def update_table_rows(self, rows: np.ndarray, vals) -> None:
        """Scatter schedule-row updates into the table (in place)."""
        with self.issuing():
            self.set_table(update_rows(self.table, rows, vals))

    def set_load(self, loads: np.ndarray) -> None:
        with self.issuing():
            self.load = torch.as_tensor(np.asarray(loads, np.float32),
                                        device=self.device).clone()

    def set_eligibility_rows(self, rows: np.ndarray, values: np.ndarray):
        """``values`` [R, W32] uint32 words (or their int32 bit patterns)."""
        if len(rows):
            v = np.ascontiguousarray(values)
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            with self.issuing():
                self.elig[self._rows(rows)] = torch.as_tensor(
                    v.astype(np.int32, copy=False), device=self.device)

    def set_job_meta(self, rows: np.ndarray, exclusive: np.ndarray,
                     cost: np.ndarray):
        if len(rows):
            with self.issuing():
                r = self._rows(rows)
                self.exclusive[r] = torch.as_tensor(
                    np.asarray(exclusive, bool), device=self.device)
                self.cost[r] = torch.as_tensor(np.asarray(cost, np.float32),
                                               device=self.device)

    def set_node_capacity(self, cols: Sequence[int], caps: Sequence[int]):
        if len(cols):
            with self.issuing():
                self.rem_cap[self._rows(cols)] = torch.as_tensor(
                    np.asarray(caps, np.int32), device=self.device)

    def set_built_state(self, table: ScheduleTable, elig: torch.Tensor,
                        exclusive: torch.Tensor, cost: torch.Tensor) -> None:
        """Install a whole built state (the checkpoint restore path): the
        table, ``elig`` (int32 bit patterns), ``exclusive`` and ``cost``,
        each of the planner's shape and on its device."""
        want = {"elig": (elig, (self.J, self.N // 32), torch.int32),
                "exclusive": (exclusive, (self.J,), torch.bool),
                "cost": (cost, (self.J,), torch.float32)}
        for name, (t, shape, dt) in want.items():
            if tuple(t.shape) != shape or t.dtype != dt \
                    or t.device != self.device:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}, want {shape} {dt} on "
                                 f"{self.device}")
        with self.issuing():
            self.set_table(table)
            self.elig, self.exclusive, self.cost = elig, exclusive, cost

    def built_state(self) -> dict:
        """Host copies of the built state in the JAX planner's dtypes (the
        checkpoint capture): the table columns, ``elig`` as uint32 words,
        ``exclusive`` bool and ``cost`` f32."""
        with self.issuing():
            return dict(table=table_to_numpy(self.table),
                        elig=column_numpy(self.elig, np.uint32),
                        exclusive=column_numpy(self.exclusive, np.bool_),
                        cost=column_numpy(self.cost, np.float32))

    # -- workflow DAG state -------------------------------------------------

    def _vals(self, vals, n: int, dtype) -> torch.Tensor:
        """``vals`` (one value or n) as an [n] tensor on the device."""
        return torch.as_tensor(np.array(np.broadcast_to(
            np.asarray(vals, dtype), (n,))), device=self.device)

    @property
    def dep_enabled(self) -> bool:
        return self._dep_enabled

    def set_dep_enabled(self, flag: bool = True):
        """Arm (or disarm) the dep trigger in the plan step."""
        with self.lock:
            self._dep_enabled = bool(flag)

    def set_dep_epochs(self, rows, succ, fail):
        """Fold completion-round epochs into the per-row vectors: a monotone
        max, so duplicate and repeated deliveries are idempotent."""
        if len(rows):
            with self.issuing():
                r = self._rows(rows)
                self.dep_succ.scatter_reduce_(
                    0, r, self._vals(succ, len(rows), np.int32), "amax")
                self.dep_fail.scatter_reduce_(
                    0, r, self._vals(fail, len(rows), np.int32), "amax")

    def reset_dep_rows(self, rows, last_fire_rel=0):
        """Row (re)initialization: epochs back to NEVER and last_fire to the
        registration anchor, so a fresh dep row only reacts to rounds newer
        than its registration."""
        if len(rows):
            with self.issuing():
                r = self._rows(rows)
                self.dep_succ[r] = NEVER
                self.dep_fail[r] = NEVER
                self.dep_last_fire[r] = self._vals(last_fire_rel, len(rows),
                                                   np.int32)
                self.dep_block[r] = False

    def set_dep_block(self, rows, vals):
        """max_in_flight saturation gate (host-computed per step)."""
        if len(rows):
            with self.issuing():
                self.dep_block[self._rows(rows)] = self._vals(
                    vals, len(rows), np.bool_)

    def dep_state(self) -> dict:
        """Host copies of the mutable dep vectors (checkpoint capture)."""
        with self.issuing():
            return dict(succ=column_numpy(self.dep_succ, np.int32),
                        fail=column_numpy(self.dep_fail, np.int32),
                        last_fire=column_numpy(self.dep_last_fire, np.int32),
                        block=column_numpy(self.dep_block, np.bool_))

    def set_dep_state(self, succ, fail, last_fire, block):
        """Install checkpointed dep vectors whole (restore path)."""
        dev = self.device
        with self.issuing():
            self.dep_succ = column_tensor(succ, np.int32, dev)
            self.dep_fail = column_tensor(fail, np.int32, dev)
            self.dep_last_fire = column_tensor(last_fire, np.int32, dev)
            self.dep_block = column_tensor(block, np.bool_, dev)

    # -- tenant admission state ----------------------------------------------

    @property
    def tenants_enabled(self) -> bool:
        return self._tenants_enabled

    def set_tenants_enabled(self, flag: bool = True):
        """Arm (or disarm) tenant admission in the plan step."""
        with self.lock:
            self._tenants_enabled = bool(flag)

    def set_row_tenants(self, rows, tids):
        """Update the host row->tenant snapshot the admission order derives
        from (recomputed at the next armed dispatch)."""
        if len(rows):
            with self.lock:
                self._tenant_np[np.asarray(rows, np.int64)] = np.asarray(
                    tids, np.int32)
                self._tn_order = None

    def set_tenant_quota(self, tid: int, rate: float, burst: float,
                         weight: float = 1.0):
        """Install or refresh one tenant's bucket.  Tokens reset to a full
        bucket (a fresh or raised quota must not inherit a starved one)."""
        t = int(tid)
        limited = rate > 0
        with self.issuing():
            self.tb_rate[t] = float(np.float32(rate))
            self.tb_burst[t] = float(np.float32(burst))
            self.tb_limited[t] = bool(limited)
            self.tb_weight[t] = float(np.float32(max(weight, 1e-6)))
            self.tb_tokens[t] = float(np.float32(burst if limited else 0.0))

    def clear_tenant_quota(self, tid: int):
        """Quota record deleted: the tenant reverts to unlimited."""
        self.set_tenant_quota(tid, 0.0, 0.0, 1.0)

    def _tenant_order(self) -> TenantOrder:
        if self._tn_order is None:
            self._tn_order = TenantOrder.from_tenants(
                self._tenant_np, self.T, self.device)
        return self._tn_order

    def tenant_state(self) -> dict:
        """Host copy of the tokens (checkpoint capture); rate, burst and
        limited re-derive from the quota records."""
        with self.issuing():
            return dict(tokens=column_numpy(self.tb_tokens, np.float32))

    def set_tenant_state(self, tokens):
        """Install checkpointed tokens whole (restore path)."""
        with self.issuing():
            self.tb_tokens = column_tensor(tokens, np.float32, self.device)

    def job_finished(self, node_col: int, cost: float):
        """Exclusive execution completed: release the capacity slot the
        solve reserved and retire its load."""
        with self.issuing():
            self.rem_cap[node_col] += 1
            self.load[node_col] -= float(cost)

    def common_finished(self, node_col: int, cost: float):
        """Common (fan-out) execution completed: retire load only."""
        with self.issuing():
            self.load[node_col] -= float(cost)

    def _upload(self, *parts: np.ndarray) -> torch.Tensor:
        """``parts`` (int32 arrays, or another dtype's bits viewed as int32)
        end to end in one int32 tensor on the planner's device, without
        waiting for the stream: on the card they are written into a pinned
        buffer, whose copy runs behind the work already issued, and the
        buffer is kept until an event recorded behind the copy has passed.
        The caller holds :meth:`issuing`."""
        on_card = self._stream is not None
        host = torch.empty(sum(len(x) for x in parts), dtype=torch.int32,
                           pin_memory=on_card)
        h, i = host.numpy(), 0
        for x in parts:
            h[i:i + len(x)] = x
            i += len(x)
        if not on_card:
            return host
        out = host.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._uploads.append((done, host))
        while self._uploads and self._uploads[0][0].query():
            self._uploads.popleft()
        return out

    def jobs_finished(self, cols, costs) -> None:
        """Exclusive executions completed, in bulk: for each entry one slot
        back to ``rem_cap[cols[i]]`` and ``costs[i]`` off its load;
        repeated columns add up.  A loop of :meth:`job_finished`, bit for
        bit where the sums of the costs are exact (integer costs).

        The host sums the entries by column (costs in float64, rounded once
        to float32) and uploads the two [N] deltas in one buffer
        (:meth:`_upload`); two element-wise ops apply them.  It issues like
        every setter: after the windows already dispatched, before the
        next."""
        cols = np.asarray(cols, np.int64).ravel()
        if not len(cols):
            return
        if cols.min() < 0 or cols.max() >= self.N:
            raise IndexError(f"jobs_finished: columns must lie in "
                             f"[0, {self.N})")
        w = np.broadcast_to(np.asarray(costs, np.float64), cols.shape)
        slots = np.bincount(cols, minlength=self.N).astype(np.int32)
        load = np.bincount(cols, weights=w, minlength=self.N).astype(
            np.float32)
        with self.lock, span(RELEASE, self.spans.ahead()), self.issuing():
            delta = self._upload(slots, load.view(np.int32))
            self.rem_cap += delta[:self.N]
            self.load -= delta[self.N:].view(torch.float32)

    def commons_finished(self, rows, costs) -> None:
        """Common (fan-out) executions completed, in bulk: each row's cost
        retired from every node it is eligible for now, as one fan-out
        (K2 on the card, the plain fan-out on the CPU) subtracted from the
        load.  A loop of :meth:`common_finished` over each row's eligible
        nodes, bit for bit where the sums are exact (integer costs).

        It assumes the rows' eligibility has not changed since they fired
        (what the fan-out added is what it takes off).  It issues like
        every setter: after the windows already dispatched, before the
        next."""
        rows = np.asarray(rows).ravel()
        if not len(rows):
            return
        if rows.dtype.kind not in "iu":
            raise TypeError(f"commons_finished: rows must be integers, got "
                            f"{rows.dtype}")
        if rows.min() < 0 or rows.max() >= self.J:
            raise IndexError(f"commons_finished: rows must lie in "
                             f"[0, {self.J})")
        w = np.broadcast_to(np.asarray(costs, np.float32), rows.shape)
        K = len(rows)
        with self.lock, span(RELEASE, self.spans.ahead()), self.issuing():
            up = self._upload(rows, w.view(np.int32))
            self.load -= fanout_add(self.elig, up[K:].view(torch.float32),
                                    rows=up[:K])

    def decay_load(self, factor: float = 0.99):
        with self.issuing():
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
        """Enqueue one window and its copy to the host; returns (handle,
        load, rem_cap, last_fire, tokens) — the carried state after the
        window, None for a disarmed arm — without touching the planner's
        state.  The caller holds :meth:`issuing`."""
        fields = window_field_matrix(epoch_s, window_s, self.tz)
        with span(SYNC):            # a pageable copy waits for the stream
            fields_w = torch.from_numpy(fields).to(self.device)
        deps = tenants = None
        if self._dep_enabled:
            deps = _DepArm(self.dep_succ, self.dep_fail, self.dep_block,
                           self.dep_last_fire, fields[:, 6].tolist())
        if self._tenants_enabled:
            tenants = _TenantArm(self._tenant_order(), self.tb_rate,
                                 self.tb_burst, self.tb_limited,
                                 self.tb_weight, self.tb_tokens)
        out, load, rem_cap, last_fire, tokens = _plan_window_step(
            self.table, fields_w, self.elig, self.exclusive, self.cost,
            self.load, self.rem_cap, kx, kc, self.rounds, deps, tenants)
        adt = np.int16 if self.N <= 32767 else np.int32
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = out, None
        nt = self.T if tenants is not None else 0
        return (_WindowHandle(epoch_s, kx, kc, adt, nt, host, ready),
                load, rem_cap, last_fire, tokens)

    def plan_window_async(self, epoch_s: int, window_s: int,
                          sla_bucket: Optional[int] = None):
        """Dispatch one window of ``window_s`` consecutive seconds.

        ``sla_bucket`` pins both buckets: an int pins each to it, a
        (kx, kc) tuple pins them separately.  Handles may be pipelined:
        carried load/capacity chain in dispatch order, which is the order
        dispatches take :attr:`lock` (the scheduler keeps its window
        dispatches on one thread).  State writes from other threads land
        wholly before or wholly after a window; gather may run on any
        thread.

        An overflow-escalation replan (``sla_bucket`` set) re-plans seconds
        whose refill and spend already advanced the buckets, so it never
        writes ``tb_tokens`` back; it does write ``dep_last_fire``."""
        if isinstance(sla_bucket, tuple):
            sla_x, sla_c = sla_bucket
        else:
            sla_x = sla_c = sla_bucket
        with self._bucket_mu:
            kx = self._bx.size(sla_x)
            kc = self._bc.size(sla_c)
        with self.lock:     # it takes over what was recorded ahead of it
            win = self.spans.window(epoch_s, window_s)
        with span("cronsun.plan.dispatch", win), self.issuing():
            handle, self.load, self.rem_cap, last_fire, tokens = \
                self._dispatch(epoch_s, window_s, kx, kc)
            if last_fire is not None:
                self.dep_last_fire = last_fire
            if tokens is not None and sla_bucket is None:
                self.tb_tokens = tokens
        handle.window = win
        return handle

    def gather_window(self, handle: _WindowHandle):
        """Materialize a window dispatch into a list of TickPlans.

        Exclusive placements come first in ``fired``/``assigned``; Common
        fires follow with assigned = -1 (fan-out is the dispatcher's job)."""
        kx, kc = handle.kx, handle.kc
        with span("cronsun.plan.gather", handle.window):
            if handle.ready is not None:
                with span("cronsun.plan.gather.wait"):
                    handle.ready.synchronize()
            o = handle.out.numpy()
            W = o.shape[0]
            a0 = 2 + kx + kc
            a1 = a0 + ((kx + 1) // 2 if handle.adt == np.int16 else kx)
            oa = np.ascontiguousarray(o[:, a0:a1]).view(handle.adt)[:, :kx]
            ot = o[:, a1:].reshape(W, 2, handle.nt) if handle.nt else None
            plans = []
            unplaced = 0
            for w in range(W):
                xt, ct = int(o[w, 0]), int(o[w, 1])
                nx, nc = min(xt, kx), min(ct, kc)
                fired = np.concatenate([o[w, 2:2 + nx],
                                        o[w, 2 + kx:2 + kx + nc]])
                unplaced += int(np.count_nonzero(oa[w, :nx] < 0))
                assigned = np.concatenate(
                    [oa[w, :nx].astype(np.int32), np.full(nc, -1, np.int32)])
                plans.append(TickPlan(
                    epoch_s=handle.epoch_s + w, fired=fired,
                    assigned=assigned,
                    overflow=max(0, xt - kx) + max(0, ct - kc),
                    total_fired=xt + ct, n_excl=nx,
                    tenant_throttled=None if ot is None else ot[w, 0],
                    tenant_shed=None if ot is None else ot[w, 1]))
            if W:
                with self._bucket_mu:
                    self._bx.feed(int(o[:, 0].max()), W)
                    self._bc.feed(int(o[:, 1].max()), W)
            if handle.window is not None:
                handle.window.count(UNPLACED, unplaced)
        return plans

    def plan_window(self, epoch_s: int, window_s: int,
                    sla_bucket: Optional[int] = None):
        return self.gather_window(
            self.plan_window_async(epoch_s, window_s, sla_bucket))

    def warm_window(self, epoch_s: int, window_s: int) -> None:
        """Run one window at the buckets a fresh leader's first plan would
        use WITHOUT mutating carried state (load, capacity, last_fire,
        tokens) or bucket hysteresis: builds the kernels and fills the
        allocator's caches before a takeover."""
        with self._bucket_mu:
            kx, kc = self._bx.peek(), self._bc.peek()
        with self.issuing():
            handle = self._dispatch(epoch_s, window_s, kx, kc)[0]
        if handle.ready is not None:
            handle.ready.synchronize()

    def warm_escalation(self, epoch_s: int, factor: int = 4) -> int:
        """Run the single-second overflow replan at the escalated bucket a
        cron-herd burst will request, without mutating carried state;
        records and returns the warmed bucket size."""
        with self._bucket_mu:
            k = min(_next_pow2(max(self._bx.peek(),
                                   self._bc.peek()) * factor), self.J)
        with self.issuing():
            handle = self._dispatch(epoch_s, 1, k, k)[0]
        if handle.ready is not None:
            handle.ready.synchronize()
        self._warmed_single.add(k)
        return k

    def snap_escalation(self, want: int) -> int:
        """Smallest warmed single-second bucket >= ``want``, else ``want``."""
        cands = [s for s in self._warmed_single if s >= want]
        return min(cands) if cands else want
