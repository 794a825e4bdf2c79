"""Tick+assign over a mesh of torch devices (counterpart of
``cronsun_tpu/parallel/mesh.py``).

A mesh is a grid of shards with named axes: 1-D ``("jobs",)``, where each
shard owns J/D rows of the schedule table and the eligibility matrix, or 2-D
``("jobs", "nodes")``, where the matrix also splits by node columns.  Node
load and capacity are replicated: every shard keeps an identical copy.

One process drives all of its shards.  A tick is the reference's
``shard_map`` body written out: each step runs shard by shard, and the
shards exchange values between steps through :mod:`.collectives`.  Per
tick, each shard: its rows' fire mask -> compact into a local bucket ->
K2 Common fan-out, summed across shards -> ``rounds`` bids (K1 on the 1-D
mesh; K1n per node block on the 2-D mesh, then a cross-block argmin) and a
reconcile round, one of two paths:

- **bucket-sharded bidding** (default, ``shard_bids=True``): each shard
  ranks its own candidates against the replicated load and capacity; the
  shards exchange per-node demand summaries, as a dense [2, N] block or as
  compacted (node, count, cost) triples (``demand_format``), plus the
  accepted (count, cost) block.  O(nodes) per round.
- **replicated waterfill** (``shard_bids=False``): one all_gather of the
  candidate bids and the identical waterfill on every shard.  O(bucket).

Both give the same accepts whenever the cost sums are exact (integer
costs); with fractional costs the carried load may differ in the last ulps,
as in the reference (``cronsun_tpu/parallel/mesh.py:22-27``).

A multi-host mesh spans processes (``--mesh-hosts``): process p owns global
shards p*L .. p*L+L-1 of the reference's device order
(``devices[:dj*dn].reshape(dj, dn)``), its collectives run over gloo, and
:mod:`.hostsync` keeps every process's planner state identical.

On the card the shards may share a device (several on ``cuda:0``): each
shard still holds its own tensors and launches its own kernels.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.assign import (_local_bid_demand, choose_impl, compact_demand,
                          local_bid_demand, node_sums, scatter_demand,
                          waterfill_accept, waterfill_accept_presplit)
from ..ops.kernels import bid_argmin, bid_argmin_natural, fanout_add
from ..ops.planner import TickPlan, _compact, _next_pow2
from ..ops.schedule_table import (DTYPES, ScheduleTable, build_table,
                                  column_numpy, column_tensor, table_to_numpy,
                                  update_rows)
from ..ops.tick import _fire_mask, window_field_matrix
from .collectives import Collectives

AXIS = "jobs"
NAXIS = "nodes"

# node width at which the 2-D mesh's Common fan-out psum shards by node
# blocks (each shard reduces only its [N/Dn] block; one gather assembles)
# instead of psumming the full [N]
NODE_BLOCK_PSUM_MIN_N = 65536

_INF = float("inf")


class Mesh:
    """A grid of torch devices with named axes: ``("jobs",)`` for a 1-D
    list, ``("jobs", "nodes")`` for a 2-D one.  Several shards may name the
    same device.  ``process_count`` > 1 makes it a multi-host mesh of which
    this process (``process_index``) owns the shards ``local``."""

    def __init__(self, devices, axis_names: Optional[Sequence[str]] = None,
                 process_count: int = 1, process_index: int = 0):
        grid = np.array(devices, dtype=object)
        if grid.ndim not in (1, 2) or grid.size == 0:
            raise ValueError("a mesh is a non-empty 1-D or 2-D device grid")
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(grid.flat):
            self.devices.flat[i] = torch.device(d)
        self.axis_names = tuple(axis_names or (AXIS, NAXIS)[:grid.ndim])
        if len(self.axis_names) != grid.ndim:
            raise ValueError(f"axis names {self.axis_names} for a "
                             f"{grid.ndim}-D grid")
        self.shape = dict(zip(self.axis_names, grid.shape))
        if process_count < 1 or grid.size % process_count \
                or not 0 <= process_index < process_count:
            raise ValueError(f"{grid.size} shards over {process_count} "
                             f"processes (index {process_index})")
        self.process_count = process_count
        self.process_index = process_index
        n_local = grid.size // process_count
        self.local = list(range(process_index * n_local,
                                (process_index + 1) * n_local))

    def coords(self, g: int) -> tuple:
        """Grid coordinates of global shard ``g`` (row-major)."""
        return tuple(int(c) for c in np.unravel_index(g, self.devices.shape))

    def group(self, g: int, axis: str) -> List[int]:
        """The global shards along ``axis`` through shard ``g``, in order."""
        a = self.axis_names.index(axis)
        c = list(self.coords(g))
        out = []
        for i in range(self.devices.shape[a]):
            c[a] = i
            out.append(int(np.ravel_multi_index(c, self.devices.shape)))
        return out


def _local_devices(n_global: int, device: DeviceLike):
    """(this process's shard devices, process count, process index): the
    global shards divide over the ``torch.distributed`` processes when a
    group is initialized; on the card a process takes ``cuda:0 ..
    L-1``."""
    dev = resolve_device(device)
    world, rank = 1, 0
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    if n_global % world:
        raise ValueError(f"{n_global} devices do not divide over {world} "
                         f"processes")
    n_local = n_global // world
    if dev.type == "cpu":
        return [dev] * n_local, world, rank
    have = torch.cuda.device_count()
    if n_local > have:
        raise ValueError(f"need {n_local} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_local)], world, rank


def make_mesh(n_devices: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """1-D jobs mesh over ``cuda:0 .. n-1`` (every card when ``n_devices``
    is None), or ``n_devices`` shards on the CPU with ``device="cpu"``."""
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            n_devices *= dist.get_world_size()
    local, world, rank = _local_devices(n_devices, dev)
    return Mesh(local * world, (AXIS,), world, rank)


def make_mesh2d(dj: int, dn: int, device: DeviceLike = None) -> Mesh:
    """2-D (jobs x nodes) mesh: shards the [J, N] eligibility matrix both
    ways, for fleets whose bit-packed matrix exceeds one device even after
    jobs-sharding."""
    local, world, rank = _local_devices(dj * dn, device)
    return Mesh(np.array(local * world, dtype=object).reshape(dj, dn),
                (AXIS, NAXIS), world, rank)


# ------------------------------------------------------------------ the tick

def _shard_sum(stack: torch.Tensor) -> torch.Tensor:
    """Sum of ``stack`` [D, ...] along dim 0, one add at a time in shard
    order."""
    acc = stack[0]
    for i in range(1, stack.shape[0]):
        acc = acc + stack[i]
    return acc


def _reconcile_sharded(cx, cand, choice, cost, load, rem_cap, is_final,
                       axis, compact_k=None):
    """One bucket-sharded accept round (``cronsun_tpu/parallel/mesh.py:
    86-156``): the shards exchange per-node demand summaries instead of the
    candidate bids.

    1. local: rank and exclusive cumulative cost among same-node
       candidates of each shard, and its [2, N] (count, cost-sum) demand;
    2. exchange the demand along ``axis`` -> [D, 2, N] (dense all_gather,
       or ``compact_k`` triples gathered and scattered back); the
       earlier-shards prefix lifts local rank and cum-cost to global;
    3. the replicated waterfill's accept predicate, evaluated locally;
    4. exchange the accepted (count, cost) block (psum dense, gather + sum
       compacted) so load and rem_cap stay replicated.
    Returns (accept per shard, load, rem_cap)."""
    n_padded = load[0].shape[0]
    loc = [_local_bid_demand(c, ch, co, n_padded)
           for c, ch, co in zip(cand, choice, cost)]
    if compact_k is None:
        demand_g = cx.all_gather([d for _, _, d, _ in loc], axis)
    else:
        comp = [compact_demand(d, compact_k) for _, _, d, _ in loc]
        demand_g = [scatter_demand(g, n_padded)
                    for g in cx.all_gather([c for c, _ in comp], axis)]
    accept, acc = [], []
    for s, (rank_l, cum_l, _, sort) in enumerate(loc):
        g = demand_g[s]
        d = cx.axis_index(s, axis)
        prefix = (_shard_sum(g[:d]) if d else
                  torch.zeros_like(g[0]))
        tot_w = g[:, 1, :].sum(dtype=torch.float64)
        safe = choice[s].to(torch.int64).clamp(0, n_padded - 1)
        rank_g = prefix[0][safe].to(torch.int32) + rank_l
        cum_g = prefix[1][safe] + cum_l
        a = waterfill_accept_presplit(cand[s], choice[s], cost[s], load[s],
                                      rem_cap[s], is_final, rank_g, cum_g,
                                      tot_w)
        accept.append(a)
        acc.append(node_sums(sort, n_padded, a,
                             torch.where(a, cost[s], 0.0)))
    if compact_k is None:
        upd = cx.psum(acc, axis)
    else:
        # accepted nodes are candidate nodes, so the demand compaction's
        # node list covers them
        acc_comp = [torch.stack([c[0], a[0][i], a[1][i]])
                    for (c, i), a in zip(comp, acc)]
        upd = [_shard_sum(scatter_demand(g, n_padded))
               for g in cx.all_gather(acc_comp, axis)]
    load = [l + u[1] for l, u in zip(load, upd)]
    rem_cap = [r - u[0].to(torch.int32) for r, u in zip(rem_cap, upd)]
    return accept, load, rem_cap


def _reconcile_replicated(cx, cand, choice, cost, load, rem_cap, is_final,
                          axis):
    """One replicated accept round: gather the candidate bids along
    ``axis`` and run the identical waterfill on every shard; each keeps
    its slice of the verdicts."""
    k = cand[0].shape[0]
    cand_g = cx.all_gather(cand, axis)
    choice_g = cx.all_gather(choice, axis)
    cost_g = cx.all_gather(cost, axis)
    accept, load_o, cap_o = [], [], []
    for s in range(len(cand)):
        a, l, c = waterfill_accept(cand_g[s].reshape(-1),
                                   choice_g[s].reshape(-1),
                                   cost_g[s].reshape(-1), load[s],
                                   rem_cap[s], is_final)
        d = cx.axis_index(s, axis)
        accept.append(a[d * k:(d + 1) * k])
        load_o.append(l)
        cap_o.append(c)
    return accept, load_o, cap_o


def _reconcile(cx, cand, choice, cost, load, rem_cap, is_final, shard_bids,
               compact_k):
    if shard_bids:
        return _reconcile_sharded(cx, cand, choice, cost, load, rem_cap,
                                  is_final, AXIS, compact_k)
    return _reconcile_replicated(cx, cand, choice, cost, load, rem_cap,
                                 is_final, AXIS)


def _bucket(shards, fire, k_local):
    """Per shard: the compacted bucket (idx, valid, total) and its rows'
    exclusive flags and f32 costs."""
    out = []
    for sh, f in zip(shards, fire):
        idx, valid, total = _compact(f, k_local)
        out.append((idx, valid, total, sh.exclusive[idx],
                    sh.cost[idx].to(torch.float32)))
    return out


def _outputs(cx, bucket, assigned, j_local):
    """Per shard [3, k_local] int32: global row indices (-1 past the fire
    count), the fire count in [1, 0], and each row's node or -1."""
    out = []
    for s, ((idx, _, total, _, _), a) in enumerate(zip(bucket, assigned)):
        d = cx.axis_index(s, AXIS)
        k = idx.shape[0]
        pos = torch.arange(k, device=idx.device)
        idx_global = torch.where(pos < total, d * j_local + idx,
                                 -1).to(torch.int32)
        total_row = torch.zeros_like(idx)
        total_row[0] = total
        out.append(torch.stack([idx_global, total_row, a]))
    return out


def _tick_local(cx, fire, shards, load, rem_cap, k_local: int, rounds: int,
                shard_bids: bool = False, compact_k=None):
    """One second of the jobs-mesh plan (``cronsun_tpu/parallel/mesh.py:
    180-226``): local compact and bid, then the per-round reconcile —
    bucket-sharded (dense or compacted demand per ``compact_k``) or the
    replicated waterfill.  THE single definition: ``plan`` and
    ``plan_window`` both run it.  The bid is K1 over the shard's table with
    the bucket's rows (the tie hash on the local bucket position)."""
    j_local = shards[0].elig.shape[0]
    bucket = _bucket(shards, fire, k_local)
    # Common fan-out: local partial load, summed across shards
    part = [fanout_add(sh.elig, torch.where(v & ~x, c, 0.0), rows=i)
            for sh, (i, v, _, x, c) in zip(shards, bucket)]
    load = [l + t for l, t in zip(load, cx.psum(part, AXIS))]
    need0 = [v & x for _, v, _, x, _ in bucket]
    cost = [c for *_, c in bucket]
    assigned = [torch.full_like(i, -1) for i, *_ in bucket]
    for r in range(rounds):
        active = [n & (a < 0) for n, a in zip(need0, assigned)]
        bids = [bid_argmin(sh.elig, torch.where(rc > 0, l, _INF),
                           rows=b[0], active=act)
                for sh, b, l, rc, act in zip(shards, bucket, load, rem_cap,
                                             active)]
        choice = [c for _, c in bids]
        cand = [act & torch.isfinite(b) for act, (b, _) in zip(active, bids)]
        accept, load, rem_cap = _reconcile(
            cx, cand, choice, cost, load, rem_cap, r == rounds - 1,
            shard_bids, compact_k)
        assigned = [torch.where(a, c, asg)
                    for a, c, asg in zip(accept, choice, assigned)]
    return _outputs(cx, bucket, assigned, j_local), load, rem_cap


def _tick2d_local(cx, fire, shards, load, rem_cap, k_local: int, rounds: int,
                  shard_bids: bool = False, compact_k=None,
                  node_block_fanout: bool = False):
    """One second of the (jobs x nodes) mesh plan (``cronsun_tpu/parallel/
    mesh.py:265-365``), per shard — THE single definition shared by
    ``plan`` and ``plan_window``.

    Collectives per tick: the Common fan-out block's gather along nodes and
    sum along jobs (in either order: ``node_block_fanout`` sums only this
    shard's [N/Dn] block first), and per bid round one (best, choice)
    exchange along nodes plus the reconcile along jobs.

    Tie order: each block's bid is K1n, which hashes global node ids and
    breaks exact ties to the lowest one; the cross-block argmin takes the
    least score, then the lowest global id — so placements do not depend on
    how the columns are split."""
    j_local = shards[0].elig.shape[0]
    n_local = shards[0].elig.shape[1] * 32
    col0 = [cx.axis_index(s, NAXIS) * n_local for s in range(len(shards))]
    bucket = _bucket(shards, fire, k_local)
    block = [fanout_add(sh.elig, torch.where(v & ~x, c, 0.0), rows=i)
             for sh, (i, v, _, x, c) in zip(shards, bucket)]
    if node_block_fanout:
        blk = cx.psum(block, AXIS)
        full = [g.reshape(-1) for g in cx.all_gather(blk, NAXIS)]
    else:
        full = cx.psum([g.reshape(-1) for g in cx.all_gather(block, NAXIS)],
                       AXIS)
    load = [l + f for l, f in zip(load, full)]
    need0 = [v & x for _, v, _, x, _ in bucket]
    cost = [c for *_, c in bucket]
    assigned = [torch.full_like(i, -1) for i, *_ in bucket]
    for r in range(rounds):
        active = [n & (a < 0) for n, a in zip(need0, assigned)]
        best_l, choice_l = [], []
        for sh, b, l, rc, act, c0 in zip(shards, bucket, load, rem_cap,
                                         active, col0):
            load_blk = torch.where(rc > 0, l, _INF)[c0:c0 + n_local]
            bb, cc = bid_argmin_natural(sh.elig, load_blk, c0, rows=b[0],
                                        active=act)
            best_l.append(bb)
            choice_l.append(torch.where(torch.isfinite(bb), cc, 0))
        # argmin across the node blocks: least score, ties to the lowest
        # global node id
        bests = cx.all_gather(best_l, NAXIS)
        choices = cx.all_gather(choice_l, NAXIS)
        choice, cand = [], []
        for bs, cs, act in zip(bests, choices, active):
            best = bs.min(dim=0).values
            is_min = (bs == best[None, :]) & torch.isfinite(bs)
            ch = torch.where(is_min, cs, 1 << 30).min(dim=0).values
            fin = torch.isfinite(best)
            choice.append(torch.where(fin, ch, 0))
            cand.append(act & fin)
        accept, load, rem_cap = _reconcile(
            cx, cand, choice, cost, load, rem_cap, r == rounds - 1,
            shard_bids, compact_k)
        assigned = [torch.where(a, c, asg)
                    for a, c, asg in zip(accept, choice, assigned)]
    return _outputs(cx, bucket, assigned, j_local), load, rem_cap


# ---------------------------------------------------------------- planners

class _Shard:
    """One shard's state on its device: its rows of the table, its block of
    the eligibility matrix, its rows' exclusive flags and costs, and its
    copy of the replicated load and capacity."""

    def __init__(self, g: int, dj: int, dn: int, device: torch.device,
                 j_local: int, w_local: int, n: int):
        self.g, self.dj, self.dn, self.device = g, dj, dn, device
        self.table: ScheduleTable = build_table([], capacity=j_local,
                                                device=device)
        self.elig = torch.zeros((j_local, w_local), dtype=torch.int32,
                                device=device)
        self.exclusive = torch.zeros(j_local, dtype=torch.bool, device=device)
        self.cost = torch.ones(j_local, dtype=torch.float32, device=device)
        self.load = torch.zeros(n, dtype=torch.float32, device=device)
        self.rem_cap = torch.zeros(n, dtype=torch.int32, device=device)


def _last_writes(rows) -> "tuple[np.ndarray, np.ndarray]":
    """(distinct rows ascending, the position of each one's LAST occurrence
    in ``rows``): a scatter batch with duplicate rows keeps its last
    write."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    uniq, rev_first = np.unique(rows[::-1], return_index=True)
    return uniq, len(rows) - 1 - rev_first


def _on(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device)


class _ShardedPlannerBase:
    """State surface + plan decode shared by the mesh planners.  A
    subclass sets ``Dj`` (the jobs-axis size the bucket divides over),
    ``Dn`` (1 on the 1-D mesh), a node ``word_align`` and :meth:`_tick`."""

    Dn = 1

    def _init_common(self, mesh: Mesh, job_capacity: int,
                     node_capacity: int, rounds: int, max_fire_bucket: int,
                     tz, word_align: int, shard_bids: bool = True,
                     demand_format: str = "auto", node_block_psum=None):
        self.mesh = mesh
        self.tz = tz or datetime.timezone.utc
        self.rounds = rounds
        # bucket-sharded bidding (O(nodes) demand exchange per round) is
        # the default; False keeps the replicated waterfill over the
        # gathered candidate bucket (O(fired x k)) as the reference /
        # rollback path
        self.shard_bids = shard_bids
        # demand wire format of the sharded reconcile: "dense" [2, N]
        # blocks, "compacted" (idx, count, cost) triples, or "auto" (per
        # plan, by the estimate_collective_bytes crossover at the bucket)
        if demand_format not in ("auto", "dense", "compacted"):
            raise ValueError(f"demand_format {demand_format!r} not in "
                             "auto/dense/compacted")
        self.demand_format = demand_format
        self.J = _next_pow2(max(job_capacity, self.Dj * 256))
        if self.J % self.Dj:
            raise ValueError("job capacity must shard evenly")
        self.N = ((node_capacity + word_align - 1)
                  // word_align) * word_align
        if node_block_psum is None:
            node_block_psum = (self.Dn > 1
                               and self.N >= NODE_BLOCK_PSUM_MIN_N)
        self.node_block_psum = bool(node_block_psum) and self.Dn > 1
        self.max_fire_bucket = max_fire_bucket
        self.j_local = self.J // self.Dj
        self.w_local = self.N // 32 // self.Dn
        self._shards = []
        for g in mesh.local:
            dj, dn = divmod(g, self.Dn)
            self._shards.append(_Shard(g, dj, dn, mesh.devices.flat[g],
                                       self.j_local, self.w_local, self.N))
        self.device = self._shards[0].device
        self.impl = choose_impl(self.device)
        self.lock = threading.RLock()
        self.cx = Collectives(mesh)
        # a multi-host mesh: other processes hold the other shards
        self._multiprocess = mesh.process_count > 1
        # mesh tick observability, surfaced by stats_snapshot() and
        # rendered at /v1/metrics as cronsun_mesh_tick_*
        from ..metrics import LatencyRing
        self.tick_ms = LatencyRing()
        self._ticks_total = 0
        self._collective_bytes_total = 0
        self._compacted_bytes_total = 0
        self._compacted_ticks_total = 0
        self._last_k_local = 0
        self._last_demand_format = ("dense" if not self.shard_bids
                                    else self.demand_format)
        self._measured_per_tick: Optional[int] = None
        self._phase_profile: dict = {}

    def _fetch(self, xs: Sequence[torch.Tensor]) -> np.ndarray:
        """The plan outputs of the jobs shards (node column 0), concatenated
        along the bucket axis: one value per local shard in, a host array
        out; on a multi-host mesh every process's outputs come over the
        wire (the reference's ``process_allgather``)."""
        vals = self.cx.everyone(xs)
        return np.concatenate(
            [vals[dj * self.Dn].cpu().numpy() for dj in range(self.Dj)],
            axis=-1)

    # -- state maintenance -------------------------------------------------

    def _owned(self, rows):
        """Per local shard: (its local rows, positions into the caller's
        batch) of a batch of global rows, duplicates resolved to the last
        write."""
        uniq, pos = _last_writes(rows)
        if len(uniq) and (uniq[0] < 0 or uniq[-1] >= self.J):
            raise IndexError(f"rows must lie in [0, {self.J})")
        owner = uniq // self.j_local
        for sh in self._shards:
            m = owner == sh.dj
            if m.any():
                yield sh, uniq[m] - sh.dj * self.j_local, pos[m]

    def _cols(self, sh) -> slice:
        return slice(sh.dn * self.w_local, (sh.dn + 1) * self.w_local)

    def _rows(self, sh) -> slice:
        return slice(sh.dj * self.j_local, (sh.dj + 1) * self.j_local)

    def set_table(self, table: ScheduleTable):
        if table.capacity != self.J:
            raise ValueError(f"table capacity {table.capacity} != {self.J}")
        with self.lock:
            for sh in self._shards:
                r = self._rows(sh)
                sh.table = ScheduleTable(**{
                    k: getattr(table, k)[r].to(sh.device, copy=True)
                    for k in DTYPES})

    def update_table_rows(self, rows: np.ndarray, vals) -> None:
        """Scatter schedule-row updates into the owning shards' tables."""
        with self.lock:
            for sh, local, pos in self._owned(rows):
                update_rows(sh.table, local, [vals[i] for i in pos])

    def set_load(self, loads: np.ndarray) -> None:
        self.load = loads

    def set_eligibility(self, matrix: np.ndarray):
        """The whole [J, N/32] matrix (uint32 words or their int32 bit
        patterns)."""
        m = np.asarray(matrix)
        if m.shape != (self.J, self.N // 32):
            raise ValueError(f"eligibility {m.shape} != "
                             f"{(self.J, self.N // 32)}")
        with self.lock:
            for sh in self._shards:
                sh.elig = column_tensor(m[self._rows(sh), self._cols(sh)],
                                        np.uint32, sh.device)

    def set_job_meta_full(self, exclusive: np.ndarray, cost: np.ndarray):
        with self.lock:
            for sh in self._shards:
                r = self._rows(sh)
                sh.exclusive = column_tensor(np.asarray(exclusive)[r],
                                             np.bool_, sh.device)
                sh.cost = column_tensor(np.asarray(cost)[r], np.float32,
                                        sh.device)

    def set_node_capacity_full(self, caps: np.ndarray):
        self.rem_cap = np.asarray(caps).astype(np.int32)

    # row-wise incremental setters (the SchedulerService's watch->delta
    # surface, the same contract as ops.planner.TickPlanner)

    def set_eligibility_rows(self, rows: np.ndarray, values: np.ndarray):
        if not len(rows):
            return
        v = np.asarray(values)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        with self.lock:
            for sh, local, pos in self._owned(rows):
                sh.elig[_on(local, sh.device)] = _on(
                    v[pos][:, self._cols(sh)].astype(np.int32, copy=False),
                    sh.device)

    def set_job_meta(self, rows: np.ndarray, exclusive: np.ndarray,
                     cost: np.ndarray):
        if not len(rows):
            return
        ex = np.asarray(exclusive, bool).reshape(-1)
        co = np.asarray(cost, np.float32).reshape(-1)
        with self.lock:
            for sh, local, pos in self._owned(rows):
                r = _on(local, sh.device)
                sh.exclusive[r] = _on(ex[pos], sh.device)
                sh.cost[r] = _on(co[pos], sh.device)

    def set_node_capacity(self, cols, caps):
        if not len(cols):
            return
        cols, pos = _last_writes(cols)
        caps = np.asarray(caps, np.int64).reshape(-1)[pos].astype(np.int32)
        with self.lock:
            for sh in self._shards:
                sh.rem_cap[_on(cols, sh.device)] = _on(caps, sh.device)

    # load and rem_cap are replicated: each shard holds a copy, and a write
    # goes to every one

    @property
    def load(self) -> torch.Tensor:
        return self._shards[0].load

    @load.setter
    def load(self, v):
        v = torch.as_tensor(np.asarray(v, np.float32) if not isinstance(
            v, torch.Tensor) else v).to(torch.float32)
        if tuple(v.shape) != (self.N,):
            raise ValueError(f"load {tuple(v.shape)} != ({self.N},)")
        with self.lock:
            for sh in self._shards:
                sh.load = v.to(sh.device, copy=True)

    @property
    def rem_cap(self) -> torch.Tensor:
        return self._shards[0].rem_cap

    @rem_cap.setter
    def rem_cap(self, v):
        v = torch.as_tensor(np.asarray(v, np.int32) if not isinstance(
            v, torch.Tensor) else v).to(torch.int32)
        if tuple(v.shape) != (self.N,):
            raise ValueError(f"rem_cap {tuple(v.shape)} != ({self.N},)")
        with self.lock:
            for sh in self._shards:
                sh.rem_cap = v.to(sh.device, copy=True)

    def job_finished(self, node_col: int, cost: float):
        with self.lock:
            for sh in self._shards:
                sh.rem_cap[node_col] += 1
                sh.load[node_col] -= float(cost)

    def common_finished(self, node_col: int, cost: float):
        with self.lock:
            for sh in self._shards:
                sh.load[node_col] -= float(cost)

    def decay_load(self, factor: float = 0.99):
        with self.lock:
            for sh in self._shards:
                sh.load = sh.load * factor

    def built_state(self) -> dict:
        """Host copies of the whole built state in the JAX planner's dtypes
        (the checkpoint capture): the table columns, ``elig`` as uint32
        words, ``exclusive`` bool and ``cost`` f32, assembled from the
        shards.  Single-process meshes only (the service refuses
        checkpoints of multi-host ones)."""
        if self._multiprocess:
            raise RuntimeError("built_state of a multi-host mesh: other "
                               "processes hold its shards")
        with self.lock:
            rows = [sh for sh in self._shards if sh.dn == 0]
            tables = [table_to_numpy(sh.table) for sh in rows]
            elig = np.zeros((self.J, self.N // 32), np.uint32)
            for sh in self._shards:
                elig[self._rows(sh), self._cols(sh)] = column_numpy(
                    sh.elig, np.uint32)
            return dict(
                table={k: np.concatenate([t[k] for t in tables])
                       for k in DTYPES},
                elig=elig,
                exclusive=np.concatenate(
                    [column_numpy(sh.exclusive, np.bool_) for sh in rows]),
                cost=np.concatenate(
                    [column_numpy(sh.cost, np.float32) for sh in rows]))

    def set_built_state(self, table: ScheduleTable, elig: torch.Tensor,
                        exclusive: torch.Tensor, cost: torch.Tensor) -> None:
        """Install a whole built state (the checkpoint restore path): the
        table, ``elig`` (int32 bit patterns), ``exclusive`` and ``cost`` of
        the planner's global shapes, on any device; each shard takes its
        part."""
        want = {"elig": (elig, (self.J, self.N // 32), torch.int32),
                "exclusive": (exclusive, (self.J,), torch.bool),
                "cost": (cost, (self.J,), torch.float32)}
        for name, (t, shape, dt) in want.items():
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                                 f"{shape} {dt}")
        with self.lock:
            self.set_table(table)
            self.set_eligibility(elig.cpu().numpy())
            self.set_job_meta_full(exclusive.cpu().numpy(),
                                   cost.cpu().numpy())

    # -- tick --------------------------------------------------------------

    def _k_local(self, sla_bucket: Optional[int]) -> int:
        k = sla_bucket or self.max_fire_bucket
        return max(256, _next_pow2(k) // self.Dj)

    def _resolve_demand_format(self, k_local: int) -> str:
        """Static per-plan pick of the demand wire format: "auto" compares
        the compacted and dense branches of the byte model at this bucket;
        an explicit pin wins; the replicated path has no demand exchange
        to format."""
        return self.estimate_collective_bytes(
            k_local=k_local)["demand_format"]

    def _compact_k(self, k_local: int, fmt: str):
        # a shard's demand touches at most min(#candidates, N) distinct
        # nodes, so this pad never truncates (see ops.assign.compact_demand)
        return min(k_local, self.N) if fmt == "compacted" else None

    def _decode(self, o, epoch_s: int, k_local: int) -> TickPlan:
        """[3, Dj*k_local] per-shard-concatenated output -> TickPlan."""
        fired, assigned, total = [], [], 0
        for s in range(self.Dj):
            t_s = int(o[1, s * k_local])
            total += t_s
            n_s = min(t_s, k_local)
            fired.append(o[0, s * k_local:s * k_local + n_s])
            assigned.append(o[2, s * k_local:s * k_local + n_s])
        fired = np.concatenate(fired)
        assigned = np.concatenate(assigned)
        return TickPlan(epoch_s=epoch_s, fired=fired, assigned=assigned,
                        overflow=max(0, total - len(fired)),
                        total_fired=total)

    def _plan(self, epoch_s: int, window_s: int,
              sla_bucket: Optional[int]) -> List[TickPlan]:
        """W seconds, each one :meth:`_tick`; the fire mask of every shard's
        rows for the whole window is one pass before the loop."""
        k_local = self._k_local(sla_bucket)
        fmt = self._resolve_demand_format(k_local)
        compact_k = self._compact_k(k_local, fmt)
        fields = window_field_matrix(epoch_s, window_s, self.tz)
        with self.lock:
            t0 = time.perf_counter()
            moved0 = self.cx.moved
            fire_w = []
            for sh in self._shards:
                f = torch.from_numpy(fields).to(sh.device)
                fire_w.append(
                    _fire_mask(sh.table, *f.unbind(1)).T.contiguous())
            load = [sh.load for sh in self._shards]
            rem_cap = [sh.rem_cap for sh in self._shards]
            outs: List[list] = [[] for _ in self._shards]
            for w in range(window_s):
                out, load, rem_cap = self._tick(
                    [fw[w] for fw in fire_w], load, rem_cap, k_local,
                    compact_k)
                for o, x in zip(outs, out):
                    o.append(x)
            for sh, l, c in zip(self._shards, load, rem_cap):
                sh.load, sh.rem_cap = l, c
            moved = self.cx.moved - moved0
            o = self._fetch([torch.stack(x) for x in outs])  # [W, 3, Dj*k]
            ms = (time.perf_counter() - t0) * 1e3
        self._account_ticks(window_s, ms, k_local, fmt, moved)
        return [self._decode(o[w], epoch_s + w, k_local)
                for w in range(window_s)]

    def plan(self, epoch_s: int, sla_bucket: Optional[int] = None) -> TickPlan:
        """Fire + place every job due at ``epoch_s`` (one-second tick)."""
        return self._plan(epoch_s, 1, sla_bucket)[0]

    def plan_window(self, epoch_s: int, window_s: int, sla_bucket=None):
        """W consecutive seconds, the same semantics as W ticks."""
        return self._plan(epoch_s, window_s, sla_bucket)

    # -- observability -----------------------------------------------------

    def _account_ticks(self, n_ticks: int, total_ms: float, k_local: int,
                       fmt: str = "dense", moved: Optional[int] = None):
        # ONE ring sample per plan call (the window-averaged per-tick ms):
        # repeating it per tick would let a single long window evict every
        # real sample and flatten p99 onto p50
        self.tick_ms.add(total_ms / max(1, n_ticks))
        self._ticks_total += n_ticks
        self._last_k_local = k_local
        self._last_demand_format = fmt
        if moved is not None:
            self._measured_per_tick = moved // max(1, n_ticks)
        est = self.estimate_collective_bytes(k_local=k_local,
                                             demand_format=fmt)
        self._collective_bytes_total += n_ticks * est["per_tick"]
        if fmt == "compacted":
            self._compacted_ticks_total += n_ticks
            self._compacted_bytes_total += (
                n_ticks * self.rounds * est["compacted_per_round"])

    def estimate_collective_bytes(self, sla_bucket: Optional[int] = None,
                                  k_local: Optional[int] = None,
                                  demand_format: Optional[str] = None,
                                  ) -> dict:
        """Analytic per-tick inter-shard payload model at the planner's
        shapes (a copy of the reference's, ``cronsun_tpu/parallel/mesh.py:
        701-766``).  ONE convention for every collective: the full
        GATHERED output size for an all_gather, the logical payload once
        for a psum:

        - replicated round: candidate triple all_gather — (1+4+4) B x
          Dj*k_local gathered — linear in the fired bucket;
        - sharded round: [2, N] f32 demand all_gather (8N x Dj) + [2, N]
          f32 accepted psum (8N): 8N*(Dj+1), independent of the bucket;
        - compacted round: two [3, k_comp] f32 all_gathers, k_comp =
          min(k_local, N): 24*k_comp*Dj per round, proportional to demand;
        - 2-D meshes add the node-axis (best, choice) reduce — 8 B x
          Dn*k_local gathered per round — and the [N] Common fan-out
          gather; with node-block psum the fan-out reduces only this
          shard's [N/Dn] block (4N/Dn) before the [N] assembly gather.
        """
        if k_local is None:
            k_local = self._k_local(sla_bucket)
        N = self.N
        dn = self.Dn
        k_comp = min(k_local, N)
        repl_round = 9 * self.Dj * k_local
        shard_round = 2 * N * 4 * (self.Dj + 1)
        comp_round = 2 * 3 * 4 * k_comp * self.Dj
        if dn > 1:                       # fanout psum + 2-D assembly gather
            common = (4 * N // dn if self.node_block_psum else 4 * N) + 4 * N
        else:
            common = 4 * N
        naxis_round = 8 * dn * k_local if dn > 1 else 0
        fmt = demand_format
        if fmt is None:
            fmt = self.demand_format if self.shard_bids else "dense"
        if fmt == "auto":
            fmt = "compacted" if comp_round < shard_round else "dense"
        mine = (repl_round if not self.shard_bids
                else comp_round if fmt == "compacted" else shard_round)
        return {
            "replicated_per_round": repl_round + naxis_round,
            "sharded_per_round": shard_round + naxis_round,
            "compacted_per_round": comp_round + naxis_round,
            "per_round": mine + naxis_round,
            "per_tick": self.rounds * (mine + naxis_round) + common,
            "k_local": k_local,
            "demand_format": fmt if self.shard_bids else "dense",
        }

    def measured_collective_bytes(self) -> Optional[int]:
        """Per-tick bytes the collectives moved in the last plan, under
        :meth:`estimate_collective_bytes`' convention (the reference reads
        them from the compiled HLO); None before the first plan."""
        return self._measured_per_tick

    def profile_phases(self, sla_bucket: Optional[int] = None,
                       iters: int = 10) -> dict:
        """Per-phase microbench at the planner's CURRENT shapes: one bid
        sweep (K1, or K1n on the 2-D mesh), one round's collective exchange
        and one round's reconcile math, each the least time of ``iters``
        runs (CUDA events on the card, ``perf_counter`` on the CPU).
        Returns {bid_ms, gather_ms, reconcile_ms} and keeps it for
        stats_snapshot()."""
        k_local = self._k_local(sla_bucket)
        dev = self.device
        w32 = self.w_local
        g = torch.Generator().manual_seed(0)
        packed = torch.randint(-2**31, 2**31, (k_local, w32), generator=g,
                               dtype=torch.int32).to(dev)
        load = torch.rand(w32 * 32, generator=g).to(dev)
        loadN = torch.rand(self.N, generator=g).to(dev)
        cap = torch.full((self.N,), 4, dtype=torch.int32, device=dev)
        cand = (torch.rand(k_local, generator=g) < 0.5).to(dev)
        choice = torch.randint(0, self.N, (k_local,), generator=g,
                               dtype=torch.int32).to(dev)
        cost = torch.ones(k_local, device=dev)
        if self.Dn > 1:
            def bid():
                return bid_argmin_natural(packed, load, 0)
        else:
            def bid():
                return bid_argmin(packed, load)
        cx = Collectives(self.mesh)
        if self.shard_bids:
            fmt = self._resolve_demand_format(k_local)
            if fmt == "compacted":
                c3 = [torch.zeros((3, min(k_local, self.N)), device=sh.device)
                      for sh in self._shards]

                def gather():
                    return cx.all_gather(c3, AXIS), cx.all_gather(c3, AXIS)
            else:
                d2 = [torch.zeros((2, self.N), device=sh.device)
                      for sh in self._shards]

                def gather():
                    return cx.all_gather(d2, AXIS), cx.psum(d2, AXIS)

            def reconcile():
                rank, cum, demand = local_bid_demand(cand, choice, cost,
                                                     self.N)
                return waterfill_accept_presplit(
                    cand, choice, cost, loadN, cap, False, rank, cum,
                    demand[1].sum(dtype=torch.float64))
        else:
            vals = [[torch.zeros(k_local, dtype=dt, device=sh.device)
                     for sh in self._shards]
                    for dt in (torch.bool, torch.int32, torch.float32)]

            def gather():
                return [cx.all_gather(v, AXIS) for v in vals]
            K = self.Dj * k_local
            cand_g = (torch.rand(K, generator=g) < 0.5).to(dev)
            choice_g = torch.randint(0, self.N, (K,), generator=g,
                                     dtype=torch.int32).to(dev)
            ones = torch.ones(K, device=dev)

            def reconcile():
                return waterfill_accept(cand_g, choice_g, ones, loadN, cap,
                                        False)
        prof = {"bid_ms": _best_ms(bid, iters, dev),
                "gather_ms": _best_ms(gather, iters, dev),
                "reconcile_ms": _best_ms(reconcile, iters, dev)}
        self._phase_profile = {k: round(v, 4) for k, v in prof.items()}
        return self._phase_profile

    def stats_snapshot(self) -> dict:
        """Leased-metrics snapshot (component "mesh"): per-tick latency
        distribution, tick totals, the analytic collective-bytes estimate,
        and the last per-phase microbench if one ran."""
        est = self.estimate_collective_bytes(
            k_local=self._last_k_local or None,
            demand_format=self._last_demand_format)
        return {
            "tick_p50_ms": round(self.tick_ms.percentile(0.50), 3),
            "tick_p99_ms": round(self.tick_ms.percentile(0.99), 3),
            "ticks_total": self._ticks_total,
            "collective_bytes_total": self._collective_bytes_total,
            "collective_bytes_per_tick": est["per_tick"],
            "collective_bytes_per_round": est["per_round"],
            "compacted_bytes_total": self._compacted_bytes_total,
            "compacted_ticks_total": self._compacted_ticks_total,
            # string field: /v1/metrics renders it as the demand_format
            # LABEL on every cronsun_mesh_tick_* sample, not a gauge
            "demand_format": est["demand_format"],
            "node_block_psum": 1 if self.node_block_psum else 0,
            "devices": int(self.mesh.devices.size),
            "shard_bids": 1 if self.shard_bids else 0,
            "rounds": self.rounds,
            **{f"phase_{k}": v for k, v in self._phase_profile.items()},
        }


def _best_ms(fn, iters: int, device: torch.device) -> float:
    """Least ms of ``iters`` calls of ``fn`` after one warm call: CUDA
    events on the card, ``perf_counter`` on the CPU."""
    fn()
    best = _INF
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
    return best


class ShardedTickPlanner(_ShardedPlannerBase):
    """TickPlanner over a 1-D jobs-sharded mesh.  Same contract as
    ops.planner.TickPlanner's plan/plan_window and setters; each shard's
    state lives on its device.  ``impl`` is accepted for the reference's
    signature; the device picks the route (kernels on the card, plain
    PyTorch on the CPU)."""

    def __init__(self, mesh: Mesh, job_capacity: int, node_capacity: int,
                 rounds: int = 3, impl: str = "auto",
                 max_fire_bucket: int = 65536, tz=None,
                 shard_bids: bool = True, demand_format: str = "auto"):
        if mesh.axis_names != (AXIS,):
            raise ValueError(f"need a ({AXIS!r},) mesh")
        self.Dj = self.D = mesh.devices.size
        self._init_common(mesh, job_capacity, node_capacity, rounds,
                          max_fire_bucket, tz, word_align=32,
                          shard_bids=shard_bids, demand_format=demand_format)

    def _tick(self, fire, load, rem_cap, k_local, compact_k):
        return _tick_local(self.cx, fire, self._shards, load, rem_cap,
                           k_local, self.rounds, self.shard_bids, compact_k)


class Sharded2DTickPlanner(_ShardedPlannerBase):
    """Tick+assign over a (jobs x nodes) 2-D mesh: the eligibility matrix
    shards both ways.  Same contract as ShardedTickPlanner.  Exact-score
    ties break to the lowest global node id (K1n), so placements do not
    depend on the column split."""

    def __init__(self, mesh: Mesh, job_capacity: int, node_capacity: int,
                 rounds: int = 3, impl: str = "jnp",
                 max_fire_bucket: int = 65536, tz=None,
                 shard_bids: bool = True, demand_format: str = "auto",
                 node_block_psum=None):
        if mesh.axis_names != (AXIS, NAXIS):
            raise ValueError(f"need a ({AXIS!r}, {NAXIS!r}) mesh")
        self.Dj = mesh.shape[AXIS]
        self.Dn = mesh.shape[NAXIS]
        self._init_common(mesh, job_capacity, node_capacity, rounds,
                          max_fire_bucket, tz, word_align=32 * self.Dn,
                          shard_bids=shard_bids, demand_format=demand_format,
                          node_block_psum=node_block_psum)

    def _tick(self, fire, load, rem_cap, k_local, compact_k):
        return _tick2d_local(self.cx, fire, self._shards, load, rem_cap,
                             k_local, self.rounds, self.shard_bids,
                             compact_k, self.node_block_psum)
