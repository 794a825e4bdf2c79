"""Load-balanced, capacity-constrained job->node assignment (counterpart of
``cronsun_tpu/ops/assign.py``).

- Exclusive jobs (kinds Alone/Interval) land on exactly one eligible node,
  by least load with capacity rationing: ``rounds`` bid/accept rounds.
  bid: every unplaced job takes its least-loaded open eligible node (K1).
  accept: bidders on one node are ranked (stable sort by node) and accepted
  up to the node's remaining capacity and — except in the final round — a
  waterfill quota, so one min-load node is never dogpiled.
- Common jobs fan out to every eligible node; their cost is added to node
  loads in one pass (K2).

A -1 result for an exclusive fired job means every eligible node was full
(the reference's Parallels-gate skip) or it had none.

**Determinism.** The accept step adds accepted costs per node.  Scatter-adds
with repeated indices run as float atomics on the card, in an order that
changes run to run; here each node's accepted cost is instead summed along
the sort the ranking already computed, and each node is written once.

The mesh planners' bucket-sharded reconcile (:mod:`..parallel.mesh`) uses
:func:`local_bid_demand`, :func:`compact_demand`, :func:`scatter_demand` and
:func:`waterfill_accept_presplit`: each shard ranks its own candidates and
the shards exchange per-node demand summaries instead of the candidates.
Their per-node sums follow the same rule (f64 along the sort).
"""

from __future__ import annotations

import torch

from .kernels import bid_argmin, bid_block_plain, fanout_add, unpack_tile

__all__ = ["assign", "unpack_tile", "bid_block_plain", "choose_impl",
           "local_bid_demand", "compact_demand", "scatter_demand",
           "waterfill_accept_presplit"]


def choose_impl(device: torch.device) -> str:
    """Which implementation the bid and fan-out take on ``device``: the
    hand-written kernels on the card (at every bucket size and node count),
    the plain PyTorch versions on the CPU.  The wrappers dispatch on the
    tensors' device themselves; this names that choice for callers that
    report it."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _rank_within_choice(key: torch.Tensor):
    """Stable sort by key; returns (rank within equal keys, sort order,
    sorted keys, segment-start positions)."""
    K = key.shape[0]
    sorted_key, order = torch.sort(key, stable=True)
    pos = torch.arange(K, dtype=torch.int64, device=key.device)
    is_first = torch.ones(K, dtype=torch.bool, device=key.device)
    is_first[1:] = sorted_key[1:] != sorted_key[:-1]
    first = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    return pos - first, order, sorted_key, first


def _segment_totals(sorted_key, first, in_range, *vals_sorted):
    """Per distinct key along a stable sort (``sorted_key``, segment starts
    ``first``): the keys, and for each of ``vals_sorted`` its sum over each
    segment as an f64 running sum differenced at the segment's end
    (order-free on the card, and exact for integer values).  Segments whose
    key is not ``in_range`` are dropped."""
    K = sorted_key.shape[0]
    is_last = torch.ones(K, dtype=torch.bool, device=sorted_key.device)
    is_last[:-1] = sorted_key[1:] != sorted_key[:-1]
    is_last &= in_range
    tots = []
    for vals in vals_sorted:
        v = vals.to(torch.float64)
        cs = torch.cumsum(v, 0)
        tots.append((cs - (cs[first] - v[first]))[is_last])
    return sorted_key[is_last], tots


def waterfill_accept(cand, choice, cost, load, rem_cap, is_final: bool):
    """One accept step: ration candidate bids per node.

    Accept per node only up to remaining capacity AND (unless final) a
    waterfill quota — the global target load level — so a min-load node is
    never dogpiled; rank 0 always lands (progress guarantee).

    Returns (accept [K] bool, new load [N'], new rem_cap [N']); the inputs
    are not modified."""
    K = cand.shape[0]
    n_padded = load.shape[0]
    key = torch.where(cand, choice.to(torch.int64), n_padded)
    rank, order, sorted_key, first = _rank_within_choice(key)
    safe_key = sorted_key.clamp(0, n_padded - 1)
    cap_at = rem_cap[safe_key]

    w = torch.where(cand, cost, 0.0)
    open_n = rem_cap > 0
    n_open = open_n.sum().clamp(min=1)
    level = (torch.where(open_n, load, 0.0).sum() + w.sum()) / n_open
    w_sorted = w[order]
    cum_excl = torch.cumsum(w_sorted, 0) - w_sorted
    cum_in_seg = cum_excl - cum_excl[first]
    headroom = level - load[safe_key]
    fits = (rank == 0) | (cum_in_seg + w_sorted <= headroom)
    in_range = sorted_key < n_padded
    accept_sorted = in_range & (rank < cap_at) & (is_final | fits)
    accept = torch.zeros(K, dtype=torch.bool, device=cand.device)
    accept[order] = accept_sorted

    # per-node totals along the sort, written once per node (no atomics),
    # rounded once to f32 (exact for integer costs, as the f32 scatter-add
    # is)
    nodes, (seg_w, seg_n) = _segment_totals(
        sorted_key, first, in_range,
        torch.where(accept_sorted, w_sorted, 0.0), accept_sorted)
    seg_w = seg_w.to(torch.float32)
    seg_n = seg_n.to(rem_cap.dtype)
    load = load.index_put((nodes,), load[nodes] + seg_w)
    rem_cap = rem_cap.index_put((nodes,), rem_cap[nodes] - seg_n)
    return accept, load, rem_cap


def _assign_excl(valid, elig_packed, load, rem_cap, cost, rounds: int,
                 rows=None):
    """Bid/accept rounds for a bucket of EXCLUSIVE fired jobs only (the
    split-bucket planner path).  load/rem_cap are padded to the bitpacked
    width.  With ``rows`` the bucket's row j is ``elig_packed[rows[j]]``
    (the kernel gathers it).  Each round bids only for the rows still
    unplaced: the others would be dropped by ``cand`` anyway."""
    K = valid.shape[0]
    cost = cost.to(torch.float32)
    assigned = torch.full((K,), -1, dtype=torch.int32, device=valid.device)
    for r in range(rounds):
        load_eff = torch.where(rem_cap > 0, load, float("inf"))
        active = valid & (assigned < 0)
        best, choice = bid_argmin(elig_packed, load_eff, rows=rows,
                                  active=active)
        cand = active & torch.isfinite(best)
        accept, load, rem_cap = waterfill_accept(
            cand, choice, cost, load, rem_cap, r == rounds - 1)
        assigned = torch.where(accept, choice, assigned)
    return assigned, load, rem_cap


def _fanout_load(elig_packed, valid, cost, load, rows=None):
    """Accumulate Common-bucket cost into per-node load (one K2 pass); with
    ``rows`` the bucket's row j is ``elig_packed[rows[j]]``."""
    w = torch.where(valid, cost.to(torch.float32), 0.0)
    return load + fanout_add(elig_packed, w, rows=rows)


def assign(fire: torch.Tensor, elig_packed: torch.Tensor,
           exclusive: torch.Tensor, load: torch.Tensor,
           rem_cap: torch.Tensor, cost: torch.Tensor, rounds: int = 3):
    """Place all fired jobs for one tick.

    Args:
      fire: [K] bool — jobs firing this tick.
      elig_packed: [K, W32] int32 eligibility bit patterns.
      exclusive: [K] bool — Alone/Interval kinds (exactly-one placement).
      load: [N] f32 per-node load; rem_cap: [N] int32 remaining slots;
        cost: [K] f32 per-job expected cost.
      rounds: bid/accept rounds.

    Returns: (assigned [K] int32 node column or -1, new load, new rem_cap).
    """
    n_nodes = rem_cap.shape[0]
    pad = elig_packed.shape[1] * 32 - n_nodes
    # pad columns have zero capacity, so they are never chosen
    load = torch.nn.functional.pad(load, (0, pad))
    rem_cap = torch.nn.functional.pad(rem_cap, (0, pad))
    cost = cost.to(torch.float32)
    load = _fanout_load(elig_packed, fire & ~exclusive, cost, load)
    assigned, load, rem_cap = _assign_excl(
        fire & exclusive, elig_packed, load, rem_cap, cost, rounds)
    return assigned, load[:n_nodes], rem_cap[:n_nodes]


# --------------------------------------------- the mesh's sharded reconcile

def _local_bid_demand(cand, choice, cost, n_padded: int):
    """:func:`local_bid_demand`, plus what the caller needs to sum its
    accepted candidates per node along the same sort: (rank, cum, demand,
    (order, sorted_key, first, in_range))."""
    K = cand.shape[0]
    dev = cand.device
    key = torch.where(cand, choice.to(torch.int64), n_padded)
    rank_s, order, sorted_key, first = _rank_within_choice(key)
    w = torch.where(cand, cost, 0.0)
    w_sorted = w[order]
    cum_excl = torch.cumsum(w_sorted, 0) - w_sorted
    cum_seg_s = cum_excl - cum_excl[first]
    rank = torch.empty(K, dtype=torch.int32, device=dev)
    rank[order] = rank_s.to(torch.int32)
    cum = torch.empty(K, dtype=torch.float32, device=dev)
    cum[order] = cum_seg_s
    in_range = sorted_key < n_padded
    nodes, (cnt, wn) = _segment_totals(sorted_key, first, in_range,
                                       torch.ones(K, device=dev), w_sorted)
    demand = torch.zeros((2, n_padded), dtype=torch.float32, device=dev)
    demand[0, nodes] = cnt.to(torch.float32)
    demand[1, nodes] = wn.to(torch.float32)
    return rank, cum, demand, (order, sorted_key, first, in_range)


def local_bid_demand(cand, choice, cost, n_padded: int):
    """Per-shard half of the bucket-sharded waterfill reconcile.

    Within THIS shard's candidate bucket: rank among same-node candidates
    (stable, original-index order) and the exclusive cumulative cost of the
    earlier same-node candidates — plus the per-node demand totals
    (candidate count, candidate cost sum) that shards exchange instead of
    the candidates themselves.  Counts ride f32 so the [2, N] demand block
    is ONE array on the wire; exact below 2^24 candidates per node.

    Returns (rank [K] int32, cum_in_seg [K] f32, demand [2, N] f32)."""
    return _local_bid_demand(cand, choice, cost, n_padded)[:3]


def node_sums(sort, n_padded: int, *vals) -> torch.Tensor:
    """[len(vals), N] f32: per node, the sums of each of ``vals`` ([K],
    original order) along the sort :func:`_local_bid_demand` returned — the
    accepted (count, cost) block of the sharded reconcile, summed as the
    demand block is."""
    order, sorted_key, first, in_range = sort
    nodes, tots = _segment_totals(sorted_key, first, in_range,
                                  *(v[order] for v in vals))
    out = torch.zeros((len(vals), n_padded), dtype=torch.float32,
                      device=sorted_key.device)
    for i, t in enumerate(tots):
        out[i, nodes] = t.to(torch.float32)
    return out


def compact_demand(demand, k_comp: int):
    """Compact a dense [2, N] per-node demand block (count, cost-sum) into
    [3, k_comp] f32 triples (node_idx, count, cost_sum) — the sparse-tick
    wire format the mesh reconcile gathers instead of the dense block.

    A shard's demand has at most min(#candidates, N) nonzero nodes, so
    ``k_comp = min(k_local, N)`` never truncates.  Node indices ride f32
    (exact below 2^24).  Pad entries carry distinct zero-demand node ids
    with count = cost = 0, so :func:`scatter_demand` adds nothing for them.
    Returns (triples [3, k_comp] f32, node ids [k_comp] int64)."""
    nz = demand[0] > 0
    # stable argsort of the zero mask: nonzero node ids first, in
    # ascending node order (the planner's compaction order)
    order = torch.argsort((~nz).to(torch.uint8), stable=True)
    idx = order[:k_comp]
    take = nz[idx]
    cnt = torch.where(take, demand[0][idx], 0.0)
    w = torch.where(take, demand[1][idx], 0.0)
    return torch.stack([idx.to(torch.float32), cnt, w]), idx


def scatter_demand(comp, n_padded: int):
    """Gathered compacted triples [D, 3, k_comp] -> dense [D, 2, N]
    per-shard demand blocks.  Within one shard the node ids are distinct
    (they come from a permutation), so each slot is written once and the
    block equals the one :func:`compact_demand` started from, value for
    value."""
    D = comp.shape[0]
    idx = comp[:, 0].to(torch.int64).clamp(0, n_padded - 1)
    rows = torch.arange(D, device=comp.device)[:, None].expand_as(idx)
    dense = torch.zeros((D, 2, n_padded), dtype=torch.float32,
                        device=comp.device)
    dense[rows, 0, idx] = comp[:, 1]
    dense[rows, 1, idx] = comp[:, 2]
    return dense


def waterfill_accept_presplit(cand, choice, cost, load, rem_cap, is_final,
                              rank_g, cum_g, tot_w):
    """Accept decision for candidates whose GLOBAL within-node rank and
    cumulative-demand cost are already known (local half + earlier
    shards' per-node prefix).  The accept predicate of
    :func:`waterfill_accept` — ``rank < rem_cap`` capacity rationing,
    waterfill quota against the global target level, rank-0 progress —
    evaluated per shard instead of on a gathered bucket.  Exact whenever
    the cost sums are (integer costs).

    Returns accept [K] bool; the caller owns the load/rem_cap update."""
    n_padded = load.shape[0]
    safe = choice.to(torch.int64).clamp(0, n_padded - 1)
    cap_at = rem_cap[safe]
    open_n = rem_cap > 0
    n_open = open_n.sum().clamp(min=1)
    level = (torch.where(open_n, load, 0.0).sum() + tot_w) / n_open
    w = torch.where(cand, cost, 0.0)
    headroom = level - load[safe]
    fits = (rank_g == 0) | (cum_g + w <= headroom)
    return cand & (rank_g < cap_at) & (is_final | fits)
