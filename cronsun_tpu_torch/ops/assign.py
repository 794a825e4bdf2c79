"""Load-balanced, capacity-constrained job->node assignment (counterpart of
``cronsun_tpu/ops/assign.py``, its single-device half).

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
"""

from __future__ import annotations

import torch

from .kernels import bid_argmin, bid_block_plain, fanout_add, unpack_tile

__all__ = ["assign", "unpack_tile", "bid_block_plain", "choose_impl"]


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

    # per-node totals along the sort, written once per node (no atomics):
    # an f64 running sum differenced at segment ends, rounded once to f32
    # (exact for integer costs, as the f32 scatter-add is)
    is_last = torch.ones(K, dtype=torch.bool, device=cand.device)
    is_last[:-1] = sorted_key[1:] != sorted_key[:-1]
    is_last &= in_range
    nodes = sorted_key[is_last]
    acc_w = torch.where(accept_sorted, w_sorted, 0.0).to(torch.float64)
    cs = torch.cumsum(acc_w, 0)
    seg_w = (cs - (cs[first] - acc_w[first]))[is_last].to(torch.float32)
    cnt = torch.cumsum(accept_sorted.to(torch.int64), 0)
    acc_i = accept_sorted.to(torch.int64)
    seg_n = (cnt - (cnt[first] - acc_i[first]))[is_last].to(rem_cap.dtype)
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
