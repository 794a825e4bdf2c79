"""Multi-tenant admission: token buckets in the windowed plan plus weighted
max-min fair share (counterpart of ``cronsun_tpu/ops/tenancy.py``).

- **Token buckets** (device, :func:`admit`): every limited tenant carries
  one bucket — ``tokens`` [T] float32, refilled by ``rate`` and capped at
  ``burst`` each planned second — and admits at most ``floor(tokens)`` of
  its fires per second, first fires in row order winning.
- **Fair share** (device, :func:`fair_shares`; host,
  :func:`weighted_max_min` + :func:`select_fair`): when a second's
  exclusive demand exceeds the fleet's remaining slots, each tenant clamps
  to its weighted max-min share.

A refused time-triggered fire is SHED (a missed second does not come
back); a refused dep-triggered fire is THROTTLED (its last_fire does not
advance, so it retries).

The per-tenant rank ("first k fires of tenant t") needs no [J, T] one-hot
and no sort per second: the planner keeps a host-computed permutation that
groups rows by tenant (:func:`tenant_order`, recomputed on tenant churn),
and a rank is one cumulative sum over the permuted fire column.  Per-tenant
totals are differences of those cumulative sums at each tenant's segment
bounds (:class:`TenantOrder`), so no scatter-add with repeated indices
runs on the card.

:class:`ReferenceAdmission` and :func:`reference_max_min` are the
pure-Python oracles.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_I32_MAX = int(np.iinfo(np.int32).max)


def tenant_order(tenants: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Precompute the admission permutation for a row->tenant map:
    ``(perm, sorted_tenant, segbase)`` where ``perm`` stably sorts rows by
    tenant, ``sorted_tenant[i] = tenants[perm[i]]`` and ``segbase[i]`` is
    the permuted index where ``i``'s tenant segment begins.  Host-side,
    O(J log J)."""
    t = np.asarray(tenants, np.int32)
    perm = np.argsort(t, kind="stable").astype(np.int32)
    ts = t[perm]
    n = len(ts)
    segbase = np.zeros(n, np.int32)
    if n > 1:
        new = ts[1:] != ts[:-1]
        starts = np.concatenate([[0], np.flatnonzero(new) + 1])
        seg_id = np.concatenate([[0], np.cumsum(new.astype(np.int64))])
        segbase = starts[seg_id].astype(np.int32)
    return perm, ts.astype(np.int32), segbase


@dataclasses.dataclass
class TenantOrder:
    """:func:`tenant_order` on the device, in the forms admission indexes
    with: ``perm``/``inv`` [J] (a permutation and its inverse),
    ``sorted_tenant`` and ``segbase`` [J], and ``seg_lo``/``seg_hi`` [T]
    (tenant t's rows are permuted positions [seg_lo[t], seg_hi[t]); equal
    for a tenant with no row).  All int64."""
    perm: torch.Tensor
    inv: torch.Tensor
    sorted_tenant: torch.Tensor
    segbase: torch.Tensor
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor

    @classmethod
    def from_tenants(cls, tenants: np.ndarray, n_tenants: int,
                     device) -> "TenantOrder":
        perm, ts, segbase = tenant_order(tenants)
        if len(ts) and not (0 <= ts[0] and ts[-1] < n_tenants):
            raise ValueError(f"tenant ids must lie in [0, {n_tenants})")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        ids = np.arange(n_tenants)
        lo = np.searchsorted(ts, ids, side="left")
        hi = np.searchsorted(ts, ids, side="right")

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)
        return cls(dev(perm), dev(inv), dev(ts), dev(segbase), dev(lo),
                   dev(hi))


def _cum0(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-start cumulative sum of a 1-D tensor: ``out[i]`` is the sum
    of ``x[:i]`` (int32), one longer than ``x``.  Keep scans 1-D: torch
    scans a 1-D CUDA tensor with one device-wide scan, but a [2, 2^20]
    tensor with a per-row kernel (~1.4 ms on the H100) and a [2^20, 2] one
    along dim 0 with a thread per column (~60 ms)."""
    return F.pad(torch.cumsum(x, 0, dtype=torch.int32), (1, 0))


def fair_shares(demand: torch.Tensor, weight: torch.Tensor,
                capacity: torch.Tensor) -> torch.Tensor:
    """Device weighted max-min: per-tenant shares of ``capacity`` slots —
    maximize the minimum share/weight subject to ``share <= demand`` and
    ``sum(share) <= capacity``.  Continuous waterfill, floored, then the
    stranded remainder (< 1 slot per unsaturated tenant) granted one unit
    each to the smallest floored share/weight (ties to the lowest id).
    ``demand`` [T] int32, ``weight`` [T] f32, ``capacity`` f32 scalar
    tensor; returns [T] int32."""
    T = demand.shape[0]
    dev = demand.device
    d = demand.to(torch.float32)
    cap = capacity.clamp(min=0.0)
    order = torch.argsort(d / weight, stable=True)
    d_s = d[order]
    w_s = weight[order]
    cum_d = torch.cumsum(d_s, 0)
    cum_w = torch.cumsum(w_s, 0)
    rem_cap = cap - F.pad(cum_d[:-1], (1, 0))
    rem_w = cum_w[-1] - F.pad(cum_w[:-1], (1, 0))
    level_k = rem_cap / rem_w.clamp(min=1e-9)
    saturates = d_s <= level_k * w_s
    # tenants saturate in a prefix of the demand/weight order; the
    # cumulative product finds its length (later spurious saturations
    # do not count)
    k = torch.cumprod(saturates.to(torch.int32), 0).sum()
    # a gather, not ``level_k[k]``: indexing with a 0-dim tensor reads it
    # back to the host and stalls the stream
    level = level_k.gather(0, k.clamp(max=T - 1).view(1)).squeeze(0)
    in_prefix = torch.arange(T, device=dev) < k
    shares_s = torch.where(in_prefix | (k >= T), d_s,
                           torch.minimum(d_s, torch.floor(level * w_s)))
    shares = torch.empty(T, dtype=torch.int32, device=dev)
    shares[order] = shares_s.to(torch.int32)
    # top-up: one unit each to the smallest floored share/weight (stable
    # sort: ties to the lowest id); nothing is eligible when capacity is
    # abundant.  The clamp keeps the float -> int32 conversion in range:
    # past 2^31 slots no tenant is eligible, so the value is never used.
    eligible = shares < demand
    leftover = (torch.floor(cap.clamp(max=2.0 ** 31 - 128)).to(torch.int32)
                - shares.sum(dtype=torch.int32)).clamp(0, T)
    leftover = torch.minimum(leftover, eligible.sum(dtype=torch.int32))
    key = torch.where(eligible, shares.to(torch.float32) / weight,
                      float("inf"))
    order2 = torch.argsort(key, stable=True)
    grant = torch.empty(T, dtype=torch.bool, device=dev)
    grant[order2] = torch.arange(T, device=dev) < leftover
    return shares + (grant & eligible).to(torch.int32)


def admit(fire: torch.Tensor, time_fire: torch.Tensor, ex_p: torch.Tensor,
          tokens: torch.Tensor, rate: torch.Tensor, burst: torch.Tensor,
          limited: torch.Tensor, weight: torch.Tensor, rem_cap: torch.Tensor,
          order: TenantOrder):
    """One second of tenant admission, two clamps:

    1. **token bucket** — each limited tenant's fires clamp to
       ``floor(tokens)`` after this second's refill, first fires in row
       order winning;
    2. **fair share** — when the surviving exclusive demand exceeds the
       fleet's remaining slots (``sum(rem_cap)``), each tenant clamps to
       its :func:`fair_shares` share.

    ``fire`` [J] bool — all fires this second (time + dep); ``time_fire``
    [J] bool — the time-triggered subset; ``ex_p`` [J] bool — the
    exclusive flags in permuted order (``exclusive[order.perm]``, constant
    over a window); ``tokens``/``rate``/``burst``/``limited``/``weight``
    [T]; ``rem_cap`` [N] int32.

    Tokens are spent by finally admitted fires only.  Returns
    ``(admitted [J] bool, new tokens [T] f32, throttled [T] int32, shed [T]
    int32)``."""
    perm, st, segbase = order.perm, order.sorted_tenant, order.segbase
    lo, hi = order.seg_lo, order.seg_hi
    # refill first: a second's own refill is spendable in that second
    tokens = torch.minimum(burst, tokens + rate)
    allowed = torch.where(limited, torch.floor(tokens).to(torch.int32),
                          _I32_MAX)
    fp = fire[perm]
    c = _cum0(fp.to(torch.int32))
    rank = c[1:] - c[segbase]               # 1-based among my tenant's fires
    a1_p = fp & (rank <= allowed[st])
    # fair share over the rate-admitted exclusive demand
    cx = _cum0((a1_p & ex_p).to(torch.int32))
    rank_x = cx[1:] - cx[segbase]
    demand_x = cx[hi] - cx[lo]
    # an exact integer sum, then f32: equal to any f32 summation order
    # wherever the share can depend on it (below 2^24 slots every order
    # is exact; above, every tenant's demand saturates)
    cap = rem_cap.clamp(min=0).sum().to(torch.float32)
    shares = fair_shares(demand_x, weight, cap)
    admit_p = a1_p & (~ex_p | (rank_x <= shares[st]))
    shed_p = fp & ~admit_p & time_fire[perm]
    # one scan over both flags end to end: segment differences in the
    # second half do not see the first half's total
    cs = _cum0(torch.cat([admit_p, shed_p]).to(torch.int32))
    J = fire.shape[0]
    adm_t, shed_t = cs[hi] - cs[lo], cs[J + hi] - cs[J + lo]
    fired_t = c[hi] - c[lo]
    tokens = torch.where(limited, tokens - adm_t.to(torch.float32), tokens)
    return admit_p[order.inv], tokens, fired_t - adm_t, shed_t


class ReferenceAdmission:
    """Pure-Python spec of the token-bucket admission.  ``quotas``:
    {tenant_id: (rate, burst)}; absent tenants are unlimited."""

    def __init__(self, quotas: Dict[int, Tuple[float, float]]):
        self.quotas = dict(quotas)
        self.tokens = {t: b for t, (_r, b) in quotas.items()}

    def tick(self, fires: Sequence[Tuple[int, int]]) -> List[bool]:
        """``fires`` = [(row, tenant)] in ROW order; returns the admit
        decision per fire after one second's refill."""
        for t, (r, b) in self.quotas.items():
            self.tokens[t] = min(b, self.tokens[t] + r)
        allowed = {t: int(np.floor(v)) for t, v in self.tokens.items()}
        taken: Dict[int, int] = {}
        out = []
        for _row, ten in sorted(fires):
            if ten not in self.quotas:
                out.append(True)
                continue
            k = taken.get(ten, 0)
            ok = k < allowed[ten]
            if ok:
                taken[ten] = k + 1
                self.tokens[ten] -= 1.0
            out.append(ok)
        return out


# ---------------------------------------------------------------------------
# fair share (host, vectorized)
# ---------------------------------------------------------------------------

def weighted_max_min(demand: np.ndarray, weight: np.ndarray,
                     capacity: int) -> np.ndarray:
    """Integer weighted max-min shares: maximize the minimum
    ``share/weight`` subject to ``share_t <= demand_t`` and
    ``sum(share) <= capacity``.  Tenants sorted by ``demand/weight``
    saturate in that order; the rest split the remaining capacity by
    weight; the floored remainder goes one unit each to the smallest
    floored share/weight (ties to the lowest id).  Returns int64 shares."""
    d = np.asarray(demand, np.int64)
    w = np.asarray(weight, np.float64)
    n = len(d)
    shares = np.zeros(n, np.int64)
    if capacity <= 0 or n == 0:
        return shares
    if d.sum() <= capacity:
        return d.copy()
    idx = np.flatnonzero(d > 0)
    r = d[idx] / w[idx]
    order = idx[np.argsort(r, kind="stable")]
    d_sorted = d[order].astype(np.float64)
    w_sorted = w[order]
    cum_d = np.concatenate([[0.0], np.cumsum(d_sorted)])
    cum_w = np.concatenate([[0.0], np.cumsum(w_sorted)])
    rem_cap = capacity - cum_d[:-1]                    # before tenant k
    rem_w = cum_w[-1] - cum_w[:-1]
    level = rem_cap / np.maximum(rem_w, 1e-12)
    saturates = d_sorted <= level * w_sorted
    # the first non-saturating index is the split
    ns = np.flatnonzero(~saturates)
    k = int(ns[0]) if len(ns) else len(order)
    sat = order[:k]
    uns = order[k:]
    shares[sat] = d[sat]
    if len(uns):
        lvl = (capacity - d[sat].sum()) / w[uns].sum()
        base = np.minimum(np.floor(lvl * w[uns]).astype(np.int64), d[uns])
        shares[uns] = base
        left = int(capacity - shares.sum())
        if left > 0:
            cands = np.flatnonzero(shares < d)
            order2 = cands[np.argsort(shares[cands] / w[cands],
                                      kind="stable")]
            shares[order2[:left]] += 1
    return shares


def reference_max_min(demand, weight, capacity) -> np.ndarray:
    """O(T^2) oracle for :func:`weighted_max_min`: iterative saturation
    with no sort and no prefix algebra, then the same floor + top-up."""
    d = np.asarray(demand, np.int64)
    w = np.asarray(weight, np.float64)
    n = len(d)
    shares = np.zeros(n, np.int64)
    cap = float(capacity)
    if capacity <= 0 or n == 0:
        return shares
    if d.sum() <= capacity:
        return d.copy()
    active = {t for t in range(n) if d[t] > 0}
    level = 0.0
    while active:
        level = cap / sum(w[t] for t in active)
        sat = [t for t in active if d[t] <= level * w[t]]
        if not sat:
            break
        for t in sat:
            shares[t] = d[t]
            cap -= float(d[t])
            active.discard(t)
    for t in active:
        shares[t] = min(d[t], int(np.floor(level * w[t])))
    left = int(capacity - shares.sum())
    if left > 0:
        cands = sorted((t for t in range(n) if shares[t] < d[t]),
                       key=lambda t: (shares[t] / w[t], t))
        for t in cands[:left]:
            shares[t] += 1
    return np.asarray(shares, np.int64)


def select_fair(tenants: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Keep mask selecting the FIRST ``caps[t]`` entries of each tenant in
    input order.  ``tenants`` [F] int32 ids; ``caps`` [T] int64 (by id)."""
    t = np.asarray(tenants, np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(0, bool)
    order = np.argsort(t, kind="stable")
    ts = t[order]
    new = np.concatenate([[True], ts[1:] != ts[:-1]])
    starts = np.flatnonzero(new)
    seg_id = np.cumsum(new) - 1
    rank = np.arange(n, dtype=np.int64) - starts[seg_id]
    keep_sorted = rank < np.asarray(caps, np.int64)[ts]
    keep = np.zeros(n, bool)
    keep[order] = keep_sorted
    return keep
