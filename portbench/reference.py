"""The plain reference that decides ``correct``: NumPy and PyTorch only.

It imports nothing of the system under test and takes nothing the program
made.  It draws the inputs again from the seed (:mod:`portbench.gen`),
evaluates every spec itself, and reads the program's outputs only to judge
them (:func:`check_planner`):

- every planned second's fired rows, totals and overflow against its own
  due set;
- every exclusive placement on an eligible node; no exclusive fire left
  unplaced while an eligible node had capacity; each node's remaining
  capacity;
- each node's load against the fan-out and placement costs summed again in
  float64;
- the bid: at seconds drawn from the seed, each node's load at the start of
  that second's bids is worked out again in float64 (every fan-out up to
  and including the second, every placement before it), and each exclusive
  fire's node is held against the least-loaded open node it was eligible
  for (see :func:`_bid_excess`).

A check is ``(name, value, limit)`` and passes when ``value <= limit``.

The controls (:func:`control_planner`) are this reference put in the
program's place with one guarantee broken; the checks have to refuse them.
"""

from __future__ import annotations

import calendar
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import gen

# One planned second of a planner, as the program reports it: (epoch,
# fired rows [F] int32 with the n_excl exclusive ones first, their nodes
# [F] int32 (-1 for Common or unplaced), n_excl, total fired, overflow).
Second = Tuple[int, np.ndarray, np.ndarray, int, int, int]


# ------------------------------------------------------------- cron specs

_DOW = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5,
        "sat": 6}
_MON = {m.lower(): i for i, m in enumerate(calendar.month_abbr) if m}
_RANGES = ((0, 59), (0, 59), (0, 23), (1, 31), (1, 12), (0, 6))


def _value(text: str, names: Dict[str, int]) -> int:
    return names[text.lower()] if text.lower() in names else int(text)


def _field(text: str, lo: int, hi: int, names: Dict[str, int]) -> set:
    out = set()
    for part in text.split(","):
        rng, _, step = part.partition("/")
        if rng in ("*", "?"):
            a, b = lo, hi
        elif "-" in rng:
            a, b = (_value(x, names) for x in rng.split("-"))
        else:
            a = _value(rng, names)
            b = hi if step else a
        out.update(range(a, b + 1, int(step) if step else 1))
    return out


def parse_cron(spec: str):
    """Six-field spec (sec min hour dom month dow) -> six sets of allowed
    values, and whether dom / dow are unrestricted (``*`` or ``?``)."""
    f = spec.split()
    if len(f) != 6:
        raise ValueError(f"not a six-field spec: {spec!r}")
    names = ({}, {}, {}, {}, _MON, _DOW)
    sets = [_field(f[i], *_RANGES[i], names[i]) for i in range(6)]
    if 7 in sets[5]:
        sets[5].add(0)
    return sets, f[3] in ("*", "?"), f[5] in ("*", "?")


def utc_fields(t) -> Tuple[np.ndarray, ...]:
    """(sec, min, hour, dom, month, dow) of epoch seconds, in UTC."""
    t = np.asarray(t, np.int64)
    days = t // 86400
    sod = t % 86400
    dates = np.datetime64("1970-01-01", "D") + days
    month_start = dates.astype("datetime64[M]")
    month = (month_start - dates.astype("datetime64[Y]")
             .astype("datetime64[M]")).astype(np.int64) + 1
    dom = (dates - month_start.astype("datetime64[D]")).astype(np.int64) + 1
    dow = (days + 4) % 7            # 1970-01-01 was a Thursday
    return sod % 60, (sod // 60) % 60, sod // 3600, dom, month, dow


def cron_due(spec: str, t) -> np.ndarray:
    """[len(t)] bool: does ``spec`` fire at each epoch second (UTC)."""
    sets, dom_star, dow_star = parse_cron(spec)
    f = utc_fields(t)
    ok = [np.isin(f[i], sorted(sets[i])) for i in range(6)]
    day = ok[3] & ok[5] if (dom_star or dow_star) else ok[3] | ok[5]
    return ok[0] & ok[1] & ok[2] & ok[4] & day


# ---------------------------------------------------------- planner cells

def due_matrix(inp: gen.PlannerInputs, epochs: Sequence[int]) -> torch.Tensor:
    """[J, len(epochs)] bool: which rows are due at each second."""
    dev = inp.period.device
    t = torch.as_tensor(np.asarray(epochs, np.int64), device=dev)
    due = inp.is_every[:, None] & (torch.remainder(
        t[None, :] - inp.anchor[:, None], inp.period[:, None]) == 0)
    for i, fam in enumerate(inp.families):
        if "cron" in fam:
            at = torch.as_tensor(cron_due(fam["cron"], epochs), device=dev)
            due |= (inp.family == i)[:, None] & at[None, :]
    return due


def _bits(elig: torch.Tensor, rows: torch.Tensor,
          nodes: torch.Tensor) -> torch.Tensor:
    """bit (row, node) of the packed eligibility, as int32 0/1."""
    words = elig[rows, nodes >> 5]
    return (words >> (nodes & 31).to(torch.int32)) & 1




def _unpack(elig: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """[len(rows), n] bool: the eligibility of ``rows``, unpacked."""
    cols = torch.arange(n, device=elig.device)
    return ((elig[rows][:, cols // 32] >> (cols % 32).to(torch.int32))
            & 1).bool()


def _node_sums(inp: gen.PlannerInputs, weights: torch.Tensor,
               block: int = 8192) -> torch.Tensor:
    """[N] float64 (``weights`` [J]) or [S, N] (``weights`` [J, S]): the
    sum over rows of weights[j] * bit(j, n), one bit plane at a time over
    blocks of rows."""
    J, w32 = inp.elig.shape
    w2 = weights.reshape(J, -1).double()
    out = torch.zeros((w2.shape[1], w32, 32), dtype=torch.float64,
                      device=inp.elig.device)
    for s in range(0, J, block):
        w = w2[s:s + block]
        if not bool((w != 0).any()):
            continue
        words = inp.elig[s:s + block]
        for b in range(32):
            plane = ((words >> b) & 1).to(torch.float64)
            out[:, :, b] += w.T @ plane
    out = out.reshape(w2.shape[1], -1)
    return out[0] if weights.dim() == 1 else out


def sample_seconds(n: int, seed: int, k: int = 32) -> List[int]:
    """Up to ``k`` of ``n`` planned seconds (their indexes) drawn from
    ``seed``, the last always among them: where the bid is held to the
    reference."""
    if n <= 0:
        return []
    rng = np.random.default_rng(gen.sub_seed(seed, 90))
    pick = rng.choice(n, size=min(k, n), replace=False).tolist()
    return sorted(set(pick) | {n - 1})


def _bid_excess(inp: gen.PlannerInputs, start_load: torch.Tensor,
                open_n: torch.Tensor, rows: torch.Tensor,
                nodes: torch.Tensor) -> float:
    """How far one second's exclusive placements lie above the least load
    the bid could have taken, as a share of the mean node load.

    ``start_load`` [N] float64 is each node's load when the second's bids
    start (after its fan-out), ``open_n`` the nodes with capacity then;
    ``rows``/``nodes`` the second's placements.  A bid takes a row's
    least-loaded open eligible node; a later round bids again on loads that
    the earlier rounds' accepts raised.  So a placed row's start load lies
    above the least start load among its eligible open nodes by at most the
    most that the second's placements added to any one node (a, below).
    The excess over that, of the worst row, over the mean start load: 0 in
    exact arithmetic, the float32 loads' rounding in a sound program."""
    if len(rows) == 0:
        return 0.0
    N = inp.nodes
    added = torch.zeros(N, dtype=torch.float64, device=start_load.device)
    added.index_add_(0, nodes, inp.cost[rows].double())
    a = float(added.max())
    worst = 0.0
    for s in range(0, len(rows), 4096):
        r, n = rows[s:s + 4096], nodes[s:s + 4096]
        ok = _unpack(inp.elig, r, N) & open_n[None, :]
        least = torch.where(ok, start_load[None, :],
                            float("inf")).min(1).values
        worst = max(worst, float((start_load[n] - least).max()))
    return max(0.0, worst - a) / max(1.0, float(start_load.mean()))


def check_planner(inp: gen.PlannerInputs, bucket: Tuple[int, int],
                  seconds: Sequence[Second], load, rem_cap,
                  limits: Dict[str, float], seed: int):
    """The checks of a planner cell: every planned second since the
    planner was built (in dispatch order), and its load and remaining
    capacity after the last; the bid at seconds drawn from ``seed``.
    Returns (checks, seconds attempted, seconds failed)."""
    dev = inp.elig.device
    J, N = inp.jobs, inp.nodes
    kx, kc = bucket
    cost = inp.cost.double()
    common_n = torch.zeros(J, dtype=torch.float64, device=dev)
    place_n = torch.zeros(N, dtype=torch.float64, device=dev)
    place_cost = torch.zeros(N, dtype=torch.float64, device=dev)
    sampled = set(sample_seconds(len(seconds), seed))
    # per sampled second: Common fires so far (its own included), and the
    # placements before it and in it
    snap_common: List[torch.Tensor] = []
    snaps: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]] = []
    bad_seconds = set()
    ineligible = 0
    unplaced_rows: List[torch.Tensor] = []
    chunk = 64
    for c0 in range(0, len(seconds), chunk):
        part = seconds[c0:c0 + chunk]
        due = due_matrix(inp, [s[0] for s in part])
        rows_all, nodes_all, owner = [], [], []
        for w, (ep, fired, assigned, n_excl, total, over) in enumerate(part):
            col = due[:, w]
            xr = torch.nonzero(col & inp.exclusive).flatten()
            cr = torch.nonzero(col & ~inp.exclusive).flatten()
            nx, nc = min(len(xr), kx), min(len(cr), kc)
            want_over = max(0, len(xr) - kx) + max(0, len(cr) - kc)
            ok = (total == len(xr) + len(cr) and over == want_over
                  and n_excl == nx and len(fired) == nx + nc
                  and np.array_equal(fired[:nx], xr[:nx].cpu().numpy())
                  and np.array_equal(fired[nx:], cr[:nc].cpu().numpy()))
            if not ok:
                bad_seconds.add(ep)
            common_n[cr[:nc]] += 1.0
            if c0 + w in sampled:
                snap_common.append(common_n.to(torch.float32))
            rows_all.append(fired[:n_excl])
            nodes_all.append(assigned[:n_excl])
            owner.append(np.full(n_excl, c0 + w, np.int64))
        rows = torch.as_tensor(np.concatenate(rows_all).astype(np.int64),
                               device=dev)
        nodes = torch.as_tensor(np.concatenate(nodes_all).astype(np.int64),
                                device=dev)
        own = np.concatenate(owner)
        placed = nodes >= 0
        in_range = placed & (nodes < N) & (rows >= 0) & (rows < J)
        bad = placed & ~in_range
        r, n = rows[in_range], nodes[in_range]
        off = _bits(inp.elig, r, n) == 0
        bad[torch.nonzero(in_range).flatten()[off]] = True
        ineligible += int(bad.sum())
        for i in np.unique(own[bad.cpu().numpy()]):
            bad_seconds.add(int(part[i - c0][0]))
        ok = in_range.clone()
        ok[torch.nonzero(in_range).flatten()[off]] = False
        own_t = torch.as_tensor(own, device=dev)
        for i in sorted(i for i in sampled if c0 <= i < c0 + len(part)):
            before = ok & (own_t < i)
            this = ok & (own_t == i)
            cost_before = place_cost.index_add(0, nodes[before],
                                               cost[rows[before]])
            n_before = place_n.index_add(
                0, nodes[before], torch.ones(int(before.sum()),
                                             dtype=torch.float64, device=dev))
            snaps.append((cost_before, inp.node_cap.double() - n_before > 0,
                          rows[this], nodes[this]))
        place_n.index_add_(0, nodes[ok], torch.ones(int(ok.sum()),
                                                    dtype=torch.float64,
                                                    device=dev))
        place_cost.index_add_(0, nodes[ok], cost[rows[ok]])
        miss = ~placed & (rows >= 0) & (rows < J)
        if bool(miss.any()):
            unplaced_rows.append(rows[miss])
    cap = inp.node_cap.double()
    # an unplaced exclusive fire is a fault when one of its eligible nodes
    # never filled up: that node had capacity all along
    open_nodes = place_n < cap
    unplaced = 0
    for rows in unplaced_rows:
        for s in range(0, len(rows), 4096):
            bits = _unpack(inp.elig, rows[s:s + 4096], N)
            unplaced += int((bits & open_nodes[None, :]).any(1).sum())
    ref_load = _node_sums(inp, common_n * cost) + place_cost
    got_load = torch.as_tensor(np.asarray(load), device=dev).double()[:N]
    got_cap = torch.as_tensor(np.asarray(rem_cap), device=dev).double()[:N]
    gap = float(((got_load - ref_load).abs()
                 / ref_load.abs().clamp(min=1.0)).max())
    cap_bad = int((got_cap != cap - place_n).sum())
    excess = 0.0
    if snaps:
        fanned = _node_sums(inp, torch.stack(snap_common, 1).double()
                            * cost[:, None])
        for k, (cost_before, open_n, rows, nodes) in enumerate(snaps):
            excess = max(excess, _bid_excess(
                inp, fanned[k] + cost_before, open_n, rows, nodes))
    checks = [("due_mismatch_seconds", float(len(bad_seconds)), 0.0),
              ("ineligible_placements", float(ineligible), 0.0),
              ("unplaced_with_capacity", float(unplaced), 0.0),
              ("capacity_mismatch_nodes", float(cap_bad), 0.0),
              ("load_rel_gap", gap, float(limits["load_rel_gap"])),
              ("bid_excess", excess, float(limits["bid_excess"]))]
    return checks, len(seconds), len(bad_seconds)


# the controls: the reference in the program's place, each with one
# guarantee broken (keyword arguments of control_planner)
CONTROLS = {
    # node loads held in bfloat16, below the float32 the configuration states
    "bf16_load": {"load_dtype": torch.bfloat16},
    # loads kept in float32, the bid taken over them rounded to bfloat16
    "bf16_bid": {"bid_dtype": torch.bfloat16},
    # each exclusive fire on its first eligible open node: no balancing
    "first_node": {"first_eligible": True},
}


def control_planner(inp: gen.PlannerInputs, bucket: Tuple[int, int],
                    epochs: Sequence[int], load_dtype=torch.float32,
                    bid_dtype=None, first_eligible: bool = False):
    """The reference in the program's place: each second's due rows, each
    exclusive one on its eligible open node of least load (one round, on
    the loads after the second's fan-out), the Common ones fanned out.
    Loads are held in ``load_dtype``, rounded to it once a second; the bid reads them rounded to
    ``bid_dtype`` when given, or takes the first eligible open node with
    ``first_eligible``.  Returns (seconds, load, rem_cap) in the program's
    report format."""
    dev = inp.elig.device
    N = inp.nodes
    kx, kc = bucket
    load = torch.zeros(N, dtype=load_dtype, device=dev)
    rem = inp.node_cap.clone()
    out: List[Second] = []
    for c0 in range(0, len(epochs), 64):
        part = list(epochs[c0:c0 + 64])
        due = due_matrix(inp, part)
        for w, ep in enumerate(part):
            xr = torch.nonzero(due[:, w] & inp.exclusive).flatten()
            cr = torch.nonzero(due[:, w] & ~inp.exclusive).flatten()
            nx, nc = min(len(xr), kx), min(len(cr), kc)
            x, c = xr[:nx], cr[:nc]
            add = torch.zeros(N, dtype=torch.float32, device=dev)
            for s in range(0, nc, 4096):
                add += inp.cost[c[s:s + 4096]] @ _unpack(
                    inp.elig, c[s:s + 4096], N).float()
            bid = load.float() + add
            if bid_dtype is not None:
                bid = bid.to(bid_dtype).float()
            choice = torch.full((nx,), -1, dtype=torch.int64, device=dev)
            for s in range(0, nx, 4096):
                bits = _unpack(inp.elig, x[s:s + 4096], N) & (rem > 0)[None, :]
                if first_eligible:
                    arg = bits.int().argmax(1)
                    best = torch.where(bits.any(1), 0.0, float("inf"))
                else:
                    best, arg = torch.where(bits, bid[None, :],
                                            float("inf")).min(1)
                choice[s:s + 4096] = torch.where(torch.isfinite(best), arg, -1)
            ok = choice >= 0
            placed = torch.zeros(N, dtype=torch.float32, device=dev)
            placed.index_add_(0, choice[ok], inp.cost[x[ok]])
            rem.index_add_(0, choice[ok], torch.full((int(ok.sum()),), -1,
                                                      dtype=torch.int64,
                                                      device=dev))
            load = (load.float() + add + placed).to(load_dtype)
            fired = torch.cat([x, c]).to(torch.int32).cpu().numpy()
            assigned = torch.cat([choice, torch.full((nc,), -1, device=dev,
                                                     dtype=torch.int64)])
            out.append((int(ep), fired,
                        assigned.to(torch.int32).cpu().numpy(), nx,
                        len(xr) + len(cr),
                        max(0, len(xr) - kx) + max(0, len(cr) - kc)))
    return out, load.float().cpu().numpy(), rem.cpu().numpy()
