"""The plain reference of a bin-packing cell: NumPy and PyTorch only.

A bin-packing cell's nodes have a few slots each and its runs end: each
row runs for :func:`run_seconds`, and the runner plays the executors by
one rule: before window k (first second e_k) is dispatched, every
gathered placement or Common fire not yet released whose fire second plus
run time is <= e_k is released, with its slot and its load.  So the
reference of the planner cells, which holds ``rem_cap`` to the capacity
less every placement ever made, does not apply; this one replays the
releases.

It imports nothing of the program.  It draws the inputs again from the
seed (:mod:`portbench.gen`), evaluates every spec itself
(:func:`portbench.reference.due_matrix`), and replays every planned second
in dispatch order, with the releases the rule makes before each window,
in float64.  It reads the program's outputs (and the runner's record of
how many seconds it had gathered at each dispatch) only to judge them
(:func:`check_binpack`):

- ``due_mismatch_seconds``, ``ineligible_placements``: as the planner
  cells' reference;
- ``over_capacity_placements``: placements on a node beyond its free
  slots at the start of their second;
- ``unplaced_with_capacity``: an unplaced exclusive fire that had an
  eligible node still open at the end of its second, none of whose
  eligible nodes filled in that second (open at its start, full at its
  end).  The last bid round refuses a bid only when its node fills, and a
  fire's last bid went to an open node: so a sound planner leaves a fire
  unplaced only after a node it bid for filled, or when every eligible
  node was full;
- ``capacity_mismatch_nodes``: the program's final ``rem_cap`` against the
  capacity less the runs still running;
- ``load_rel_gap``: its final loads against the running runs' costs;
- ``bid_excess``: at seconds drawn from the seed, each placement against
  the least start load among the row's eligible nodes that were still
  open at the end of the second (:func:`portbench.reference._bid_excess`).
  Within a second slots are only taken, so such a node was open in every
  bid round; a node that filled during the second was not, and a bid
  refused there went on to the next least-loaded node.  At the same
  seconds each unplaced fire is held to the same bound: the least start
  load among its eligible nodes that filled (one of them refused its last
  bid) against the least among those still open (:func:`_unplaced_excess`).

The controls (:func:`control_binpack`) are this reference in the
program's place with one guarantee broken; the checks have to refuse
them, each by the check :data:`CONTROLS` names.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import gen
from .reference import (Second, _bid_excess, _bits, _node_sums, _unpack,
                        due_matrix, sample_seconds)

# the generator stream of the run times: above every stream
# gen.planner_inputs draws (1-5), so the rows stay those of the planner
# cells
RUN_STREAM = 16

# One dispatch, as the runner records it: (e_k, seconds gathered then).
Release = Tuple[int, int]


def run_seconds(cfg: dict, inp: gen.PlannerInputs, seed: int) -> torch.Tensor:
    """[J] int64 on the inputs' device: each row's run time, a fraction of
    its own period uniform in ``cfg["run_s"]`` = [lo, hi), drawn per row
    on generator stream :data:`RUN_STREAM`, rounded up to a whole second."""
    lo, hi = (float(x) for x in cfg["run_s"])
    dev = inp.period.device
    u = torch.rand(inp.jobs, generator=gen._gen(seed, RUN_STREAM, dev),
                   device=dev, dtype=torch.float64)
    return torch.ceil((lo + (hi - lo) * u) * inp.period.double()).to(
        torch.int64)


def closed_loop(n_windows: int, start: int, W: int,
                pipeline: int) -> List[Release]:
    """The release record of ``n_windows`` windows dispatched back to back
    with ``pipeline`` in flight: before window k the windows up to
    k - pipeline - 1 have been gathered."""
    return [(start + k * W, max(0, k - pipeline) * W)
            for k in range(n_windows)]


def _full_words(full: torch.Tensor) -> torch.Tensor:
    """[N] bool -> [N/32] int64: the packed words of the mask, as the
    eligibility packs node n = 32 w + b (low 32 bits)."""
    w32 = full.shape[0] // 32
    shift = torch.arange(32, dtype=torch.int64, device=full.device)
    return (full.reshape(w32, 32).to(torch.int64) << shift).sum(1)


class _Pending:
    """Gathered runs not yet released: exclusive (node, cost, end) and
    Common (row, end)."""

    def __init__(self, dev):
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        self.xn, self.xc, self.xe = z, z.double(), z
        self.cr, self.ce = z, z

    def add(self, entries: List[tuple]):
        """Add the runs of seconds newly gathered, each second's an
        (xn, xc, xe, cr, ce) tuple."""
        if entries:
            cols = list(zip(*entries))
            self.xn, self.xc, self.xe, self.cr, self.ce = (
                torch.cat([old, *new]) for old, new in zip(
                    (self.xn, self.xc, self.xe, self.cr, self.ce), cols))

    def take(self, e: int):
        """Remove and return the runs that have ended by ``e``: (exclusive
        nodes, their costs, Common rows)."""
        xd, cd = self.xe <= e, self.ce <= e
        out = self.xn[xd], self.xc[xd], self.cr[cd]
        self.xn, self.xc, self.xe = self.xn[~xd], self.xc[~xd], self.xe[~xd]
        self.cr, self.ce = self.cr[~cd], self.ce[~cd]
        return out


def check_binpack(inp: gen.PlannerInputs, bucket: Tuple[int, int], W: int,
                  seconds: Sequence[Second], releases: Sequence[Release],
                  run: torch.Tensor, load, rem_cap,
                  limits: Dict[str, float], seed: int):
    """The checks of a bin-packing cell: every planned second since the
    planner was built, in dispatch order, window k being seconds
    ``[k W, (k + 1) W)`` and preceded by the releases of ``releases[k]``;
    the load and remaining capacity after the last; the bid at seconds
    drawn from ``seed``.  Returns (checks, seconds attempted, seconds
    failed, info): info holds the shares the cell reports."""
    dev = inp.elig.device
    J, N = inp.jobs, inp.nodes
    kx, kc = bucket
    cost = inp.cost.double()
    cap = inp.node_cap.to(torch.int64)
    run = run.to(dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    running = torch.zeros(N, dtype=torch.int64, device=dev)
    x_load = torch.zeros(N, dtype=torch.float64, device=dev)
    common_n = torch.zeros(J, dtype=torch.float64, device=dev)
    pending = _Pending(dev)
    entries: List[tuple] = []
    added = 0
    sampled = set(sample_seconds(len(seconds), seed))
    snaps = []
    bad_seconds = set()
    ineligible, over, unplaced_bad = zero, zero, zero
    unplaced, excl, full_seconds, open_left = zero, 0, zero, zero
    n_win = min(len(releases), len(seconds) // W)
    if n_win * W != len(seconds) or n_win != len(releases):
        bad_seconds.update(range(n_win * W, max(len(seconds),
                                                len(releases) * W)))
    for k in range(n_win):
        e_k, g_k = releases[k]
        g_k = min(g_k, len(entries))
        if g_k > added:
            pending.add(entries[added:g_k])
            entries[added:g_k] = [None] * (g_k - added)
            added = g_k
        xn, xc, cr = pending.take(e_k)
        running -= torch.bincount(xn, minlength=N)
        x_load -= torch.zeros(N, dtype=torch.float64,
                              device=dev).index_add_(0, xn, xc)
        common_n.index_add_(0, cr, torch.full_like(cr, -1.0,
                                                   dtype=torch.float64))
        due = due_matrix(inp, [e_k + w for w in range(W)])
        for w in range(W):
            i = k * W + w
            t = e_k + w
            ep, fired, assigned, n_excl, total, ovf = seconds[i]
            col = due[:, w]
            xr = torch.nonzero(col & inp.exclusive).flatten()
            cr_due = torch.nonzero(col & ~inp.exclusive).flatten()
            nx, nc = min(len(xr), kx), min(len(cr_due), kc)
            want_over = max(0, len(xr) - kx) + max(0, len(cr_due) - kc)
            ok = (ep == t and total == len(xr) + len(cr_due)
                  and ovf == want_over and n_excl == nx
                  and len(fired) == nx + nc
                  and np.array_equal(fired[:nx], xr[:nx].cpu().numpy())
                  and np.array_equal(fired[nx:],
                                     cr_due[:nc].cpu().numpy()))
            if not ok:
                bad_seconds.add(i)
            rows = torch.as_tensor(np.asarray(fired[:n_excl], np.int64),
                                   device=dev)
            nodes = torch.as_tensor(np.asarray(assigned[:n_excl], np.int64),
                                    device=dev)
            row_ok = (rows >= 0) & (rows < J)
            placed = nodes >= 0
            in_range = placed & (nodes < N) & row_ok
            r, n = rows[in_range], nodes[in_range]
            n_off = (placed & ~in_range).sum() + (_bits(inp.elig, r, n)
                                                  == 0).sum()
            ineligible = ineligible + n_off
            if bool(n_off):
                bad_seconds.add(i)
            # capacity: this second's placements against the free slots
            # at its start
            cnt = torch.bincount(n, minlength=N)
            free = (cap - running).clamp(min=0)
            over = over + (cnt - free).clamp(min=0).sum()
            x_start = x_load.clone() if i in sampled else None
            running += cnt
            x_load.index_add_(0, n, cost[r])
            full = running >= cap
            filled = full & (free > 0)
            full_seconds = full_seconds + full.any()
            # unplaced: with an eligible node open at the end, one of the
            # row's eligible nodes filled in the second
            mr = rows[~placed & row_ok]
            unplaced = unplaced + len(mr)
            excl += int(n_excl)
            if len(mr):
                words = inp.elig[mr].to(torch.int64) & 0xFFFFFFFF
                can = ((words & _full_words(~full)[None, :]) != 0).any(1)
                hit = ((words & _full_words(filled)[None, :]) != 0).any(1)
                unplaced_bad = unplaced_bad + (can & ~hit).sum()
                # not a fault by itself: a node with a free slot it never
                # bid for
                open_left = open_left + can.sum()
            c = torch.as_tensor(np.asarray(fired[n_excl:], np.int64),
                                device=dev)
            c = c[(c >= 0) & (c < J)]
            common_n.index_add_(0, c, torch.ones(len(c), dtype=torch.float64,
                                                 device=dev))
            if i in sampled:
                snaps.append((common_n.to(torch.float32), x_start, ~full,
                              r, n, filled, mr))
            entries.append((n, cost[r], t + run[r], c, t + run[c]))
    ref_load = _node_sums(inp, common_n * cost) + x_load
    got_load = torch.as_tensor(np.asarray(load), device=dev).double()[:N]
    got_cap = torch.as_tensor(np.asarray(rem_cap), device=dev).long()[:N]
    gap = float(((got_load - ref_load).abs()
                 / ref_load.abs().clamp(min=1.0)).max())
    cap_bad = int((got_cap != cap - running).sum())
    excess = 0.0
    if snaps:
        fanned = _node_sums(inp, torch.stack([s[0] for s in snaps],
                                             1).double() * cost[:, None])
        for j, (_c, x_start, open_n, r, n, filled, mr) in enumerate(snaps):
            start = fanned[j] + x_start
            excess = max(excess, _bid_excess(inp, start, open_n, r, n),
                         _unplaced_excess(inp, start, open_n, filled, mr,
                                          r, n))
    checks = [("due_mismatch_seconds", float(len(bad_seconds)), 0.0),
              ("ineligible_placements", float(ineligible), 0.0),
              ("over_capacity_placements", float(over), 0.0),
              ("unplaced_with_capacity", float(unplaced_bad), 0.0),
              ("capacity_mismatch_nodes", float(cap_bad), 0.0),
              ("load_rel_gap", gap, float(limits["load_rel_gap"])),
              ("bid_excess", excess, float(limits["bid_excess"]))]
    info = {"unplaced_share": int(unplaced) / max(1, excl),
            "unplaced_with_a_free_eligible_node_share":
                int(open_left) / max(1, int(unplaced)),
            "full_node_second_share": int(full_seconds) / max(1, n_win * W),
            "running_slots_share": float(running.sum()) / float(cap.sum())}
    return checks, len(seconds), len(bad_seconds), info


def _unplaced_excess(inp: gen.PlannerInputs, start_load: torch.Tensor,
                     open_n: torch.Tensor, filled: torch.Tensor,
                     rows: torch.Tensor, placed_rows: torch.Tensor,
                     placed_nodes: torch.Tensor) -> float:
    """How far the nodes that refused one second's unplaced fires lie
    above the least load those fires could still bid for, as a share of
    the mean node load (the measure of
    :func:`portbench.reference._bid_excess`).

    ``start_load`` [N] float64 is each node's load when the second's bids
    start, ``open_n`` the nodes open at the second's end, ``filled`` those
    that filled in it; ``rows`` the unplaced fires, ``placed_*`` the
    second's placements.  A fire's last bid went to its least-loaded
    eligible node open in that round, on loads that the earlier rounds
    raised by at most ``a`` (the most the second's placements added to one
    node), and was refused only when that node filled.  So the least start
    load among the fire's eligible nodes that filled lies above the least
    among those still open by at most ``a``.  The excess over that, of the
    worst fire that has both: 0 in exact arithmetic."""
    if len(rows) == 0:
        return 0.0
    N = inp.nodes
    added = torch.zeros(N, dtype=torch.float64, device=start_load.device)
    added.index_add_(0, placed_nodes, inp.cost[placed_rows].double())
    a = float(added.max()) if len(placed_rows) else 0.0
    worst = 0.0
    for s in range(0, len(rows), 4096):
        bits = _unpack(inp.elig, rows[s:s + 4096], N)
        least = torch.where(bits & open_n[None, :], start_load[None, :],
                            float("inf")).min(1).values
        took = torch.where(bits & filled[None, :], start_load[None, :],
                           float("inf")).min(1).values
        both = torch.isfinite(least) & torch.isfinite(took)
        if bool(both.any()):
            worst = max(worst, float((took - least)[both].max()))
    return max(0.0, worst - a) / max(1.0, float(start_load.mean()))


# the controls: the reference in the program's place with one guarantee
# broken (keyword arguments of control_binpack), and the check that has to
# refuse each
CONTROLS = {
    # every exclusive fire bids over all its eligible nodes, full or not,
    # and every bid is taken
    "ignore_cap": ({"ignore_cap": True}, "over_capacity_placements"),
    # every eighth release batch is dropped: its slots and load stay taken
    "lost_release": ({"lost_every": 8}, "capacity_mismatch_nodes"),
    # releases give the slots back and leave the load
    "stale_load": ({"stale_load": True}, "load_rel_gap"),
    # node loads held in bfloat16, below the float32 the configuration
    # states
    "bf16_load": ({"load_dtype": torch.bfloat16}, "load_rel_gap"),
    # loads kept in float32, the bid taken over them rounded to bfloat16
    "bf16_bid": ({"bid_dtype": torch.bfloat16}, "bid_excess"),
    # each exclusive fire on its first eligible open node: no balancing
    "first_node": ({"first_eligible": True}, "bid_excess"),
    # every other exclusive placement of a second dropped: the fire left
    # unplaced, its slot not taken
    "drop_half": ({"drop_half": True}, "unplaced_with_capacity"),
}


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the entries of equal key, in index order."""
    K = key.shape[0]
    sk, order = torch.sort(key, stable=True)
    pos = torch.arange(K, device=key.device)
    first = torch.ones(K, dtype=torch.bool, device=key.device)
    first[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    return rank


def control_binpack(inp: gen.PlannerInputs, bucket: Tuple[int, int],
                    W: int, start: int, n_windows: int, pipeline: int,
                    run: torch.Tensor, rounds: int = 2,
                    load_dtype=torch.float32, bid_dtype=None,
                    first_eligible: bool = False, ignore_cap: bool = False,
                    lost_every: int = 0, stale_load: bool = False,
                    drop_half: bool = False):
    """The reference in the program's place over ``n_windows`` windows of
    W seconds from ``start``, released by the cell's rule with
    ``pipeline`` windows in flight.  Each second: the due rows, the Common
    ones fanned out, then ``rounds`` rounds in which each unplaced
    exclusive row bids for its least-loaded eligible open node and each
    node takes its bids in row order up to its free slots.  The variants
    break one guarantee each (:data:`CONTROLS`).  Returns (seconds,
    releases, load, rem_cap) in the runner's report format."""
    dev = inp.elig.device
    N = inp.nodes
    kx, kc = bucket
    run = run.to(dev)
    load = torch.zeros(N, dtype=load_dtype, device=dev)
    rem = inp.node_cap.to(torch.int64).clone()
    releases = closed_loop(n_windows, start, W, pipeline)
    pending = _Pending(dev)
    entries: List[tuple] = []
    added = 0
    out: List[Second] = []
    for k, (e_k, g_k) in enumerate(releases):
        g_k = min(g_k, len(entries))
        if g_k > added:
            pending.add(entries[added:g_k])
            entries[added:g_k] = [None] * (g_k - added)
            added = g_k
        xn, xc, cr = pending.take(e_k)
        if not (lost_every and k % lost_every == lost_every - 1):
            rem += torch.bincount(xn, minlength=N)
            if not stale_load:
                back = torch.zeros(N, dtype=torch.float32, device=dev)
                back.index_add_(0, xn, xc.float())
                if len(cr):
                    back += _fanout(inp, cr)
                load = (load.float() - back).to(load_dtype)
        due = due_matrix(inp, [e_k + w for w in range(W)])
        for w in range(W):
            t = e_k + w
            xr = torch.nonzero(due[:, w] & inp.exclusive).flatten()
            cr_due = torch.nonzero(due[:, w] & ~inp.exclusive).flatten()
            nx, nc = min(len(xr), kx), min(len(cr_due), kc)
            x, c = xr[:nx], cr_due[:nc]
            add = _fanout(inp, c)
            bid = load.float() + add
            choice = torch.full((nx,), -1, dtype=torch.int64, device=dev)
            for _ in range(rounds):
                todo = torch.nonzero(choice < 0).flatten()
                if not len(todo):
                    break
                view = bid if bid_dtype is None else bid.to(bid_dtype).float()
                open_n = torch.ones_like(rem, dtype=torch.bool) \
                    if ignore_cap else rem > 0
                pick = torch.full((len(todo),), -1, dtype=torch.int64,
                                  device=dev)
                for s in range(0, len(todo), 4096):
                    bits = _unpack(inp.elig, x[todo[s:s + 4096]], N) \
                        & open_n[None, :]
                    if first_eligible:
                        arg = bits.int().argmax(1)
                        best = torch.where(bits.any(1), 0.0, float("inf"))
                    else:
                        best, arg = torch.where(bits, view[None, :],
                                                float("inf")).min(1)
                    pick[s:s + 4096] = torch.where(torch.isfinite(best),
                                                   arg, -1)
                cand = pick >= 0
                key = torch.where(cand, pick, N)
                take = cand if ignore_cap else cand & (
                    _rank(key) < rem[pick.clamp(min=0)])
                got, nodes = todo[take], pick[take]
                choice[got] = nodes
                rem -= torch.bincount(nodes, minlength=N)
                bid = bid.index_add(0, nodes, inp.cost[x[got]])
            if drop_half:
                lost = torch.nonzero(choice >= 0).flatten()[1::2]
                rem += torch.bincount(choice[lost], minlength=N)
                choice[lost] = -1
            ok = choice >= 0
            placed = torch.zeros(N, dtype=torch.float32, device=dev)
            placed.index_add_(0, choice[ok], inp.cost[x[ok]])
            load = (load.float() + add + placed).to(load_dtype)
            fired = torch.cat([x, c]).to(torch.int32).cpu().numpy()
            assigned = torch.cat([choice, torch.full((nc,), -1, device=dev,
                                                     dtype=torch.int64)])
            out.append((t, fired, assigned.to(torch.int32).cpu().numpy(), nx,
                        len(xr) + len(cr_due),
                        max(0, len(xr) - kx) + max(0, len(cr_due) - kc)))
            xs, ns = x[ok], choice[ok]
            entries.append((ns, inp.cost[xs].double(), t + run[xs], c,
                            t + run[c]))
    return out, releases, load.float().cpu().numpy(), rem.cpu().numpy()


def _fanout(inp: gen.PlannerInputs, rows: torch.Tensor) -> torch.Tensor:
    """[N] f32: the rows' costs on every node each is eligible for."""
    N = inp.nodes
    add = torch.zeros(N, dtype=torch.float32, device=inp.elig.device)
    for s in range(0, len(rows), 4096):
        add += inp.cost[rows[s:s + 4096]] @ _unpack(
            inp.elig, rows[s:s + 4096], N).float()
    return add
