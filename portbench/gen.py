"""Inputs drawn from ``--seed``: the one general generator of every traffic
mix.  It imports nothing of the system under test; the cell runners install
what it draws into the program, and the reference draws it again.

The ``planner`` runner's rows (:func:`planner_inputs`): spec families by
share (``@every`` with a period range and a uniform phase, or a literal
six-field cron spec), an exclusive share, costs and the eligibility bits.
Everything is drawn on ``device`` with a ``torch.Generator``, in a few
large calls.  Each quantity has a generator stream of its own, so two mixes
that differ only in, say, the exclusive share draw the same rows, phases
and eligibility for one seed.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

# the epoch the generated @every anchors are taken from (a phase phi of a
# period p anchors the row at ANCHOR_EPOCH + phi)
ANCHOR_EPOCH = 1_700_000_000


def sub_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of one run: ``--seed`` may be any whole
    number, larger than 32 bits or negative."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0])


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


# ------------------------------------------------------------ planner rows

@dataclasses.dataclass
class PlannerInputs:
    """What a planner cell plans, on one device.  ``family`` [J] int8
    indexes ``families``; ``every`` rows fire when
    ``(t - anchor) % period == 0``; cron rows by their spec."""
    families: List[dict]
    family: torch.Tensor      # [J] int8
    is_every: torch.Tensor    # [J] bool
    period: torch.Tensor      # [J] int64, 1 on cron rows
    anchor: torch.Tensor      # [J] int64 epoch seconds, 0 on cron rows
    exclusive: torch.Tensor   # [J] bool
    cost: torch.Tensor        # [J] float32
    elig: torch.Tensor        # [J, N/32] int32 bit patterns
    node_cap: torch.Tensor    # [N] int64

    @property
    def jobs(self) -> int:
        return self.family.shape[0]

    @property
    def nodes(self) -> int:
        return self.node_cap.shape[0]


def planner_inputs(cfg: dict, mix: dict, seed: int, device) -> PlannerInputs:
    """Draw a planner cell's rows from ``seed`` on ``device``.

    ``cfg``: ``jobs``, ``nodes`` (a multiple of 32), ``node_cap``,
    ``eligibility_density`` (1/2: uniform random words), ``cost``
    (``[lo, hi]`` whole numbers, inclusive).  ``mix``: ``families`` (each
    ``{"share", "every_s": [lo, hi)}`` or ``{"share", "cron": spec}``) and
    ``exclusive_share``."""
    J, N = int(cfg["jobs"]), int(cfg["nodes"])
    if N % 32:
        raise ValueError(f"nodes {N} is not a multiple of 32")
    if float(cfg.get("eligibility_density", 0.5)) != 0.5:
        raise ValueError("only density 1/2 (uniform words) is drawn")
    dev = torch.device(device)
    fams = list(mix["families"])
    shares = torch.tensor([float(f["share"]) for f in fams], dtype=torch.float64)
    if abs(float(shares.sum()) - 1.0) > 1e-9:
        raise ValueError(f"family shares sum to {float(shares.sum())}, not 1")
    u = torch.rand(J, generator=_gen(seed, 1, dev), device=dev,
                   dtype=torch.float64)
    edges = torch.cumsum(shares, 0)[:-1].to(dev)
    family = torch.bucketize(u, edges, right=True).to(torch.int8)
    is_every = torch.zeros(J, dtype=torch.bool, device=dev)
    period = torch.ones(J, dtype=torch.int64, device=dev)
    anchor = torch.zeros(J, dtype=torch.int64, device=dev)
    g = _gen(seed, 2, dev)
    for i, f in enumerate(fams):
        if "every_s" not in f:
            continue
        lo, hi = (int(x) for x in f["every_s"])
        rows = family == i
        p = torch.randint(lo, hi, (J,), generator=g, device=dev)
        phase = torch.randint(0, 1 << 30, (J,), generator=g, device=dev) % p
        is_every |= rows
        period = torch.where(rows, p, period)
        anchor = torch.where(rows, ANCHOR_EPOCH + phase, anchor)
    exclusive = torch.rand(J, generator=_gen(seed, 3, dev), device=dev) \
        < float(mix["exclusive_share"])
    lo, hi = (int(x) for x in cfg.get("cost", [1, 1]))
    cost = torch.randint(lo, hi + 1, (J,), generator=_gen(seed, 4, dev),
                         device=dev).to(torch.float32)
    elig = torch.randint(-2**31, 2**31, (J, N // 32), dtype=torch.int32,
                         generator=_gen(seed, 5, dev), device=dev)
    node_cap = torch.full((N,), int(cfg["node_cap"]), dtype=torch.int64,
                          device=dev)
    return PlannerInputs(fams, family, is_every, period, anchor, exclusive,
                         cost, elig, node_cap)
