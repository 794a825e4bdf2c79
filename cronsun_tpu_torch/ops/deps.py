"""Workflow DAG plane: dependency-trigger evaluation for the windowed plan
(counterpart of ``cronsun_tpu/ops/deps.py``).

A dep-triggered row fires once every upstream column's completion epoch
passes its own ``last_fire``.  Upstream references are the table's
``dep_cols`` [J, MAX_DEPS] block; the mutable per-row state sits beside the
planner's load and capacity:

- ``succ``/``fail`` [J] int32 — the newest completed round's scheduled epoch
  (framework-relative) per outcome, folded by monotone max;
- ``last_fire`` [J] int32 — the epoch the row last fired or consumed a
  skipped round, carried through the window's seconds;
- ``block`` [J] bool — the host-computed max_in_flight gate.

Misfire policies per upstream round: POLICY_FIRE — any completed round
satisfies; POLICY_HOLD — only a success does; POLICY_SKIP (default) — a
round whose upstreams all completed but at least one's latest outcome is a
failure is consumed (last_fire advances, no fire).

``NEVER`` is ``int32.min``: every compare stays in int32 and no epoch is
ever subtracted, so the sentinel cannot wrap.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set, Tuple

import numpy as np
import torch

from .schedule_table import DEP_EMPTY, ScheduleTable

POLICY_SKIP = 0
POLICY_FIRE = 1
POLICY_HOLD = 2

POLICY_BY_NAME = {"skip": POLICY_SKIP, "fire": POLICY_FIRE,
                  "hold": POLICY_HOLD}
POLICY_NAMES = {v: k for k, v in POLICY_BY_NAME.items()}

# "never completed" sentinel: below any real framework-relative epoch and
# any last_fire anchor
NEVER = int(np.iinfo(np.int32).min)


def dep_ready(table: ScheduleTable, succ: torch.Tensor, fail: torch.Tensor,
              block: torch.Tensor, last_fire: torch.Tensor):
    """[J] dep-trigger decisions at one instant: ``(fire, consume,
    round_max)``.

    A slot is satisfied when it is padding (DEP_EMPTY) or its upstream's
    epoch passed ``last_fire``; DEP_BROKEN slots never satisfy.  ``consume``
    marks POLICY_SKIP rows whose round completed with a failure.
    ``round_max`` is the newest upstream epoch the decision consumed: the
    caller advances last_fire to ``max(tick, round_max)``, so one visible
    backlog gives one fire."""
    cols = table.dep_cols                           # [J, D] int32
    valid = cols >= 0
    up = cols.clamp(min=0).to(torch.int64)
    s = succ[up]                                    # [J, D]
    f = fail[up]
    latest = torch.maximum(s, f)
    lf = last_fire[:, None]
    pad_ok = cols == DEP_EMPTY                      # DEP_BROKEN stays False
    all_succ = torch.where(valid, s > lf, pad_ok).all(dim=1)
    all_any = torch.where(valid, latest > lf, pad_ok).all(dim=1)
    # an upstream's round ended in failure iff its latest outcome is a
    # failure newer than both our last fire and its own latest success
    has_fail = (valid & (f > lf) & (f > s)).any(dim=1)
    live = (table.has_dep & valid.any(dim=1) & table.active & ~table.paused
            & ~block)
    pol = table.dep_policy
    fire = torch.where(pol == POLICY_FIRE, all_any,
                       torch.where(pol == POLICY_HOLD, all_succ,
                                   all_any & ~has_fail))
    consume = (pol == POLICY_SKIP) & all_any & has_fail
    round_max = torch.where(valid, latest, NEVER).amax(dim=1)
    return fire & live, consume & live, round_max


class ReferenceDagEvaluator:
    """Pure-Python reference of the dep-trigger semantics.

    ``deps``: {row: (upstream_cols, policy)} where upstream_cols entries are
    table rows or DEP_BROKEN; rows absent from ``deps`` never dep-fire."""

    def __init__(self, deps: Dict[int, Tuple[List[int], int]],
                 last_fire: Dict[int, int] = None):
        self.deps = {r: (list(c), p) for r, (c, p) in deps.items()}
        self.succ: Dict[int, int] = {}
        self.fail: Dict[int, int] = {}
        self.last_fire: Dict[int, int] = dict(last_fire or {})
        self.blocked: Set[int] = set()

    def complete(self, row: int, epoch: int, ok: bool):
        """Fold one completion event (monotone max, like the device)."""
        d = self.succ if ok else self.fail
        d[row] = max(d.get(row, NEVER), epoch)

    def tick(self, t: int, live_rows: Iterable[int] = None) -> List[int]:
        """Dep fires at instant ``t`` (sorted rows); advances last_fire for
        fires AND consumed skip-policy rounds."""
        PF, PH, PS = POLICY_FIRE, POLICY_HOLD, POLICY_SKIP
        fired = []
        for row, (cols, pol) in sorted(self.deps.items()):
            if live_rows is not None and row not in live_rows:
                continue
            if row in self.blocked or not cols:
                continue
            lf = self.last_fire.get(row, 0)
            sat_succ = sat_any = True
            has_fail = False
            round_max = NEVER
            for c in cols:
                if c == DEP_EMPTY:
                    continue
                if c < 0:                       # DEP_BROKEN
                    sat_succ = sat_any = False
                    break
                s = self.succ.get(c, NEVER)
                f = self.fail.get(c, NEVER)
                sat_succ &= s > lf
                sat_any &= max(s, f) > lf
                has_fail |= f > lf and f > s
                round_max = max(round_max, s, f)
            if pol == PF:
                fire, consume = sat_any, False
            elif pol == PH:
                fire, consume = sat_succ, False
            else:
                if pol != PS:
                    raise ValueError(f"unknown dep policy {pol}")
                fire = sat_any and not has_fail
                consume = sat_any and has_fail
            if fire:
                fired.append(row)
            if fire or consume:
                # consume the whole visible backlog (see dep_ready)
                self.last_fire[row] = max(t, round_max)
        return fired
