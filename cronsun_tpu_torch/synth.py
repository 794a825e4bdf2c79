"""Seeded synthetic planner states, as numpy arrays in the JAX planner's
dtypes (the ``state`` dict of :mod:`cronsun_tpu_torch.convert`).

Used by the differential tests, ``chip_smoke.py`` and benches: one state
from one seed can be handed to the JAX planner and to the port alike.
Distinct specs are parsed once and their rows tiled in numpy, so a
million-row table costs no per-row Python.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .ops.schedule_table import DTYPES, _rows_to_numpy, make_row

# six-field cron specs and @every rows of mixed rates (sec min hour dom month dow)
MIXED_SPECS = (
    "*/5 * * * * *",
    "*/7 * * * * *",
    "0 * * * * *",
    "15,45 * * * * *",
    "*/2 * 9-17 * * Mon-Fri",
    "30 */2 * * * *",
    "0 0 * * * *",
    "*/3 * * 1,15 * ?",
    "*/10 * * ? * 0,6",
    "@every 7s",
    "@every 13s",
    "@every 1m30s",
    "@every 45s",
)


# bench.py's headline @every periods, [lo, hi) seconds
EVERY_PERIODS = (35, 70)


def synth_state(J: int, N: int, *, seed: int,
                specs: Optional[Sequence[str]] = MIXED_SPECS,
                node_cap: int = 4, empty_rows: float = 0.0) -> dict:
    """A planner state of J rows x N nodes (N a multiple of 32).

    ``specs``: each row takes one of them at random (``@every`` rows get a
    uniform random phase over their period).  ``specs=None`` makes every row
    ``@every p`` with p uniform in ``EVERY_PERIODS`` and a uniform
    phase — a steady aggregate fire rate of about J / p per second.
    Eligibility is uniform random bits (density 1/2), with a fraction
    ``empty_rows`` of rows eligible nowhere.  Half the rows are exclusive.
    Costs are integers in [1, 4], so every float sum on the plan path is
    exact.
    """
    if N % 32:
        raise ValueError(f"N={N} must be a multiple of 32")
    rng = np.random.default_rng(seed)
    if specs is None:
        cols = _rows_to_numpy([], J)
        cols["is_every"][:] = True
        cols["active"][:] = True
        period = rng.integers(*EVERY_PERIODS, J)
    else:
        table = _rows_to_numpy([make_row(s) for s in specs], len(specs))
        pick = rng.integers(0, len(specs), J)
        cols = {k: v[pick] for k, v in table.items()}
        period = cols["period"].astype(np.int64)
    cols["period"] = period.astype(np.int32)
    phase = rng.integers(0, 1 << 30, J) % period
    cols["phase_mod"] = np.where(cols["is_every"], phase, 0).astype(np.int32)
    state = {k: np.ascontiguousarray(cols[k], dtype=dt)
             for k, dt in DTYPES.items()}
    w32 = N // 32
    elig = np.frombuffer(rng.bytes(J * w32 * 4), dtype=np.uint32)
    elig = elig.reshape(J, w32).copy()
    elig[rng.random(J) < empty_rows] = 0
    state["elig"] = elig
    state["exclusive"] = rng.random(J) < 0.5
    state["cost"] = rng.integers(1, 5, J).astype(np.float32)
    state["load"] = np.zeros(N, np.float32)
    state["rem_cap"] = np.full(N, node_cap, np.int32)
    return state
