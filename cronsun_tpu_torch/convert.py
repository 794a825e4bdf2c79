"""Carry planner state across, as numpy arrays.

``state`` holds what the JAX planner (``cronsun_tpu.ops.planner.TickPlanner``)
keeps on its device, in its dtypes:

- the 20 schedule-table columns (``sec_lo`` ... ``jitter``, ``dep_cols``
  [J, 8]);
- ``elig`` [J, W32] uint32 bit-packed eligibility;
- ``exclusive`` [J] bool, ``cost`` [J] f32, ``load`` [N] f32 and
  ``rem_cap`` [N] int32.

uint32 arrays enter the port as ``arr.view(np.int32)`` bit patterns and
leave it viewed back as uint32, so a state round-trips bit for bit.  The
planner copies every array; it never aliases the caller's memory.
"""

from __future__ import annotations

import numpy as np

from .device import DeviceLike
from .ops.planner import TickPlanner
from .ops.schedule_table import (DTYPES, column_numpy, column_tensor,
                                 table_from_numpy, table_to_numpy)

# planner arrays beside the table, with their dtypes in the JAX planner
PLANNER_FIELDS = dict(elig=np.uint32, exclusive=np.bool_, cost=np.float32,
                      load=np.float32, rem_cap=np.int32)


def planner_from_numpy(state: dict, *, device: DeviceLike = None,
                       **planner_kwargs) -> TickPlanner:
    """A port planner holding ``state``; ``planner_kwargs`` go to
    :class:`TickPlanner` (``rounds``, ``max_fire_bucket``, ``tz``)."""
    missing = (set(DTYPES) | set(PLANNER_FIELDS)) - set(state)
    if missing:
        raise ValueError(f"missing state arrays: {sorted(missing)}")
    J, w32 = state["elig"].shape
    N = state["load"].shape[0]
    p = TickPlanner(job_capacity=J, node_capacity=N, device=device,
                    **planner_kwargs)
    if (p.J, p.N) != (J, N) or N != 32 * w32:
        raise ValueError(f"state shape J={J}, N={N}, W32={w32} is not a "
                         f"planner shape (J a power of two, N = 32 * W32)")
    p.set_table(table_from_numpy({k: state[k] for k in DTYPES}, p.device))
    for name, dt in PLANNER_FIELDS.items():
        setattr(p, name, column_tensor(state[name], dt, p.device))
    return p


def planner_to_numpy(planner: TickPlanner) -> dict:
    """Host copies of ``planner``'s state in the JAX planner's dtypes."""
    out = table_to_numpy(planner.table)
    for name, dt in PLANNER_FIELDS.items():
        out[name] = column_numpy(getattr(planner, name), dt)
    return out
