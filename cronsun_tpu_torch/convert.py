"""Carry planner state across, as numpy arrays.

``state`` holds what the JAX planner (``cronsun_tpu.ops.planner.TickPlanner``)
keeps on its device, in its dtypes:

- the 20 schedule-table columns (``sec_lo`` ... ``jitter``, ``dep_cols``
  [J, 8]);
- ``elig`` [J, W32] uint32 bit-packed eligibility;
- ``exclusive`` [J] bool, ``cost`` [J] f32, ``load`` [N] f32 and
  ``rem_cap`` [N] int32;
- the dep arm's ``dep_succ``/``dep_fail``/``dep_last_fire`` [J] int32 and
  ``dep_block`` [J] bool;
- the tenant arm's ``tb_rate``/``tb_burst``/``tb_weight``/``tb_tokens``
  [T] f32 and ``tb_limited`` [T] bool;

and, from the JAX planner's host side, ``row_tenant`` [J] int32 (the
row->tenant snapshot admission orders rows by) and the two switches
``dep_enabled`` and ``tenants_enabled`` (numpy bools), so one state arms
both planners alike.

uint32 arrays enter the port as ``arr.view(np.int32)`` bit patterns and
leave it viewed back as uint32, so a state round-trips bit for bit.  The
planner copies every array; it never aliases the caller's memory.

A mesh planner's state is the global arrays its shards hold, as the JAX
mesh planner's ``_fetch`` returns them: the table columns, ``elig``,
``exclusive``, ``cost``, ``load`` and ``rem_cap`` (:data:`MESH_FIELDS`);
:func:`install_mesh_state` puts it into a port mesh planner.
"""

from __future__ import annotations

import numpy as np

from .device import DeviceLike
from .ops.planner import TickPlanner
from .ops.schedule_table import (DTYPES, column_numpy, column_tensor,
                                 table_from_numpy, table_to_numpy)

# planner arrays beside the table, with their dtypes in the JAX planner
PLANNER_FIELDS = dict(
    elig=np.uint32, exclusive=np.bool_, cost=np.float32, load=np.float32,
    rem_cap=np.int32, dep_succ=np.int32, dep_fail=np.int32,
    dep_last_fire=np.int32, dep_block=np.bool_, tb_rate=np.float32,
    tb_burst=np.float32, tb_limited=np.bool_, tb_weight=np.float32,
    tb_tokens=np.float32)

# host-side state: the row->tenant snapshot and the arms' switches
HOST_FIELDS = ("row_tenant", "dep_enabled", "tenants_enabled")

# a mesh planner's arrays beside the table (it has no arms)
MESH_FIELDS = ("elig", "exclusive", "cost", "load", "rem_cap")


def planner_from_numpy(state: dict, *, device: DeviceLike = None,
                       **planner_kwargs) -> TickPlanner:
    """A port planner holding ``state``; ``planner_kwargs`` go to
    :class:`TickPlanner` (``rounds``, ``max_fire_bucket``, ``tz``).  The
    tenant capacity is the length of the ``tb_*`` columns."""
    missing = (set(DTYPES) | set(PLANNER_FIELDS) | set(HOST_FIELDS)) - set(state)
    if missing:
        raise ValueError(f"missing state arrays: {sorted(missing)}")
    J, w32 = state["elig"].shape
    N = state["load"].shape[0]
    T = state["tb_rate"].shape[0]
    p = TickPlanner(job_capacity=J, node_capacity=N, tenant_capacity=T,
                    device=device, **planner_kwargs)
    if (p.J, p.N, p.T) != (J, N, T) or N != 32 * w32:
        raise ValueError(f"state shape J={J}, N={N}, W32={w32}, T={T} is not "
                         f"a planner shape (J and T powers of two, "
                         f"N = 32 * W32)")
    p.set_table(table_from_numpy({k: state[k] for k in DTYPES}, p.device))
    for name, dt in PLANNER_FIELDS.items():
        setattr(p, name, column_tensor(state[name], dt, p.device))
    p.set_row_tenants(np.arange(J), state["row_tenant"])
    p.set_dep_enabled(bool(state["dep_enabled"]))
    p.set_tenants_enabled(bool(state["tenants_enabled"]))
    return p


def planner_to_numpy(planner: TickPlanner) -> dict:
    """Host copies of ``planner``'s state in the JAX planner's dtypes."""
    out = table_to_numpy(planner.table)
    for name, dt in PLANNER_FIELDS.items():
        out[name] = column_numpy(getattr(planner, name), dt)
    out["row_tenant"] = planner._tenant_np.copy()
    out["dep_enabled"] = np.bool_(planner.dep_enabled)
    out["tenants_enabled"] = np.bool_(planner.tenants_enabled)
    return out


def install_mesh_state(planner, state: dict) -> None:
    """Install ``state`` (the table columns and :data:`MESH_FIELDS`, the
    global arrays of a JAX mesh planner as numpy) in ``planner``, a port
    mesh planner of the same J and N; each shard takes its part."""
    missing = (set(DTYPES) | set(MESH_FIELDS)) - set(state)
    if missing:
        raise ValueError(f"missing state arrays: {sorted(missing)}")
    planner.set_table(table_from_numpy({k: state[k] for k in DTYPES}, "cpu"))
    planner.set_eligibility(state["elig"])
    planner.set_job_meta_full(state["exclusive"], state["cost"])
    planner.load = state["load"]
    planner.rem_cap = state["rem_cap"]
