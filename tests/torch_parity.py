"""Shared helpers for the differential tests of the PyTorch port.

One numpy state made from a seed goes to the JAX package (as ``jnp``
arrays, on the CPU) and to the port (``device="cpu"``); results are compared
as numpy arrays.
"""

import numpy as np
import jax.numpy as jnp
import torch

from cronsun_tpu.ops.planner import TickPlanner as JaxPlanner
from cronsun_tpu.ops.schedule_table import ScheduleTable as JaxTable
from cronsun_tpu_torch.convert import PLANNER_FIELDS, planner_from_numpy
from cronsun_tpu_torch.ops.schedule_table import DTYPES


def bits(arr: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 bit-pattern tensor (the port's form)."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32))


def jax_table(cols: dict) -> JaxTable:
    return JaxTable(**{k: jnp.asarray(cols[k]) for k in DTYPES})


def jax_planner_from_state(state: dict, **kw) -> JaxPlanner:
    """The JAX planner holding ``state`` (the convert module's layout):
    table, planner arrays, dep and tenant columns, the row->tenant map and
    both switches."""
    J, w32 = state["elig"].shape
    p = JaxPlanner(job_capacity=J, node_capacity=w32 * 32,
                   tenant_capacity=len(state["tb_rate"]), **kw)
    p.set_table(jax_table(state))
    for name, dt in PLANNER_FIELDS.items():
        setattr(p, name, jnp.asarray(np.asarray(state[name], dt)))
    p.set_row_tenants(np.arange(J), state["row_tenant"])
    p.set_dep_enabled(bool(state["dep_enabled"]))
    p.set_tenants_enabled(bool(state["tenants_enabled"]))
    return p


PLAN_FIELDS = ("epoch_s", "fired", "assigned", "overflow", "total_fired",
               "n_excl", "tenant_throttled", "tenant_shed")


def assert_plans_equal(ref, got) -> None:
    """Every TickPlan field equal, second by second (exact)."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        for f in PLAN_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"{f} @ {a.epoch_s}")
            else:
                assert x == y, (f, a.epoch_s, x, y)


def assert_state_equal(jp: JaxPlanner, tp) -> None:
    """Carried load (exact: integer costs), rem_cap, dep_last_fire and
    tb_tokens equal."""
    for name in ("load", "rem_cap", "dep_last_fire", "tb_tokens"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).cpu().numpy(),
                                      err_msg=name)


class PlannerPair:
    """The JAX planner and the port planner (on the CPU) from one state,
    driven alike: any method runs on both (the port's result is returned),
    and every window's plans and carried state are compared."""

    def __init__(self, state: dict, **kw):
        self.jp = jax_planner_from_state(state, **kw)
        self.tp = planner_from_numpy(state, device="cpu", **kw)

    def __getattr__(self, name):
        def both(*a, **kw):
            getattr(self.jp, name)(*a, **kw)
            return getattr(self.tp, name)(*a, **kw)
        return both

    def plan_window(self, t, W, **kw):
        ref = self.jp.plan_window(t, W, **kw)
        got = self.tp.plan_window(t, W, **kw)
        assert_plans_equal(ref, got)
        assert_state_equal(self.jp, self.tp)
        return got
