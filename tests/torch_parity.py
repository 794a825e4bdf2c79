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
from cronsun_tpu_torch.ops.schedule_table import DTYPES


def bits(arr: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 bit-pattern tensor (the port's form)."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32))


def jax_table(cols: dict) -> JaxTable:
    return JaxTable(**{k: jnp.asarray(cols[k]) for k in DTYPES})


def jax_planner_from_state(state: dict, **kw) -> JaxPlanner:
    J, w32 = state["elig"].shape
    p = JaxPlanner(job_capacity=J, node_capacity=w32 * 32, **kw)
    p.set_table(jax_table(state))
    p.elig = jnp.asarray(state["elig"])
    p.exclusive = jnp.asarray(state["exclusive"])
    p.cost = jnp.asarray(state["cost"])
    p.load = jnp.asarray(state["load"])
    p.rem_cap = jnp.asarray(state["rem_cap"])
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
    """Carried load (exact: integer costs) and rem_cap equal."""
    np.testing.assert_array_equal(np.asarray(jp.load), tp.load.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(jp.rem_cap),
                                  tp.rem_cap.cpu().numpy())
