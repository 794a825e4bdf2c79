"""Shared helpers for the differential tests of the PyTorch port.

One numpy state made from a seed goes to the JAX package (as ``jnp``
arrays, on the CPU) and to the port (``device="cpu"``); results are compared
as numpy arrays.
"""

import contextlib
import signal

import numpy as np
import jax.numpy as jnp
import pytest
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


@contextlib.contextmanager
def time_limit(seconds: int, what: str):
    """Raise ``TimeoutError`` in the test's (main) thread when the block
    runs past ``seconds``: a per-test time limit for long differential
    runs (SIGALRM; the test process runs tests on its main thread)."""
    def expire(signum, frame):
        raise TimeoutError(f"{what} ran past its {seconds} s limit")
    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


# ---- mesh planners ---------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's tests with one intra-op torch thread.  The mesh
    planners launch many small ops per shard; with a thread per core in each
    of several test processes, the pool's waiting threads oversubscribe
    the cores and a test runs 20x slower than alone.  A module imports
    this fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_state(J: int, N: int, seed: int, frac: bool = False) -> dict:
    """A mesh planner state in the convert module's layout (table columns,
    ``elig``, ``exclusive``, ``cost``, ``load``, ``rem_cap``), with the
    shape of ``tests/test_mesh_bidding.py``'s ``_random_state``: 30% of the
    jobs fire every second, the rest at one second of the minute; each is
    eligible on 1-5 random nodes, 70% exclusive; costs integers in [1, 3]
    (uniform in [0.5, 3.5] with ``frac``); capacities 1-3, so the
    rationing bites."""
    from cronsun_tpu_torch.ops.schedule_table import _rows_to_numpy, make_row
    rng = np.random.default_rng(seed)
    specs = ["* * * * * *"] + [f"{s} * * * * *" for s in range(60)]
    rows = _rows_to_numpy([make_row(s) for s in specs], len(specs))
    pick = np.where(rng.random(J) < 0.3, 0, 1 + rng.integers(0, 60, J))
    state = {k: np.ascontiguousarray(rows[k][pick], dtype=dt)
             for k, dt in DTYPES.items()}
    elig = np.zeros((J, N // 32), np.uint32)
    cols = rng.integers(0, N, (J, 5))
    take = np.arange(5)[None, :] < rng.integers(1, 6, J)[:, None]
    jj = np.broadcast_to(np.arange(J)[:, None], cols.shape)[take]
    cc = cols[take]
    np.bitwise_or.at(elig, (jj, cc // 32),
                     (np.uint32(1) << (cc % 32).astype(np.uint32)))
    state["elig"] = elig
    state["exclusive"] = rng.random(J) < 0.7
    state["cost"] = (rng.uniform(0.5, 3.5, J) if frac
                     else rng.integers(1, 4, J)).astype(np.float32)
    state["load"] = np.zeros(N, np.float32)
    state["rem_cap"] = rng.integers(1, 4, N).astype(np.int32)
    return state


def jax_mesh_planner(cls, mesh, state: dict, **kw):
    """A JAX mesh planner of ``cls`` on ``mesh`` holding ``state``."""
    J, w32 = state["elig"].shape
    p = cls(mesh, job_capacity=J, node_capacity=w32 * 32, **kw)
    assert (p.J, p.N) == (J, w32 * 32), (p.J, p.N)
    p.set_table(jax_table(state))
    p.set_eligibility(state["elig"])
    p.set_job_meta_full(state["exclusive"], state["cost"])
    p.set_node_capacity_full(state["rem_cap"])
    p.load = state["load"]
    return p


def port_mesh_planner(cls, mesh, state: dict, **kw):
    """The port's mesh planner of ``cls`` on ``mesh`` holding ``state``."""
    from cronsun_tpu_torch.convert import install_mesh_state
    J, w32 = state["elig"].shape
    p = cls(mesh, job_capacity=J, node_capacity=w32 * 32, **kw)
    assert (p.J, p.N) == (J, w32 * 32), (p.J, p.N)
    install_mesh_state(p, state)
    return p


def cpu_mesh(dj: int, dn: int = 0):
    """A port mesh of CPU shards: 1-D of ``dj``, or ``dj`` x ``dn``."""
    from cronsun_tpu_torch.parallel.mesh import Mesh
    return Mesh([["cpu"] * dn] * dj if dn else ["cpu"] * dj)


def assert_mesh_state_equal(jp, tp) -> None:
    """Carried load and rem_cap equal, exactly."""
    for name in ("load", "rem_cap"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).cpu().numpy(),
                                      err_msg=name)
