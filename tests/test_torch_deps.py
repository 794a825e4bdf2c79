"""Port vs JAX: the workflow-DAG trigger.  ``dep_ready`` on random dep
blocks, and the planner's dep arm on both planners at once — dep-free
bit-identity armed and disarmed, the first tick and once per round, the
misfire policies, fan-in, the block gate and a broken upstream, the dep
setters, and a randomized differential against the reference evaluator.
Every comparison is exact.  Mirrors tests/test_dag.py:150-281."""

import numpy as np
import pytest
import torch

import cronsun_tpu.ops.deps as jdeps
from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import deps as tdeps
from cronsun_tpu_torch.ops import planner as tplanner
from cronsun_tpu_torch.ops.deps import (NEVER, POLICY_FIRE, POLICY_HOLD,
                                        POLICY_SKIP, ReferenceDagEvaluator)
from cronsun_tpu_torch.ops.schedule_table import (
    DEP_BROKEN, DEP_EMPTY, FRAMEWORK_EPOCH, MAX_DEPS, _rows_to_numpy,
    make_dep_row, make_row, table_from_numpy)
from cronsun_tpu_torch.synth import synth_state
from torch_parity import (PlannerPair, assert_plans_equal, jax_table,  # noqa: F401
                          one_torch_thread)

T0 = 1_753_000_000          # a safely modern epoch, mid-minute
NEVER_CRON = "0 0 0 29 2 ?"  # Feb 29 midnight: never fires in a test


def rel(epoch):
    return epoch - FRAMEWORK_EPOCH


def test_dep_constants_match_jax():
    assert (NEVER, POLICY_SKIP, POLICY_FIRE, POLICY_HOLD) == (
        jdeps.NEVER, jdeps.POLICY_SKIP, jdeps.POLICY_FIRE, jdeps.POLICY_HOLD)
    assert tdeps.POLICY_BY_NAME == jdeps.POLICY_BY_NAME
    assert tdeps.POLICY_NAMES == jdeps.POLICY_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dep_ready_matches_jax(seed):
    """Random dep blocks (empty, broken and live slots, every policy,
    paused/inactive rows), random epochs around last_fire incl. NEVER."""
    rng = np.random.default_rng(seed)
    J = 512
    st = synth_state(J, 32, seed=seed)
    cols = rng.integers(0, J, (J, MAX_DEPS)).astype(np.int32)
    cols[rng.random((J, MAX_DEPS)) < 0.4] = DEP_EMPTY
    cols[rng.random((J, MAX_DEPS)) < 0.03] = DEP_BROKEN
    st["dep_cols"] = cols
    st["has_dep"] = rng.random(J) < 0.8
    st["dep_policy"] = rng.integers(0, 3, J).astype(np.int32)
    st["paused"] = rng.random(J) < 0.05
    st["active"] = rng.random(J) < 0.95
    lf = rng.integers(-50, 50, J).astype(np.int32)
    succ = np.where(rng.random(J) < 0.2, NEVER,
                    rng.integers(-60, 60, J)).astype(np.int32)
    fail = np.where(rng.random(J) < 0.5, NEVER,
                    rng.integers(-60, 60, J)).astype(np.int32)
    block = rng.random(J) < 0.1
    ref = jdeps.dep_ready(jax_table(st), *map(np.asarray,
                                             (succ, fail, block, lf)))
    got = tdeps.dep_ready(table_from_numpy(st, "cpu"),
                          *map(torch.from_numpy, (succ, fail, block, lf)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert np.asarray(ref[0]).any() and np.asarray(ref[1]).any()


def _state(specs, deps=None, J=64, N=32, enable=True):
    """A planner state over ``specs`` rows; ``deps`` = {row: (cols,
    policy)}; the dep arm armed if ``enable``.  Every row Common, eligible
    everywhere, capacity ample — the shape of tests/test_dag.py's
    planner."""
    st = synth_state(J, N, seed=0)
    rows = [make_row(s) for s in specs]
    for r, (cols, pol) in (deps or {}).items():
        rows[r] = make_dep_row(cols, pol)
    st.update(_rows_to_numpy(rows, J))
    st["elig"][:] = 0xFFFFFFFF
    st["exclusive"][:] = False
    st["cost"][:] = 1.0
    st["rem_cap"][:] = 1 << 16
    st["dep_enabled"] = np.bool_(enable)
    return st


def _fires(plans):
    return [sorted(pl.fired.tolist()) for pl in plans]


def test_dep_free_table_bit_identical():
    """Dep-free tables plan the same armed and disarmed, on both
    planners."""
    rng = np.random.default_rng(3)
    specs = [f"*/{int(k)} * * * * *" for k in rng.integers(2, 9, 40)] + \
        [f"@every {int(k)}s" for k in rng.integers(2, 30, 24)]
    a = PlannerPair(_state(specs, enable=False))
    b = PlannerPair(_state(specs))
    for w0 in (T0, T0 + 7, T0 + 61):
        assert_plans_equal(a.plan_window(w0, 4), b.plan_window(w0, 4))


def test_disarmed_step_never_calls_dep_ready(monkeypatch):
    """Disarmed, the step reads no dep tensor: dep_ready is never called,
    and dep_last_fire is not replaced."""
    def boom(*a, **kw):
        raise AssertionError("dep_ready called while disarmed")
    p = planner_from_numpy(_state(["* * * * * *"] * 3 + [NEVER_CRON],
                                  deps={3: ([0], POLICY_SKIP)}, enable=False),
                           device="cpu")
    monkeypatch.setattr(tplanner, "dep_ready", boom)
    lf = p.dep_last_fire
    p.plan_window(T0, 3)
    p.warm_window(T0, 2)
    assert p.dep_last_fire is lf
    p.set_dep_enabled(True)
    with pytest.raises(AssertionError, match="disarmed"):
        p.plan_window(T0 + 3, 1)


def test_dep_fires_first_tick_and_once_per_round():
    # row 0 = upstream (never-firing cron), row 1 depends on it
    p = PlannerPair(_state([NEVER_CRON, NEVER_CRON], deps={1: ([0], POLICY_SKIP)}))
    assert _fires(p.plan_window(T0, 3)) == [[], [], []]
    # round completed at T0 - 1: fires at the first second of the next
    # planned window
    p.set_dep_epochs([0], [rel(T0 - 1)], [NEVER])
    assert _fires(p.plan_window(T0 + 3, 3)) == [[1], [], []]
    assert _fires(p.plan_window(T0 + 6, 3)) == [[], [], []]
    p.set_dep_epochs([0], [rel(T0 + 8)], [NEVER])
    assert _fires(p.plan_window(T0 + 9, 3)) == [[1], [], []]


def test_misfire_policies():
    p = PlannerPair(_state([NEVER_CRON] * 4,
                    deps={1: ([0], POLICY_SKIP), 2: ([0], POLICY_FIRE),
                          3: ([0], POLICY_HOLD)}))
    p.set_dep_epochs([0], [NEVER], [rel(T0 - 1)])      # the round FAILED
    assert _fires(p.plan_window(T0, 2)) == [[2], []]
    p.set_dep_epochs([0], [rel(T0 + 5)], [NEVER])
    assert _fires(p.plan_window(T0 + 6, 2)) == [[1, 2, 3], []]


def test_fan_in_needs_every_upstream():
    p = PlannerPair(_state([NEVER_CRON] * 3, deps={2: ([0, 1], POLICY_SKIP)}))
    p.set_dep_epochs([0], [rel(T0 - 2)], [NEVER])
    assert _fires(p.plan_window(T0, 2)) == [[], []]
    p.set_dep_epochs([1], [rel(T0 - 1)], [NEVER])
    assert _fires(p.plan_window(T0 + 2, 2)) == [[2], []]


def test_dep_block_and_broken_upstream():
    p = PlannerPair(_state([NEVER_CRON] * 3,
                    deps={1: ([0], POLICY_SKIP),
                          2: ([DEP_BROKEN], POLICY_SKIP)}))
    p.set_dep_epochs([0, 1, 2], [rel(T0 - 1)] * 3, [NEVER] * 3)
    p.set_dep_block([1], [True])
    assert _fires(p.plan_window(T0, 2)) == [[], []]
    p.set_dep_block([1], [False])
    assert _fires(p.plan_window(T0 + 2, 2)) == [[1], []]
    assert _fires(p.plan_window(T0 + 60, 4)) == [[], [], [], []]


def test_dep_setters_and_state_round_trip():
    """Monotone-max folds (scalars broadcast), row resets to a
    registration anchor, and dep_state/set_dep_state, against JAX."""
    p = PlannerPair(_state([NEVER_CRON] * 4, deps={3: ([0, 1, 2], POLICY_FIRE)}))
    p.set_dep_epochs([0, 1, 1], [5, 9, 7], [NEVER, 3, 11])
    p.set_dep_epochs([0, 2], [4, 6], NEVER)          # older: no change on 0
    for k, v in p.jp.dep_state().items():
        np.testing.assert_array_equal(v, p.tp.dep_state()[k], err_msg=k)
        assert p.tp.dep_state()[k].dtype == v.dtype
    assert p.tp.dep_state()["succ"][:3].tolist() == [5, 9, 6]
    p.reset_dep_rows([1], last_fire_rel=rel(T0))
    p.set_dep_block([0, 3], True)
    saved = p.tp.dep_state()
    p.set_dep_epochs([0], [rel(T0 + 5)], [NEVER])
    p.set_dep_state(**saved)
    for k, v in p.jp.dep_state().items():
        np.testing.assert_array_equal(v, p.tp.dep_state()[k], err_msg=k)
    assert p.tp.dep_state()["last_fire"][1] == rel(T0)
    p.set_dep_block([3], False)
    p.plan_window(T0 + 10, 2)


def test_randomized_differential_vs_reference():
    """Random layered DAGs, completion streams (success and failure),
    policies, window-carried last_fire: both planners equal each other and
    the pure-Python reference evaluator."""
    rng = np.random.default_rng(11)
    for trial in range(4):
        n = 24
        deps = {}
        for row in range(6, n):
            k = int(rng.integers(1, min(4, row)))
            ups = rng.choice(row, size=k, replace=False).tolist()
            deps[row] = (ups, int(rng.integers(0, 3)))
        p = PlannerPair(_state([NEVER_CRON] * n, deps=deps))
        ref = ReferenceDagEvaluator(deps)
        t = T0
        for it in range(10):
            for _ in range(int(rng.integers(1, 6))):
                row = int(rng.integers(0, n))
                ok = bool(rng.random() < 0.7)
                ev = rel(t - int(rng.integers(1, 3)))
                p.set_dep_epochs([row], [ev if ok else NEVER],
                                 [NEVER if ok else ev])
                ref.complete(row, ev, ok)
            W = int(rng.integers(1, 4))
            plans = p.plan_window(t, W)
            for w in range(W):
                assert sorted(plans[w].fired.tolist()) == ref.tick(rel(t + w)), \
                    (trial, it, w)
            t += W


def test_replan_writes_last_fire_back():
    """An overflow replan (sla_bucket set) installs dep_last_fire, as the
    JAX planner does, so a replanned dep fire does not fire again."""
    p = PlannerPair(_state([NEVER_CRON, NEVER_CRON], deps={1: ([0], POLICY_SKIP)}))
    p.set_dep_epochs([0], [rel(T0 + 3)], [NEVER])
    assert _fires(p.plan_window(T0, 1, sla_bucket=2048)) == [[1]]
    assert p.tp.dep_last_fire[1] == rel(T0 + 3)
    assert _fires(p.plan_window(T0 + 1, 2)) == [[], []]


def test_reference_evaluator_matches_jax_copy():
    deps = {2: ([0, 1], POLICY_SKIP), 3: ([2, DEP_BROKEN], POLICY_FIRE),
            4: ([0], POLICY_HOLD)}
    a, b = ReferenceDagEvaluator(deps), jdeps.ReferenceDagEvaluator(deps)
    for t, row, ok in ((5, 0, True), (6, 1, False), (9, 1, True),
                       (12, 0, False), (14, 2, True)):
        a.complete(row, t, ok)
        b.complete(row, t, ok)
        assert a.tick(t + 1) == b.tick(t + 1)
        assert a.last_fire == b.last_fire

