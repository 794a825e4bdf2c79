"""Port vs JAX: TickPlanner.plan_window over several windows from one shared
numpy state — every TickPlan field, the final load and the final rem_cap
exactly equal, second by second (integer costs keep float sums exact).
Also the properties of tests/test_planner.py for the port."""

import numpy as np
import pytest
import torch

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.cron import parse
from cronsun_tpu_torch.ops.eligibility import EligibilityBuilder, NodeUniverse
from cronsun_tpu_torch.ops.planner import TickPlanner, _AdaptiveBucket
from cronsun_tpu_torch.ops.schedule_table import build_table, make_row
from cronsun_tpu_torch.synth import synth_state
from torch_parity import (assert_plans_equal, assert_state_equal,
                          jax_planner_from_state)

T0 = 1_753_000_000
J, N = 4096, 320


@pytest.fixture(scope="module")
def state():
    return synth_state(J, N, seed=11, empty_rows=0.05, node_cap=6)


def _pair(state, **kw):
    return (jax_planner_from_state(state, **kw),
            planner_from_numpy(state, device="cpu", **kw))


def test_plan_window_matches_jax_over_windows(state):
    jp, tp = _pair(state, max_fire_bucket=1024)
    for i in range(4):
        # the service's reconcile re-opens capacity each step
        cols = list(range(0, N, 3))
        jp.set_node_capacity(cols, [5] * len(cols))
        tp.set_node_capacity(cols, [5] * len(cols))
        ref = jp.plan_window(T0 + 4 * i, 4)
        got = tp.plan_window(T0 + 4 * i, 4)
        assert_plans_equal(ref, got)
        assert_state_equal(jp, tp)
        assert sum((p.assigned >= 0).sum() for p in got) > 0
    assert (tp._bx.cur_k, tp._bc.cur_k) == (jp._bx.cur_k, jp._bc.cur_k)


def test_plan_window_overflow_and_pinned_buckets_match_jax(state):
    jp, tp = _pair(state, rounds=3)
    for sla in (64, (128, 32)):
        ref = jp.plan_window(T0 + 100, 3, sla_bucket=sla)
        got = tp.plan_window(T0 + 100, 3, sla_bucket=sla)
        assert_plans_equal(ref, got)
        assert any(p.overflow > 0 for p in got)
    assert_state_equal(jp, tp)


def test_plan_and_setters_match_jax(state):
    jp, tp = _pair(state)
    rows = np.array([5, 17, 4095])
    elig = np.full((3, N // 32), 0xF0F0F0F0, np.uint32)
    for p in (jp, tp):
        p.set_eligibility_rows(rows, elig)
        p.set_job_meta(rows, np.array([True, False, True]),
                       np.array([3.0, 2.0, 1.0], np.float32))
        p.update_table_rows(rows, [make_row("* * * * * *")] * 3)
        p.set_load(np.arange(N, dtype=np.float32) % 7)
        p.set_node_capacity([0, 1, 2], [0, 9, 9])
    assert_plans_equal([jp.plan(T0 + 7)], [tp.plan(T0 + 7)])
    for p in (jp, tp):
        p.job_finished(1, 2.0)
        p.common_finished(2, 1.0)
    assert_state_equal(jp, tp)
    assert_plans_equal([jp.plan(T0 + 8)], [tp.plan(T0 + 8)])
    assert_state_equal(jp, tp)


def _setup(node_ids=("n0", "n1", "n2")):
    p = TickPlanner(job_capacity=64, node_capacity=64, max_fire_bucket=4096,
                    device="cpu")
    u = NodeUniverse(p.N)
    cols = [u.add(n) for n in node_ids]
    b = EligibilityBuilder(u, job_capacity=p.J)
    p.set_node_capacity(cols, [10] * len(cols))
    return p, u, b


def test_plan_window_equals_sequential_ticks():
    def build():
        p, u, b = _setup()
        p.set_table(build_table([parse("* * * * * *"), parse("*/2 * * * * *"),
                                 parse("*/3 * * * * *")], capacity=p.J,
                                device="cpu"))
        for row in range(3):
            b.set_job(row, ["n0", "n1", "n2"], [], [])
        p.set_eligibility_rows(*b.dirty_rows())
        p.set_job_meta(np.arange(3), np.ones(3, bool), np.ones(3, np.float32))
        return p

    t0 = 1_753_000_080
    pw, ps = build(), build()
    plans_w = pw.plan_window(t0, 6, sla_bucket=64)
    plans_s = [ps.plan(t0 + i, sla_bucket=64) for i in range(6)]
    assert_plans_equal(plans_s, plans_w)
    assert torch.equal(pw.load, ps.load) and torch.equal(pw.rem_cap, ps.rem_cap)


def test_plan_capacity_accounting_roundtrip():
    p, u, b = _setup(node_ids=("n0",))
    p.set_table(build_table([parse("* * * * * *")] * 3, capacity=p.J,
                            device="cpu"))
    for row in range(3):
        b.set_job(row, ["n0"], [], [])
    p.set_eligibility_rows(*b.dirty_rows())
    p.set_job_meta(np.arange(3), np.ones(3, bool), np.ones(3, np.float32))
    n0 = u.index["n0"]
    p.set_node_capacity([n0], [2])
    assert (p.plan(T0).assigned >= 0).sum() == 2   # third: capacity gate
    assert int(p.rem_cap[n0]) == 0
    p.job_finished(n0, cost=1.0)
    assert int(p.rem_cap[n0]) == 1
    assert (p.plan(T0 + 1).assigned >= 0).sum() == 1


def test_common_jobs_get_minus_one_and_load():
    p, u, b = _setup()
    p.set_table(build_table([parse("* * * * * *")], capacity=p.J, device="cpu"))
    b.set_job(0, ["n0", "n1"], [], [])
    p.set_eligibility_rows(*b.dirty_rows())
    p.set_job_meta(np.array([0]), np.array([False]), np.array([2.0], np.float32))
    plan = p.plan(T0)
    assert plan.fired.tolist() == [0] and plan.assigned.tolist() == [-1]
    assert p.load[u.index["n0"]] == 2.0 and p.load[u.index["n1"]] == 2.0


def test_warm_paths_mutate_no_carried_state(state):
    tp = planner_from_numpy(state, device="cpu", max_fire_bucket=2048)
    load, cap = tp.load.clone(), tp.rem_cap.clone()
    tp.warm_window(T0, 4)
    k = tp.warm_escalation(T0, factor=2)
    assert k == 4096 and k in tp._warmed_single
    assert tp.snap_escalation(3000) == 4096 and tp.snap_escalation(5000) == 5000
    assert torch.equal(tp.load, load) and torch.equal(tp.rem_cap, cap)
    assert tp._bx.cur_k == 0 and not tp._bx.seen     # hysteresis untouched


def test_unported_arms_refuse_loudly():
    """Both arms are ported: their switches arm and disarm (they used to
    raise), and an armed arm runs."""
    p = TickPlanner(64, 64, device="cpu")
    assert not p.dep_enabled and not p.tenants_enabled
    p.set_dep_enabled(True)
    p.set_tenants_enabled(True)
    assert p.dep_enabled and p.tenants_enabled
    plan = p.plan(T0)
    assert plan.tenant_throttled.shape == (p.T,) and plan.fired.size == 0
    p.set_dep_enabled(False)
    p.set_tenants_enabled(False)
    assert not p.dep_enabled and not p.tenants_enabled
    assert p.plan(T0 + 1).tenant_throttled is None


def test_adaptive_bucket_hysteresis():
    b = _AdaptiveBucket(max_bucket=65536, cap=1 << 20)
    s1 = b.size(None)
    b.feed(100, 1)
    assert b.size(None) == s1            # unseen shrink waits
    for _ in range(300):
        b.feed(100, 1)
    s3 = b.size(None)
    assert s3 < s1
    b.feed(100_000, 1)
    assert b.size(None) > s3             # bursts grow at once
    b.feed(100, 1)
    assert b.size(None) == s3            # back to a seen size at once
