"""Port vs JAX: tenant admission.  Weighted max-min fair share (host
against the O(T^2) oracle, device against host and against the JAX
device waterfill), ``select_fair``, the segments of ``tenant_order``,
``admit`` on random inputs, the token-bucket edges and the admission
differential on both planners at once, tenant-free bit-identity, the
overflow replan not double-spending tokens, and one armed multi-window
differential with deps and tenants together.  Exact unless a test states
a tolerance.  Mirrors tests/test_tenancy.py:85-238 and :584."""

import numpy as np
import pytest
import torch

import cronsun_tpu.ops.tenancy as jten
from cronsun_tpu_torch.ops import tenancy as tten
from cronsun_tpu_torch.ops.schedule_table import (FRAMEWORK_EPOCH,
                                                  _rows_to_numpy, make_row)
from cronsun_tpu_torch.ops.tenancy import (
    ReferenceAdmission, TenantOrder, fair_shares, reference_max_min,
    select_fair, tenant_order, weighted_max_min)
from cronsun_tpu_torch.synth import arm_mixed, completions, synth_state
from torch_parity import (PlannerPair, assert_plans_equal,  # noqa: F401
                          one_torch_thread)

T0 = 1_753_000_000


# ---------------------------------------------------------------- fair share

def test_weighted_max_min_exact_vs_reference():
    rng = np.random.default_rng(11)
    for _ in range(400):
        n = int(rng.integers(1, 12))
        d = rng.integers(0, 40, n)
        w = rng.uniform(0.1, 5.0, n)
        cap = int(rng.integers(0, 100))
        got = weighted_max_min(d, w, cap)
        assert np.array_equal(got, reference_max_min(d, w, cap))
        assert np.array_equal(got, jten.weighted_max_min(d, w, cap))
        assert (got <= d).all() and got.sum() == min(cap, d.sum())


def _fair_case(rng, T=16, dyadic=True):
    n = int(rng.integers(1, 10))
    d = np.zeros(T, np.int64)
    w = np.ones(T)
    idx = rng.choice(T, n, replace=False)
    d[idx] = rng.integers(0, 25, n)
    w[idx] = (rng.integers(2, 33, n) / 8 if dyadic
              else rng.uniform(0.25, 4.0, n).round(2))
    return d, w, int(rng.integers(0, 60))


def _device_shares(d, w, cap):
    return fair_shares(torch.as_tensor(d, dtype=torch.int32),
                       torch.as_tensor(w, dtype=torch.float32),
                       torch.tensor(float(cap))).numpy()


@pytest.mark.parametrize("dyadic", [True, False])
def test_device_fair_shares_matches_host_and_jax(dyadic):
    """The device waterfill splits exactly like the host pair and the JAX
    device version: no stranded slots, shares <= demand, sum == min(cap,
    demand).  Dyadic weights (multiples of 1/8) keep every f32 partial sum
    exact; the other case uses the JAX test's weights (two decimals)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    for _ in range(200):
        d, w, cap = _fair_case(rng, dyadic=dyadic)
        got = _device_shares(d, w, cap)
        assert np.array_equal(got, weighted_max_min(d, w, cap)), (d, w, cap)
        ref = jten.fair_shares(jnp.asarray(d, jnp.int32),
                               jnp.asarray(w, jnp.float32), jnp.float32(cap))
        assert np.array_equal(got, np.asarray(ref))


def test_device_fair_shares_arbitrary_weights_within_one_slot():
    """Arbitrary f32 weights: the device waterfill in f32 may floor a share
    one unit away from the f64 host split near a boundary, so each share is
    held within 1 slot of ``weighted_max_min`` with the totals equal and no
    share above its demand."""
    rng = np.random.default_rng(9)
    for _ in range(300):
        T = 16
        d = rng.integers(0, 40, T)
        w = rng.uniform(0.05, 7.0, T).astype(np.float32)
        cap = int(rng.integers(0, 200))
        got = _device_shares(d, w, cap)
        host = weighted_max_min(d, w.astype(np.float64), cap)
        assert np.abs(got - host).max() <= 1, (d, w, cap, got, host)
        assert got.sum() == host.sum() and (got <= d).all()


def test_fair_shares_huge_capacity_is_demand():
    d = np.array([0, 5, 9, 1 << 20, 3], np.int64)
    w = np.array([1, 0.5, 2, 1, 1])
    for cap in (float(1 << 20) * 1e4, 2.0 ** 40):
        assert np.array_equal(_device_shares(d, w, cap), d)


def test_select_fair_keeps_first_k_per_tenant_in_order():
    t = np.array([0, 1, 0, 2, 1, 1, 0])
    keep = select_fair(t, np.array([2, 1, 0]))
    assert keep.tolist() == [True, True, True, False, False, False, False]
    assert np.array_equal(keep, jten.select_fair(t, np.array([2, 1, 0])))
    assert select_fair(np.zeros(0, np.int32), np.array([1])).size == 0


def test_tenant_order_segments():
    t = np.array([2, 0, 1, 0, 2, 2], np.int32)
    perm, ts, segbase = tenant_order(t)
    for a, b in zip((perm, ts, segbase), jten.tenant_order(t)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert ts.tolist() == sorted(t.tolist())
    for i in range(len(t)):
        assert ts[segbase[i]] == ts[i]
        assert segbase[i] == 0 or ts[segbase[i] - 1] != ts[i]
    o = TenantOrder.from_tenants(t, 4, "cpu")
    assert o.inv[o.perm].tolist() == list(range(len(t)))
    assert (o.seg_lo.tolist(), o.seg_hi.tolist()) == ([0, 2, 3, 6],
                                                      [2, 3, 6, 6])
    with pytest.raises(ValueError):
        TenantOrder.from_tenants(t, 2, "cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admit_matches_jax(seed):
    """One second of admission on random fires, tenants, buckets, weights
    (dyadic) and capacity: admitted, tokens, throttled and shed equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    J, T, N = 700, 8, 64
    tenants = rng.integers(0, T, J).astype(np.int32)
    tenants[rng.random(J) < 0.3] = 0
    fire = rng.random(J) < 0.5
    time_fire = fire & (rng.random(J) < 0.7)
    exclusive = rng.random(J) < 0.5
    rate = rng.integers(0, 40, T).astype(np.float32) / 4
    burst = rate + rng.integers(0, 20, T).astype(np.float32)
    limited = rate > 0
    tokens = (burst * rng.random(T)).astype(np.float32)
    weight = (rng.integers(1, 17, T) / 8).astype(np.float32)
    rem_cap = rng.integers(-1, 3 + 5 * seed, N).astype(np.int32)
    perm, ts, segbase = tenant_order(tenants)
    ref = jten.admit(*map(jnp.asarray, (
        fire, time_fire, exclusive, tokens, rate, burst, limited, weight,
        rem_cap, perm, ts, segbase)), T)
    order = TenantOrder.from_tenants(tenants, T, "cpu")
    got = tten.admit(*map(torch.from_numpy, (
        fire, time_fire, exclusive[perm], tokens, rate, burst, limited,
        weight, rem_cap)), order)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert np.asarray(ref[2]).any()


# ------------------------------------------------- admission on the planners

def _state(n_rows, tenants, quotas, J=128, N=96, spec="* * * * * *"):
    """n_rows every-second jobs, row i owned by tenants[i]; quotas =
    {tid: (rate, burst)}; admission armed.  All Common, only node 0
    open — the shape of tests/test_tenancy.py's planner."""
    st = synth_state(J, N, seed=1, tenant_capacity=64)
    st.update(_rows_to_numpy([make_row(spec, tenant=int(tenants[i]))
                              for i in range(n_rows)], J))
    st["elig"][:] = 1
    st["exclusive"][:] = False
    st["cost"][:] = 1.0
    st["rem_cap"][:] = 0
    st["rem_cap"][0] = 1 << 20
    st["row_tenant"][:n_rows] = np.asarray(tenants[:n_rows], np.int32)
    for tid, (rate, burst) in quotas.items():
        st["tb_rate"][tid], st["tb_burst"][tid] = rate, burst
        st["tb_limited"][tid] = rate > 0
        st["tb_tokens"][tid] = burst if rate > 0 else 0.0
    st["tenants_enabled"] = np.bool_(True)
    return st


def _admitted(p, t0, w):
    return [sorted(pl.fired.tolist()) for pl in p.plan_window(t0, w)]


def test_token_bucket_burst_then_clamp():
    p = PlannerPair(_state(6, [1] * 6, {1: (2.0, 4.0)}))
    secs = _admitted(p, T0, 4)
    assert [len(s) for s in secs] == [4, 2, 2, 2]
    assert secs[0] == [0, 1, 2, 3] and secs[1] == [0, 1]


def test_token_bucket_fractional_rate():
    p = PlannerPair(_state(3, [1] * 3, {1: (0.5, 1.0)}))
    counts = [len(s) for s in _admitted(p, T0, 6)]
    assert counts[0] == 1 and sum(counts) == 1 + 2
    pl = p.plan_window(T0 + 100, 1)[0]
    assert int(pl.tenant_shed[1]) == int(pl.tenant_throttled[1]) >= 2


def test_token_bucket_refill_caps_at_burst():
    p = PlannerPair(_state(8, [1] * 8, {1: (1.0, 2.0)}))
    assert [len(s) for s in _admitted(p, T0, 2)] == [2, 1]
    # refill happens per planned second, not wall time
    assert [len(s) for s in _admitted(p, T0 + 3600, 2)] == [1, 1]


def test_default_tenant_never_limited():
    p = PlannerPair(_state(5, [0] * 5, {1: (1.0, 1.0)}))
    assert all(len(s) == 5 for s in _admitted(p, T0, 3))


def test_admission_differential_vs_reference():
    """Random tables and quotas: both planners equal each other and the
    pure-Python ReferenceAdmission, second by second."""
    rng = np.random.default_rng(5)
    for trial in range(4):
        n = int(rng.integers(4, 24))
        tenants = rng.integers(0, 4, n)
        quotas = {}
        for tid in (1, 2, 3):
            if rng.random() < 0.8:
                rate = float(rng.integers(1, 4))
                quotas[tid] = (rate, rate + float(rng.integers(0, 3)))
        p = PlannerPair(_state(n, tenants, quotas))
        ref = ReferenceAdmission(quotas)
        for s, pl in enumerate(p.plan_window(T0, 5)):
            fires = [(r, int(tenants[r])) for r in range(n)]
            want = [r for (r, _t), ok in zip(sorted(fires), ref.tick(fires))
                    if ok]
            assert sorted(pl.fired.tolist()) == sorted(want), (trial, s)


def test_tenant_free_table_bit_identical():
    """Armed with every tenant unlimited, plans equal the disarmed plans
    (and JAX's) apart from the per-tenant counts, which are all zero."""
    rng = np.random.default_rng(3)
    specs = [f"*/{int(k)} * * * * *" for k in rng.integers(2, 9, 24)]
    a_st = _state(0, [], {})
    a_st.update(_rows_to_numpy([make_row(s) for s in specs], 128))
    a_st["tenants_enabled"] = np.bool_(False)
    b_st = dict(a_st, tenants_enabled=np.bool_(True))
    a, b = PlannerPair(a_st), PlannerPair(b_st)
    for w0 in (T0, T0 + 7):
        pa, pb = a.plan_window(w0, 4), b.plan_window(w0, 4)
        for x, y in zip(pa, pb):
            assert x.tenant_throttled is None
            assert not y.tenant_throttled.any() and not y.tenant_shed.any()
            y.tenant_throttled = y.tenant_shed = None
        assert_plans_equal(pa, pb)


def test_overflow_replan_does_not_double_spend_tokens():
    """A replan (sla_bucket pinned) admits against the current bucket but
    never writes the spend back; a normal plan does."""
    p = PlannerPair(_state(8, [1] * 8, {1: (2.0, 4.0)}))
    assert float(p.tp.tb_tokens[1]) == 4.0
    p.plan_window(T0, 1, sla_bucket=2048)
    assert float(p.tp.tb_tokens[1]) == 4.0
    p.plan_window(T0 + 1, 1)
    assert float(p.tp.tb_tokens[1]) == 0.0


def test_armed_dispatch_reads_no_value_back(monkeypatch):
    """Dispatching an armed window reads no tensor value back to the host
    (on a card each read would stall the stream): fair_shares included.
    The kernel wrappers' index check reads on the CPU only, so it is not
    counted."""
    import traceback
    from torch.utils._python_dispatch import TorchDispatchMode
    from cronsun_tpu_torch.convert import planner_from_numpy
    st = synth_state(1024, 64, seed=31, node_cap=1)
    arm_mixed(st, seed=32, n_dep=150, n_noisy=200, start_epoch_s=T0)
    p = planner_from_numpy(st, device="cpu", max_fire_bucket=256)
    reads, calls = [], []

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten._local_scalar_dense.default,
                        torch.ops.aten.item.default):
                where = [f.name for f in traceback.extract_stack()]
                if "_bucket_size" not in where:
                    reads.append(where[-3:])
            return func(*args, **(kwargs or {}))

    def spy(*a, orig=tten.fair_shares):
        calls.append(1)
        return orig(*a)
    monkeypatch.setattr(tten, "fair_shares", spy)
    p.gather_window(p.plan_window_async(T0, 2))     # the order is built
    with Reads():
        handle = p.plan_window_async(T0 + 2, 4)
    assert len(calls) == 6 and reads == [], reads
    p.gather_window(handle)


def test_tenant_setters_and_state_round_trip():
    """Quota install, clear, row->tenant changes (the order recomputes),
    tenant_state/set_tenant_state, against JAX; warm paths mutate no
    tokens."""
    p = PlannerPair(_state(10, [1] * 5 + [2] * 5, {1: (2.0, 3.0)}))
    p.set_tenant_quota(2, 1.5, 2.5, weight=0.5)
    p.plan_window(T0, 2)
    p.set_row_tenants([0, 1, 7], [3, 3, 1])
    p.set_tenant_quota(3, 1.0, 1.0)
    p.plan_window(T0 + 2, 3)
    saved = p.tp.tenant_state()
    assert saved["tokens"].dtype == np.float32
    tokens = p.tp.tb_tokens.clone()
    p.warm_window(T0 + 5, 2)
    p.warm_escalation(T0 + 5, factor=2)
    assert torch.equal(p.tp.tb_tokens, tokens)
    p.clear_tenant_quota(1)
    p.plan_window(T0 + 5, 2)
    p.set_tenant_state(**saved)
    np.testing.assert_array_equal(p.jp.tenant_state()["tokens"],
                                  p.tp.tenant_state()["tokens"])
    p.plan_window(T0 + 7, 2)


def test_armed_differential_deps_and_tenants(monkeypatch):
    """Both arms armed on one seeded state — a 3-stage DAG with every
    policy, broken and blocked rows, Zipf tenants with dyadic weights, a
    noisy tenant over quota, capacity re-opened each window so the fair
    share binds — over several windows with completions folded between
    them: every TickPlan field, load, rem_cap, dep_last_fire and tb_tokens
    equal."""
    J, N = 2048, 64
    st = synth_state(J, N, seed=21, node_cap=1)
    stages = arm_mixed(st, seed=22, n_dep=300, n_noisy=400, start_epoch_s=T0)
    rng = np.random.default_rng(23)
    p = PlannerPair(st, max_fire_bucket=256)
    clamped = []                  # seconds where the fair share binds

    def spy(demand, weight, cap, orig=tten.fair_shares):
        shares = orig(demand, weight, cap)
        clamped.append(bool((shares < demand).any()))
        return shares
    monkeypatch.setattr(tten, "fair_shares", spy)
    ups = np.zeros(J, bool)
    ups[stages["sources"]] = ups[stages["mids"]] = True
    has_dep = st["has_dep"]
    thr = dep_fires = 0
    for i in range(6):
        p.set_node_capacity(list(range(N)), [1] * N)
        plans = p.plan_window(T0 + 4 * i, 4)
        for pl in plans:
            thr += int(pl.tenant_throttled.sum())
            dep_fires += int(has_dep[pl.fired].sum())
        p.set_dep_epochs(*completions(plans, ups, rng))
    # every mechanism really ran: refusals, the fair-share clamp, dep fires
    assert thr > 0 and any(clamped) and dep_fires > 0, (thr, dep_fires)
    assert p.tp.dep_last_fire[has_dep].max() > T0 - FRAMEWORK_EPOCH
