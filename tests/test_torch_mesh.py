"""The port's mesh planners (``cronsun_tpu_torch.parallel.mesh``, shards on
the CPU) against the JAX package's on the forced host devices: the same
seeded state planned by both must give equal plans, field for field, and
equal carried load and capacity — on the 1-D mesh at D = 2 and 4 and the
2-D mesh at 2x2 and 4x2, over both reconcile paths, every demand format,
``plan`` and ``plan_window``, with integer costs (exact) and fractional
ones (load within rtol 1e-6)."""

import numpy as np
import pytest
import torch

from cronsun_tpu.parallel import mesh as jax_mesh
from cronsun_tpu_torch.parallel import mesh as port_mesh
from torch_parity import (assert_mesh_state_equal, assert_plans_equal,
                          cpu_mesh, jax_mesh_planner, mesh_state,
                          one_torch_thread, port_mesh_planner)  # noqa: F401

T0 = 1_753_000_000          # second 40 of its minute


def pair(kind, shape, state, **kw):
    """(JAX planner, port planner) of one kind and mesh shape over
    ``state``; a bucket of 2048 unless ``kw`` says otherwise."""
    kw.setdefault("max_fire_bucket", 2048)
    if kind == "1d":
        jp = jax_mesh_planner(jax_mesh.ShardedTickPlanner,
                              jax_mesh.make_mesh(shape), state, impl="jnp",
                              **kw)
        tp = port_mesh_planner(port_mesh.ShardedTickPlanner,
                               cpu_mesh(shape), state, **kw)
    else:
        jp = jax_mesh_planner(jax_mesh.Sharded2DTickPlanner,
                              jax_mesh.make_mesh2d(*shape), state, **kw)
        tp = port_mesh_planner(port_mesh.Sharded2DTickPlanner,
                               cpu_mesh(*shape), state, **kw)
    return jp, tp


def drive(jp, tp, single_tick, t0=T0):
    """A fused window, a single tick when ``single_tick``, then capacity
    re-opened and a second window: every plan equal, carried state equal
    after each.  (A window and a tick are two programs to compile on the
    JAX side, so only some cases take the tick.)"""
    assert_plans_equal(jp.plan_window(t0, 4), tp.plan_window(t0, 4))
    assert_mesh_state_equal(jp, tp)
    if single_tick:
        assert_plans_equal([jp.plan(t0 + 4)], [tp.plan(t0 + 4)])
        assert_mesh_state_equal(jp, tp)
    caps = np.full(jp.N, 2, np.int32)
    jp.set_node_capacity_full(caps)
    tp.set_node_capacity_full(caps)
    plans = tp.plan_window(t0 + 5, 4)
    assert_plans_equal(jp.plan_window(t0 + 5, 4), plans)
    assert_mesh_state_equal(jp, tp)
    return plans


CASES = [
    ("1d", 2, dict(shard_bids=True, demand_format="dense")),
    ("1d", 2, dict(shard_bids=True, demand_format="compacted")),
    ("1d", 2, dict(shard_bids=False)),
    ("1d", 4, dict(shard_bids=True, demand_format="auto")),
    ("1d", 4, dict(shard_bids=True, demand_format="compacted")),
    ("1d", 4, dict(shard_bids=False)),
    ("2d", (2, 2), dict(shard_bids=True, demand_format="dense")),
    ("2d", (2, 2), dict(shard_bids=True, demand_format="compacted")),
    ("2d", (2, 2), dict(shard_bids=False)),
    ("2d", (4, 2), dict(shard_bids=True, demand_format="auto")),
    ("2d", (4, 2), dict(shard_bids=False)),
    ("2d", (4, 2), dict(shard_bids=True, demand_format="dense",
                        node_block_psum=True)),
]


@pytest.mark.parametrize("kind,shape,kw", CASES,
                         ids=[f"{k}-{s}-{sorted(kw.items())}"
                              for k, s, kw in CASES])
def test_mesh_planner_equals_the_jax_mesh(forced_host_devices, kind, shape,
                                          kw):
    state = mesh_state(4096, 128, seed=len(str(kw)) + (shape if kind == "1d"
                                                        else sum(shape)))
    jp, tp = pair(kind, shape, state, **kw)
    if kw.get("node_block_psum"):
        assert jp.node_block_psum and tp.node_block_psum
    plans = drive(jp, tp, single_tick=CASES.index((kind, shape, kw)) in
                  (0, 2, 6, 8))
    placed = sum(int((p.assigned >= 0).sum()) for p in plans)
    assert placed and any(p.total_fired > 100 for p in plans)


@pytest.mark.parametrize("kind,shape", [("1d", 2), ("2d", (2, 2))])
def test_empty_and_overflowing_buckets_equal_the_jax_mesh(
        forced_host_devices, kind, shape):
    """A second where nothing fires (every job pinned to second 30, planned
    at second 40), then seconds whose fires overflow a 256-row bucket."""
    state = mesh_state(4096, 128, seed=5)
    quiet = dict(state)
    for k in ("sec_lo", "sec_hi"):
        quiet[k] = np.zeros_like(state[k])
    quiet["sec_lo"][:] = 1 << 30          # second 30 only
    quiet["is_every"] = np.zeros_like(state["is_every"])
    jp, tp = pair(kind, shape, quiet)
    ref, got = jp.plan(T0), tp.plan(T0)
    assert ref.total_fired == got.total_fired == 0
    assert_plans_equal([ref], [got])
    assert_mesh_state_equal(jp, tp)
    jp, tp = pair(kind, shape, state, max_fire_bucket=256)
    ref, got = jp.plan_window(T0, 3), tp.plan_window(T0, 3)
    assert_plans_equal(ref, got)
    assert all(p.overflow > 0 for p in got)
    assert_mesh_state_equal(jp, tp)


@pytest.mark.parametrize("kind,shape", [("1d", 4), ("2d", (2, 2))])
def test_fractional_costs_fire_alike_and_load_within_rtol(
        forced_host_devices, kind, shape):
    """Fractional costs: sums may round in another order (the port adds
    per-node totals in f64, the reference scatters in f32), so load is
    held within rtol 1e-6 and the fire sets exactly."""
    state = mesh_state(4096, 128, seed=9, frac=True)
    jp, tp = pair(kind, shape, state)
    for ref, got in zip(jp.plan_window(T0, 4), tp.plan_window(T0, 4)):
        np.testing.assert_array_equal(np.sort(ref.fired), np.sort(got.fired))
        assert ref.total_fired == got.total_fired
    np.testing.assert_allclose(tp.load.numpy(), np.asarray(jp.load),
                               rtol=1e-6)


@pytest.mark.parametrize("k", [256, 2048, 16384, 65536 * 8])
def test_collective_bytes_model_equals_the_reference(forced_host_devices, k):
    """estimate_collective_bytes and the auto demand-format pick, on both
    meshes and both reconcile paths, at buckets across the crossover."""
    for shard_bids in (True, False):
        for jcls, pcls, jm, pm, n in (
                (jax_mesh.ShardedTickPlanner, port_mesh.ShardedTickPlanner,
                 jax_mesh.make_mesh(8), cpu_mesh(8), 100_000),
                (jax_mesh.Sharded2DTickPlanner,
                 port_mesh.Sharded2DTickPlanner, jax_mesh.make_mesh2d(4, 2),
                 cpu_mesh(4, 2), 70_000)):
            jp = jcls(jm, job_capacity=4096, node_capacity=n,
                      shard_bids=shard_bids)
            tp = pcls(pm, job_capacity=4096, node_capacity=n,
                      shard_bids=shard_bids)
            assert (tp.J, tp.N, tp.node_block_psum) == \
                (jp.J, jp.N, jp.node_block_psum)
            assert tp.estimate_collective_bytes(k) == \
                jp.estimate_collective_bytes(k)
            kl = max(256, k // jp.Dj)
            assert tp._resolve_demand_format(kl) == \
                jp._resolve_demand_format(kl)


def test_stats_snapshot_and_measured_bytes(forced_host_devices):
    """stats_snapshot has the reference's keys and the same tick and byte
    counters; the bytes the port's collectives moved per tick equal the
    estimate, on each path."""
    state = mesh_state(2048, 64, seed=3)
    jp, tp = pair("1d", 4, state, demand_format="compacted")
    for p in (jp, tp):
        p.plan(T0)
        p.plan_window(T0 + 10, 2)
    js, ts = jp.stats_snapshot(), tp.stats_snapshot()
    assert set(ts) == set(js)
    for key in ("ticks_total", "collective_bytes_total",
                "collective_bytes_per_tick", "collective_bytes_per_round",
                "compacted_bytes_total", "compacted_ticks_total",
                "demand_format", "node_block_psum", "devices", "shard_bids",
                "rounds"):
        assert ts[key] == js[key], key
    assert ts["ticks_total"] == 3 and ts["tick_p50_ms"] > 0
    for kind, shape, kw in CASES:
        tp = port_mesh_planner(
            port_mesh.ShardedTickPlanner if kind == "1d"
            else port_mesh.Sharded2DTickPlanner,
            cpu_mesh(shape) if kind == "1d" else cpu_mesh(*shape), state,
            max_fire_bucket=1024, **kw)
        assert tp.measured_collective_bytes() is None
        tp.plan_window(T0, 2)
        est = tp.estimate_collective_bytes(
            k_local=tp._last_k_local,
            demand_format=tp._last_demand_format)
        assert tp.measured_collective_bytes() == est["per_tick"], (kind, kw)


def test_profile_phases_feeds_the_snapshot():
    tp = port_mesh_planner(port_mesh.Sharded2DTickPlanner, cpu_mesh(2, 2),
                           mesh_state(1024, 64, seed=4), max_fire_bucket=512)
    prof = tp.profile_phases(iters=2)
    assert set(prof) == {"bid_ms", "gather_ms", "reconcile_ms"}
    assert all(v >= 0 for v in prof.values())
    snap = tp.stats_snapshot()
    assert snap["phase_bid_ms"] == prof["bid_ms"]


def test_placements_invariant_to_column_split():
    """K1n breaks exact ties to the lowest global node id, so a 2-D mesh's
    placements do not depend on how many blocks split the columns (all-zero
    load and unit costs: every bid is a tie-hash tie festival)."""
    state = mesh_state(2048, 128, seed=11)
    state["cost"][:] = 1.0
    state["rem_cap"][:] = 10**6

    def run(dn):
        tp = port_mesh_planner(port_mesh.Sharded2DTickPlanner,
                               cpu_mesh(4, dn), state, max_fire_bucket=2048)
        p = tp.plan(T0)
        return dict(zip(p.fired.tolist(), p.assigned.tolist()))

    a = run(1)
    assert a == run(2) == run(4)
    assert any(v >= 0 for v in a.values())


def test_setters_route_rows_to_their_shards_last_write_wins():
    """Row-wise setters land on the owning shard (and node block), a batch
    that names a row twice keeps its last write, and built_state assembles
    the global arrays — equal to the same writes on a whole array."""
    from cronsun_tpu_torch.ops.schedule_table import make_row
    state = mesh_state(1024, 128, seed=12)
    tp = port_mesh_planner(port_mesh.Sharded2DTickPlanner, cpu_mesh(2, 2),
                           state)
    rows = np.array([3, 700, 3, 1023, 512])
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**32, (5, 4), dtype=np.uint64).astype(np.uint32)
    tp.set_eligibility_rows(rows, vals)
    tp.set_job_meta(rows, np.array([1, 0, 0, 1, 1], bool),
                    np.array([5, 6, 7, 8, 9], np.float32))
    specs = ["@every 3s", "0 * * * * *", "@every 5s", "*/2 * * * * *",
             "@every 7s"]
    tp.update_table_rows(rows, [make_row(s) for s in specs])
    tp.set_node_capacity([1, 1, 64], [9, 4, 7])
    want = dict(state)
    want["elig"] = state["elig"].copy()
    want["exclusive"] = state["exclusive"].copy()
    want["cost"] = state["cost"].copy()
    for i, r in enumerate(rows):
        want["elig"][r] = vals[i]
        want["exclusive"][r] = [1, 0, 0, 1, 1][i]
        want["cost"][r] = [5, 6, 7, 8, 9][i]
    got = tp.built_state()
    for k in ("elig", "exclusive", "cost"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["elig"].dtype == np.uint32
    assert got["table"]["period"][3] == 5 and got["table"]["period"][700] == 1
    assert got["table"]["period"][512] == 7
    cap = tp.rem_cap.numpy()
    assert cap[1] == 4 and cap[64] == 7
    for sh in tp._shards:            # replicated copies stay identical
        assert torch.equal(sh.rem_cap, tp.rem_cap)


def test_mesh_constructors(monkeypatch):
    m = port_mesh.make_mesh(3, device="cpu")
    assert m.devices.size == 3 and m.axis_names == ("jobs",)
    m2 = port_mesh.make_mesh2d(2, 2, device="cpu")
    assert m2.shape == {"jobs": 2, "nodes": 2} and m2.group(3, "jobs") == \
        [1, 3] and m2.group(3, "nodes") == [2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        port_mesh.make_mesh(2)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        port_mesh.make_mesh2d(2, 2, device="cuda")
    with pytest.raises(ValueError, match="demand_format"):
        port_mesh.ShardedTickPlanner(cpu_mesh(2), 1024, 64,
                                     demand_format="sparse")
    with pytest.raises(ValueError, match="mesh"):
        port_mesh.Sharded2DTickPlanner(cpu_mesh(2), 1024, 64)


def test_dryrun_multichip_fires_as_the_jax_dryrun(forced_host_devices,
                                                  capsys):
    import __graft_entry__
    from cronsun_tpu_torch.entry import dryrun_multichip
    __graft_entry__._dryrun_body(4)
    ref = capsys.readouterr().out
    got = dryrun_multichip(4, device="cpu")
    # the same fired counts: "fired=F (+S single-tick) ... fired=F2"
    import re
    nums = lambda s: re.findall(r"fired=(\d+)|\+(\d+) single", s)
    assert nums(got) == nums(ref), (got, ref)
