"""The port's scheduler benches against the JAX script's, on the CPU.

Each workload of ``scripts/bench_sched.py`` runs twice at a small size with
the same arguments: once as the JAX script's function, once as
``cronsun_tpu_torch.scripts.bench_sched``'s on ``device="cpu"``.  Both pick
their store backend the same way (the native store when it is there).  The
two outputs must have the same key names, and be equal on every key that
counts fires, orders, keys, stage sizes or divergence (each test names
them); timings differ and are not compared.  ``--trace`` runs the trace
bench (its refusal, exit 2, went when the port gained node agents and a
result store).
"""

import json
import os
import subprocess
import sys

import pytest

import cronsun_tpu.sched as jax_sched
import cronsun_tpu_torch.sched as port_sched
from cronsun_tpu_torch.scripts import bench_sched as port_bench
from torch_parity import one_torch_thread, time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_sched as jax_bench  # noqa: E402


def quiet(*a):
    pass


def both(name, limit_s, **kw):
    """(JAX output, port output) of the workload ``name`` with ``kw``."""
    with time_limit(limit_s, f"bench_sched.{name}"):
        ref = getattr(jax_bench, name)(on_log=quiet, **kw)
        got = getattr(port_bench, name)(on_log=quiet, device="cpu", **kw)
    return ref, got


def assert_same(ref, got, keys):
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k in keys:
        assert got[k] == ref[k], (k, ref[k], got[k])


DAG_KEYS = (
    "dag_bench_backend", "dag_bench_jobs", "dag_bench_nodes",
    "dag_bench_rounds", "dag_bench_fan_in", "dag_stage_sizes",
    "dag_duplicate_fires", "dag_missing_fires", "dag_fires_total",
    "dag_expected_fires", "dag_incomplete_rounds", "dag_publish_failures",
    "dag_dep_jobs", "dag_warm_restored", "dag_warm_divergence_orders",
    "dag_warm_window_orders", "dag_warm_window_dep_fires")


def test_dag_bench_matches_the_jax_script():
    ref, got = both("run_dag_bench", 120, n_jobs=300, n_nodes=8, rounds=2,
                    window_s=2)
    assert_same(ref, got, DAG_KEYS)
    assert got["dag_fires_total"] == got["dag_expected_fires"] > 0
    assert got["dag_warm_divergence_orders"] == 0
    assert got["dag_warm_window_dep_fires"] > 0


TENANT_KEYS = (
    "tenant_bench_tenants", "tenant_bench_victim_jobs",
    "tenant_bench_victim_sizes", "tenant_bench_noisy_jobs",
    "tenant_bench_seconds", "tenant_noisy_quota_rate",
    "tenant_noisy_offered_rate", "tenant_noisy_admitted_rate",
    "tenant_noisy_clamp_ratio", "tenant_noisy_throttled_fires",
    "tenant_noisy_shed_fires", "tenant_victim_missing_fires",
    "tenant_victim_duplicate_fires", "tenant_victim_throttled_fires",
    "tenant_per_tenant_admitted_rate")


def test_tenant_bench_matches_the_jax_script():
    ref, got = both("run_tenant_bench", 120, n_tenants=6, victim_jobs=1500,
                    noisy_rate=50.0, seconds=6, n_nodes=16)
    assert_same(ref, got, TENANT_KEYS)
    assert got["tenant_noisy_throttled_fires"] > 0
    assert got["tenant_victim_missing_fires"] == 0


PARTITION_KEYS = ("fires", "fires_per_partition", "fairness", "divergence")


def test_partition_ladder_matches_the_jax_script():
    ref, got = both("run_partition_ladder", 120, n_jobs=3000, n_nodes=32,
                    parts=(1, 2), steps=2)
    assert_same(ref, got, ("sched_partition_jobs", "sched_partition_nodes"))
    rungs_ref, rungs = ref["sched_partition_ladder"], \
        got["sched_partition_ladder"]
    assert set(rungs) == set(rungs_ref) == {"1", "2"}
    for p in rungs:
        assert_same(rungs_ref[p], rungs[p], PARTITION_KEYS)
        assert rungs[p]["divergence"] == 0
    assert rungs["1"]["fires"] > 0


HERD_ARM_KEYS = (
    "herd_publish_max_second_keys", "herd_publish_max_second_node_keys",
    "herd_smear_deferred_total", "herd_smear_late_emits_total",
    "herd_smear_max_spread_s", "herd_duplicate_fires", "herd_missing_fires",
    "herd_reference_divergence")


def test_herd_bench_matches_the_jax_script():
    ref, got = both("run_herd_bench", 150, n_jobs=2000, n_nodes=32,
                    jitter=5)
    assert_same(ref, got, ("herd_bench_jobs", "herd_bench_nodes",
                           "herd_smear_jitter_s") + tuple(
        f"{k}_{arm}" for k in HERD_ARM_KEYS
        for arm in ("unsmeared", "smeared")))
    for arm in ("unsmeared", "smeared"):
        assert got[f"herd_missing_fires_{arm}"] == 0
        assert got[f"herd_reference_divergence_{arm}"] == 0
    assert got["herd_smear_deferred_total_smeared"] > 0


# run_bench reads the wall clock (the seed's @every anchors, the herd
# second, the takeover loop), so both runs see one frozen clock: the
# script's ``time.time`` and every service's ``clock``.  Placement-dependent
# counts (order keys published, keys per second, the takeover's catch-up
# orders) are left out: the capacity reconcile races the pipelined
# dispatch thread, and two runs of the JAX script over its TCP store place
# differently (2 of 350 order keys moved in such a pair).
BENCH_KEYS = (
    "sched_bench_backend", "sched_bench_jobs", "sched_bench_nodes",
    "failover_warm_restored", "failover_warm_divergence_orders",
    "failover_warm_window_orders", "sched_publish_failures",
    "sched_steps_measured", "sched_dispatches_per_step",
    "sched_publish_max_second_excl_fires", "sched_build_herd_fires")
FROZEN_NOW = 1_760_000_041


class _FrozenTime:
    """The ``time`` module with ``time()`` stopped at ``now``."""

    def __init__(self, real, now):
        self._real, self._now = real, now

    def time(self):
        return float(self._now)

    def __getattr__(self, name):
        return getattr(self._real, name)


def _clocked(cls, now):
    class Clocked(cls):
        def __init__(self, *a, **kw):
            kw.setdefault("clock", lambda: float(now))
            super().__init__(*a, **kw)
    return Clocked


def test_step_and_failover_bench_matches_the_jax_script(monkeypatch):
    for script in (jax_bench, port_bench):
        monkeypatch.setattr(script, "time",
                            _FrozenTime(script.time, FROZEN_NOW))
    for pkg in (jax_sched, port_sched):
        monkeypatch.setattr(pkg, "SchedulerService",
                            _clocked(pkg.SchedulerService, FROZEN_NOW))
    ref, got = both("run_bench", 120, n_jobs=2000, n_nodes=64, steps=2)
    assert_same(ref, got, BENCH_KEYS)
    assert got["failover_warm_restored"] == 1
    assert got["failover_warm_divergence_orders"] == 0
    assert got["failover_warm_window_orders"] > 0
    assert got["sched_dispatches_per_step"] > 0


TRACE_KEYS = ("trace_bench_backend", "trace_bench_jobs",
              "trace_bench_nodes", "trace_overhead_steps")
TRACE_STAGES = ("publish", "claim", "queue", "run", "record")


def test_trace_bench_matches_the_jax_script():
    """The trace-plane bench at ``tests/test_bench_smoke.py``'s tier-1
    size in both packages: the same keys, every wire stage of the
    waterfall present and non-negative, both overhead arms measured.
    Stage latencies and the overhead ratio are timings: not compared."""
    ref, got = both("run_trace_bench", 120, n_jobs=800, n_nodes=32,
                    steps=4, window_s=2, traced_jobs=12, seconds=4)
    assert_same(ref, got, TRACE_KEYS)
    for res in (ref, got):
        assert res["trace_stage_fires"] > 0
        stages = res["trace_stage_p99_ms"]
        for st in TRACE_STAGES:
            assert st in stages, f"stage {st} missing from {stages}"
            assert stages[st] >= 0.0
        assert res["trace_overhead_on_p99_ms"] > 0
        assert res["trace_overhead_off_p99_ms"] > 0
        assert res["trace_overhead_gate_ok"] in (0, 1)
    assert set(got["trace_stage_p99_ms"]) >= set(TRACE_STAGES)


def test_trace_mode_exits_2_and_says_why():
    """``--trace`` was refused (exit 2) until the port had node agents
    and a result store; it now runs the trace bench, so this checks that
    ``--trace --device cpu`` exits 0 and prints the trace bench's keys."""
    r = subprocess.run(
        [sys.executable, "-m", "cronsun_tpu_torch.scripts.bench_sched",
         "--trace", "--device", "cpu", "--jobs", "400", "--nodes", "32",
         "--steps", "2", "--window", "2", "--traced-jobs", "6",
         "--seconds", "3"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert set(out) >= {"trace_stage_fires", "trace_stage_p99_ms",
                        "trace_overhead_on_p99_ms",
                        "trace_overhead_off_p99_ms",
                        "trace_overhead_ratio", "trace_overhead_gate_ok",
                        *TRACE_KEYS}
    assert out["trace_bench_jobs"] == 400
    assert out["trace_stage_fires"] > 0
    assert "stage p99s over" in r.stderr


def test_port_script_names_the_no_card_error(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bench.main(["--jobs", "64", "--nodes", "32"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bench.run_herd_bench(64, 32, on_log=quiet)
