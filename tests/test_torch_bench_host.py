"""The port's host-plane benches (``cronsun_tpu_torch.scripts.bench_store``,
``bench_dispatch``, ``bench_query``, ``bench_push``) against the JAX
scripts, on the CPU, at the shapes of the JAX smoke tests
(``tests/test_bench_smoke.py``) and on the Python store and result store
(``BENCH_STORE`` / ``BENCH_LOGD`` / ``BENCH_AGENT`` = ``py``).

Each pair must give the same JSON keys and the same deterministic counts
(the rates offered, shards, readers, viewers connected, errors); the
timings differ.  Every child process a port bench spawns must run the
port: ``python -m cronsun_tpu_torch...`` (its argv is read as it is
spawned), or one of ``native/``'s servers.  The dispatch and store pairs
are slow-marked as their JAX twins are; the argv of a short dispatch run
is checked in the tier-1 set.
"""

import os
import subprocess
import sys

import pytest

from cronsun_tpu_torch.scripts import bench_dispatch as p_dispatch
from cronsun_tpu_torch.scripts import bench_push as p_push
from cronsun_tpu_torch.scripts import bench_query as p_query
from cronsun_tpu_torch.scripts import bench_store as p_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_dispatch as j_dispatch  # noqa: E402
import bench_push as j_push  # noqa: E402
import bench_query as j_query  # noqa: E402
import bench_store as j_store  # noqa: E402


def quiet(*a):
    pass


@pytest.fixture
def py_backends(monkeypatch):
    for k in ("BENCH_STORE", "BENCH_LOGD", "BENCH_AGENT"):
        monkeypatch.setenv(k, "py")


@pytest.fixture
def spawned(monkeypatch):
    """The argv of every process spawned through ``subprocess.Popen``."""
    seen = []
    real = subprocess.Popen

    class Recording(real):
        def __init__(self, args, *a, **kw):
            seen.append([str(x) for x in args])
            super().__init__(args, *a, **kw)
    monkeypatch.setattr(subprocess, "Popen", Recording)
    return seen


def assert_port_children(seen):
    assert seen, "no child process was spawned"
    native = os.path.join(ROOT, "native") + os.sep
    for argv in seen:
        if argv[0].startswith(native):
            continue
        assert argv[:2] == [sys.executable, "-m"], argv
        assert argv[2].startswith("cronsun_tpu_torch."), argv


def same_keys_and(port, jax, keys):
    assert sorted(port) == sorted(jax)
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}


QUERY_KW = dict(logd_shards=1, readers=3, seconds=1.5, seed_records=1000)
QUERY_FIXED = ("query_plane_backend", "query_plane_logd_shards",
               "query_plane_readers", "query_plane_tiering", "query_plane_write_rate_target",
               "query_plane_cold_fraction", "query_plane_aged_records",
               "query_plane_write_errors", "query_plane_read_errors",
               "query_plane_web_errors")


def test_query_bench_matches_the_jax_script(py_backends, spawned):
    port = p_query.run_query_bench(on_log=quiet, **QUERY_KW)
    assert_port_children(spawned)
    jax = j_query.run_query_bench(on_log=quiet, **QUERY_KW)
    same_keys_and(port, jax, QUERY_FIXED)
    assert port["query_plane_read_errors"] == 0
    assert port["query_plane_write_errors"] == 0
    for shape in ("latest", "history", "stat_days"):
        assert port[f"query_plane_{shape}_qps"] > 0
    assert port["query_plane_write_records_per_s"] > 0


PUSH_KW = dict(viewers=20, seconds=1.5, write_rate=50, poll_viewers=3)
PUSH_FIXED = ("push_plane_backend", "push_plane_sse_writer",
              "push_plane_logd_shards", "push_plane_viewers",
              "push_plane_viewers_connected", "push_plane_connect_errors",
              "push_plane_write_rate_target", "push_plane_poll_viewers",
              "push_plane_poll_interval_s", "push_plane_poll_errors")


def test_push_bench_matches_the_jax_script(py_backends, spawned):
    port = p_push.run_push_bench(on_log=quiet, **PUSH_KW)
    assert_port_children(spawned)
    jax = j_push.run_push_bench(on_log=quiet, **PUSH_KW)
    same_keys_and(port, jax, PUSH_FIXED)
    assert port["push_plane_viewers_connected"] == 20
    assert port["push_plane_lag_samples"] > 0
    assert port["push_plane_events_per_viewer_s"] > 0
    assert port["push_plane_publish_lag_p99_ms"] > 0


def test_a_short_dispatch_run_spawns_only_the_ports_processes(
        py_backends, spawned):
    """One agent at one rate: the store and result-store shards are
    ``cronsun_tpu_torch.bin.store`` / ``.bin.logd`` processes and the
    agent is ``python -m cronsun_tpu_torch.scripts.bench_dispatch
    --worker``, and the run drains orders."""
    res = p_dispatch.run_bench([200], 1, 1, on_log=quiet)
    assert_port_children(spawned)
    mods = [a[2] for a in spawned]
    assert mods.count("cronsun_tpu_torch.bin.store") == 1
    assert mods.count("cronsun_tpu_torch.bin.logd") == 1
    assert [a[3] for a in spawned
            if a[2] == "cronsun_tpu_torch.scripts.bench_dispatch"] == \
        ["--worker"]
    assert res["dispatch_plane_backend"] == "py+py-logd"
    assert res["dispatch_plane_orders_per_sec"] > 0


def test_the_push_ladders_children_are_the_ports(py_backends, spawned):
    """The web-replica ladder's serve, viewer and writer children run the
    port's script."""
    res = p_push.run_replica_ladder([1], viewers_per_replica=5, seconds=1.0,
                                    write_rate=20, on_log=quiet)
    assert_port_children(spawned)
    modes = sorted(a[3] for a in spawned
                   if a[2] == "cronsun_tpu_torch.scripts.bench_push")
    assert modes == ["--serve-mode", "--viewer-mode", "--writer-mode"]
    assert res["push_ladder"][0]["connected"] == [5]


@pytest.mark.slow
def test_dispatch_quick_matches_the_jax_script(py_backends, spawned):
    port = p_dispatch.run_quick(seconds=3, on_log=quiet)
    assert_port_children(spawned)
    jax = j_dispatch.run_quick(seconds=3, on_log=quiet)
    same_keys_and(port, jax, ("quick_rate_offered_per_s",
                              "quick_store_shards", "records_dropped",
                              "backend"))
    assert port["agg_1_agent_per_s"] > 0
    assert port["records_dropped"] == 0


@pytest.mark.slow
def test_store_stall_suite_matches_the_jax_script(spawned):
    port = p_store.run_stall_suite(n_keys=100_000, on_log=quiet)
    assert_port_children(spawned)
    jax = j_store.run_stall_suite(n_keys=100_000, on_log=quiet)
    assert sorted(port) == sorted(jax)
    assert port["snapshot_stall_ratio_py"] <= 0.25
