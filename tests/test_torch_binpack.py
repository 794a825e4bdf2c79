"""The planner's bulk releases (``TickPlanner.jobs_finished`` and
``commons_finished``) on the CPU: equal bit for bit to loops of the
per-call releases, recorded in the window they precede; the port against
the JAX planner over windows whose nodes fill and free; and the
benchmark's bin-packing cell, end to end at a few thousand rows, with a
reference that loads nothing of the program."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import spans
from cronsun_tpu_torch.synth import synth_state
from torch_parity import (assert_plans_equal, assert_state_equal,  # noqa: F401
                          jax_planner_from_state, one_torch_thread,
                          time_limit)

T0 = 1_753_000_000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits_of(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _eligible_nodes(elig: np.ndarray, row: int) -> np.ndarray:
    words = elig[row].astype(np.uint32)
    n = np.arange(len(words) * 32)
    return n[(words[n // 32] >> (n % 32).astype(np.uint32)) & 1 == 1]


def _loaded(seed=3, J=1024, N=64):
    st = synth_state(J, N, seed=seed, specs=None, node_cap=3)
    pair = [planner_from_numpy(st, device="cpu") for _ in range(2)]
    for p in pair:
        p.plan_window(T0, 8)
    return st, pair


@pytest.mark.parametrize("case", ["distinct", "repeated", "scalar_cost",
                                  "empty"])
def test_bulk_releases_equal_loops_of_the_per_call_ones(case):
    st, (bulk, loop) = _loaded()
    rng = np.random.default_rng(7)
    n = 0 if case == "empty" else 60
    cols = (rng.choice(64, n, replace=False) if case == "distinct"
            else rng.integers(0, 8 if case == "repeated" else 64, n))
    rows = rng.integers(0, 1024, n // 2)
    costs = (np.float32(3.0) if case == "scalar_cost"
             else rng.integers(1, 5, n).astype(np.float32))
    rcosts = (np.float32(2.0) if case == "scalar_cost"
              else rng.integers(1, 5, len(rows)).astype(np.float32))
    before = bulk.rem_cap.clone()
    bulk.jobs_finished(cols, costs)
    bulk.commons_finished(rows, rcosts)
    # repeated columns add up
    assert np.array_equal((bulk.rem_cap - before).numpy(),
                          np.bincount(cols, minlength=64))
    for c, w in zip(cols, np.broadcast_to(costs, cols.shape)):
        loop.job_finished(int(c), float(w))
    for r, w in zip(rows, np.broadcast_to(rcosts, rows.shape)):
        for node in _eligible_nodes(st["elig"], int(r)):
            loop.common_finished(int(node), float(w))
    assert np.array_equal(bulk.rem_cap.numpy(), loop.rem_cap.numpy())
    assert np.array_equal(_bits_of(bulk.load), _bits_of(loop.load))
    # the next windows plan alike
    assert_plans_equal(loop.plan_window(T0 + 8, 8),
                       bulk.plan_window(T0 + 8, 8))


def test_bulk_releases_refuse_indexes_out_of_range():
    _st, (p, _q) = _loaded()
    with pytest.raises(IndexError):
        p.jobs_finished([0, 64], [1.0, 1.0])
    with pytest.raises(IndexError):
        p.commons_finished([-1], [1.0])
    assert np.array_equal(p.rem_cap.numpy(), _q.rem_cap.numpy())


def test_a_release_is_recorded_in_the_window_it_precedes():
    _st, (p, _q) = _loaded()
    first = p.spans.windows()[-1]
    p.jobs_finished([1, 2, 2], [1.0, 1.0, 1.0])
    p.commons_finished([5, 9], [1.0, 2.0])
    plans = p.gather_window(p.plan_window_async(T0 + 8, 8))
    w = p.spans.windows()[-1]
    names = [s.name for s in w.spans()]
    assert names[:3] == [spans.RELEASE, spans.RELEASE, "cronsun.plan.dispatch"]
    assert all(s.parent == -1 for s in w.spans()[:3])
    assert spans.RELEASE not in [s.name for s in first.spans()]
    unplaced = sum(int((pl.assigned[:pl.n_excl] < 0).sum()) for pl in plans)
    assert w.counts == {spans.UNPLACED: unplaced}
    assert p.spans.totals.snapshot()[spans.RELEASE]["count"] == 2


def _released(plans, run, cost, due):
    """File each placement and Common fire by the second it ends."""
    for pl in plans:
        nx = pl.n_excl
        for row, col in zip(pl.fired[:nx], pl.assigned[:nx]):
            if col >= 0:
                due.setdefault(pl.epoch_s + run[row], []).append(
                    ("x", int(col), float(cost[row])))
        for row in pl.fired[nx:]:
            due.setdefault(pl.epoch_s + run[row], []).append(
                ("c", int(row), float(cost[row])))


def test_the_port_matches_jax_over_windows_whose_nodes_fill_and_free():
    """24 windows of W = 8 at 4096 rows x 256 nodes of 3 slots: before
    each window every run that has ended is released, on the JAX planner
    by its per-call releases (a Common run's cost summed per node), on the
    port by the bulk ones.  Plans, loads and capacities equal bit for bit."""
    st = synth_state(4096, 256, seed=19, specs=None, node_cap=3)
    jp = jax_planner_from_state(st, max_fire_bucket=512)
    tp = planner_from_numpy(st, device="cpu", max_fire_bucket=512)
    rng = np.random.default_rng(5)
    run = np.ceil(rng.uniform(0.2, 0.8, 4096)
                  * st["period"].astype(np.float64)).astype(np.int64)
    cost, elig = st["cost"], st["elig"]
    due: dict = {}
    unplaced = freed = 0
    with time_limit(120, "the bin-packing differential"):
        for k in range(24):
            e = T0 + 8 * k
            ended = [x for t in sorted(due) if t <= e for x in due.pop(t)]
            xs = [(c, w) for kind, c, w in ended if kind == "x"]
            cs = [(r, w) for kind, r, w in ended if kind == "c"]
            freed += len(xs)
            for c, w in xs:
                jp.job_finished(c, w)
            per_node = np.zeros(256)
            for r, w in cs:
                per_node[_eligible_nodes(elig, r)] += w
            for node in np.nonzero(per_node)[0]:
                jp.common_finished(int(node), float(per_node[node]))
            tp.jobs_finished([c for c, _ in xs], [w for _, w in xs])
            tp.commons_finished([r for r, _ in cs], [w for _, w in cs])
            assert_state_equal(jp, tp)
            ref = jp.plan_window(e, 8)
            got = tp.plan_window(e, 8)
            assert_plans_equal(ref, got)
            assert_state_equal(jp, tp)
            _released(got, run, cost, due)
            unplaced += sum(int((pl.assigned[:pl.n_excl] < 0).sum())
                            for pl in got)
    # the nodes filled (fires left unplaced) and freed (slots released)
    assert unplaced > 0 and freed > 0
    assert int(tp.rem_cap.min()) == 0


def _tiny_pkg(dest):
    """The benchmark's configurations, mixes and readers at a few thousand
    rows under ``dest`` (the harness's ``pkg``)."""
    from portbench.tests.conftest import make_tiny
    make_tiny(str(dest))
    path = os.path.join(str(dest), "configs", "binpack_1m_x_10k.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(jobs=4096, nodes=256, node_cap=3, warm_windows=1,
               trace_windows=3)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(dest)


def test_the_binpack_cell_agrees_with_its_reference_on_the_cpu(tmp_path):
    from portbench import harness
    pkg = _tiny_pkg(tmp_path / "portbench")
    line, checks, info = harness.run_cell("binpack_steady", 2**33 + 5, 1.0,
                                          True, device="cpu", pkg=pkg)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert {n for n, _v, _l in checks} == {
        "due_mismatch_seconds", "ineligible_placements",
        "over_capacity_placements", "unplaced_with_capacity",
        "capacity_mismatch_nodes", "load_rel_gap", "bid_excess"}
    # nodes filled: fires were left unplaced in every timed window
    assert info["timed_windows_with_unplaced"] == 1.0
    assert 0 < info["unplaced_share"] < 1
    assert info["full_node_second_share"] > 0.5


def test_the_binpack_reference_loads_nothing_of_the_program():
    code = ("import sys, json, portbench.binpack_reference\n"
            "print(json.dumps(sorted(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    tops = {m.partition(".")[0]
            for m in json.loads(r.stdout.strip().splitlines()[-1])}
    assert "torch" in tops
    assert not tops & {"cronsun_tpu_torch", "cronsun_tpu", "jax", "jaxlib"}
