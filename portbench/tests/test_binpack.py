"""The bin-packing cell on the CPU at a few thousand rows: the reference's
sound play passes, each control is refused by the check it names, the
program broken underneath the runner reads not correct (a release on the
wrong column, a release that keeps the load, an accept that ignores the
free slots, half the exclusive placements dropped), a program without the
bulk releases is refused at once, and the cell's readers read the
program's spans and counters."""

import json
import os
import statistics
from types import SimpleNamespace

import pytest
import torch

from portbench import binpack_reference as bref
from portbench import gen, harness

from .conftest import make_tiny

SEED = 2**32 + 17
CARD = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
TINY = {"jobs": 4096, "nodes": 256, "node_cap": 3, "warm_windows": 1,
        "trace_windows": 3}


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    dest = make_tiny(str(tmp_path_factory.mktemp("binpack")))
    path = os.path.join(dest, "configs", "binpack_1m_x_10k.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def _control(pkg, kind, windows=50):
    spec = harness.cell_spec("binpack_steady", pkg=pkg)
    cfg, mix = spec.config, spec.traffic
    inp = gen.planner_inputs(cfg, mix, SEED, "cpu")
    run = bref.run_seconds(cfg, inp, SEED)
    bucket = tuple(mix["sla_bucket"])
    kw = bref.CONTROLS[kind][0] if kind != "sound" else {}
    seconds, releases, load, rem = bref.control_binpack(
        inp, bucket, int(cfg["window_s"]), int(mix["start_epoch"]), windows,
        int(cfg["pipeline"]), run, **kw)
    checks, _att, _bad, _info = bref.check_binpack(
        inp, bucket, int(cfg["window_s"]), seconds, releases, run, load, rem,
        cfg["limits"], SEED)
    return {n: (v, lim) for n, v, lim in checks}


def test_the_reference_played_soundly_passes(pkg):
    got = _control(pkg, "sound")
    assert all(v <= lim for v, lim in got.values()), got
    assert got["bid_excess"][0] == 0.0 and got["load_rel_gap"][0] == 0.0


@pytest.mark.parametrize("kind", sorted(bref.CONTROLS))
def test_each_control_is_refused_by_its_check(pkg, kind):
    got = _control(pkg, kind)
    check = bref.CONTROLS[kind][1]
    v, lim = got[check]
    assert v > lim, (kind, got)
    if lim:
        assert v > 10 * lim, (kind, v)
    # the guarantees the control keeps hold
    assert got["due_mismatch_seconds"][0] == 0
    assert got["ineligible_placements"][0] == 0


def _run(pkg, trace=False):
    line, checks, info = harness.run_cell("binpack_steady", SEED, 1.0, trace,
                                          device="cpu", pkg=pkg)
    return line, {n: v for n, v, _l in checks}, info


def _broken(monkeypatch, fault):
    from cronsun_tpu_torch.ops import assign
    from cronsun_tpu_torch.ops import planner as pl
    if fault == "release_wrong_column":
        orig = pl.TickPlanner.jobs_finished

        def jobs_finished(self, cols, costs):
            return orig(self, (torch.as_tensor(cols) + 1) % self.N, costs)
        monkeypatch.setattr(pl.TickPlanner, "jobs_finished", jobs_finished)
    elif fault == "release_keeps_load":
        orig = pl.TickPlanner.jobs_finished

        def jobs_finished(self, cols, costs):
            return orig(self, cols, 0.0)
        monkeypatch.setattr(pl.TickPlanner, "jobs_finished", jobs_finished)
        monkeypatch.setattr(pl.TickPlanner, "commons_finished",
                            lambda self, rows, costs: None)
    elif fault == "drop_half_placements":
        orig = pl._assign_excl

        def assign_excl(valid, elig, load, rem_cap, cost, rounds, rows=None):
            """Every other placement of the bucket lost: the fire reported
            unplaced, its slot and cost given back."""
            assigned, load, rem_cap = orig(valid, elig, load, rem_cap, cost,
                                           rounds, rows=rows)
            k = torch.arange(assigned.shape[0], device=assigned.device)
            lost = (assigned >= 0) & (k % 2 == 1)
            col = assigned.clamp(min=0).long()
            rem_cap = rem_cap.index_add(0, col, lost.to(rem_cap.dtype))
            load = load.index_add(0, col, torch.where(
                lost, -cost.to(load.dtype), 0.0))
            return torch.where(lost, -1, assigned), load, rem_cap
        monkeypatch.setattr(pl, "_assign_excl", assign_excl)
    elif fault == "accept_ignores_slots":
        orig = assign.waterfill_accept_plain
        big = 1 << 20

        def accept(cand, choice, cost, load, rem_cap, is_final):
            ok, load, cap = orig(cand, choice, cost, load, rem_cap + big,
                                 is_final)
            return ok, load, cap - big
        monkeypatch.setattr(assign, "waterfill_accept_plain", accept)


@pytest.mark.parametrize("fault,check", [
    ("release_wrong_column", "capacity_mismatch_nodes"),
    ("release_keeps_load", "load_rel_gap"),
    ("accept_ignores_slots", "over_capacity_placements"),
    ("drop_half_placements", "unplaced_with_capacity")])
def test_a_broken_program_is_not_correct(pkg, monkeypatch, fault, check):
    line, _c, _i = _run(pkg)
    assert line["correct"], line["checks"]
    _broken(monkeypatch, fault)
    line, checks, _info = _run(pkg)
    assert not line["correct"]
    assert checks[check] > line["checks"][check]["limit"], line["checks"]


def test_an_unplaced_fire_is_held_to_the_least_load_it_could_bid():
    """One unplaced row eligible for nodes 0-3: node 1 filled on a start
    load of 40, node 2 is still open on 10, nodes 0 and 3 on 50.  Its last
    bid had to go to the
    least-loaded open node, so node 1 cannot have refused it: the excess is
    (40 - 10 - a) over the mean load, a = 1 from the one placement.  With
    node 2 at 39.5 it is within a."""
    elig = torch.tensor([[0b1111], [0b0001]], dtype=torch.int32)
    inp = SimpleNamespace(elig=elig, nodes=32,
                          cost=torch.ones(2, dtype=torch.float32))
    load = torch.full((32,), 50.0, dtype=torch.float64)
    load[1], load[2] = 40.0, 10.0
    open_n = torch.ones(32, dtype=torch.bool)
    open_n[1] = False
    filled = ~open_n
    one = torch.tensor([1])
    args = (torch.tensor([0]), one, torch.tensor([0]))
    got = bref._unplaced_excess(inp, load, open_n, filled, *args)
    assert got == pytest.approx((40 - 10 - 1) / float(load.mean()))
    load[2] = 39.5
    assert bref._unplaced_excess(inp, load, open_n, filled, *args) == 0.0
    # a fire with no eligible node that filled is the count's to judge
    assert bref._unplaced_excess(inp, load, open_n, filled, one, one,
                                 torch.tensor([0])) == 0.0


def test_costs_of_several_values_are_released_and_judged(pkg, tmp_path):
    """The runner gathers each run's own cost when the rows' costs
    differ, and the reference sums them again."""
    import shutil
    other = str(tmp_path / "costs")
    shutil.copytree(pkg, other)
    path = os.path.join(other, "configs", "binpack_1m_x_10k.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["cost"] = [1, 4]
    with open(path, "w") as f:
        json.dump(cfg, f)
    line, _checks, _info = harness.run_cell("binpack_steady", SEED, 1.0,
                                            False, device="cpu", pkg=other)
    assert line["correct"], line["checks"]


def test_a_program_without_bulk_releases_is_refused_at_once(pkg,
                                                           monkeypatch):
    from cronsun_tpu_torch.ops import planner as pl
    monkeypatch.delattr(pl.TickPlanner, "jobs_finished")
    with pytest.raises(SystemExit) as e:
        harness.run_cell("binpack_steady", SEED, 1.0, False, device="cpu",
                         pkg=pkg)
    assert "bulk releases" in str(e.value)


def test_the_cells_readers_read_the_programs_windows(pkg):
    """A traced run's counters and spans (the CPU's standing in for the
    card's): the readers find the release spans and the unplaced counts of
    the windows planned with no profiler running, and nothing off the
    card."""
    from cronsun_tpu_torch.ops import spans
    line, _c, info = _run(pkg, trace=True)
    assert line["correct"], line["checks"]
    rec = spans.newest()
    ws = [w for w in rec.windows() if not w.profiled]
    assert any(w.profiled for w in rec.windows())
    unplaced = [w.counts.get(spans.UNPLACED, 0) / w.seconds for w in ws]
    release = [sum(s.end_ns - s.start_ns for s in w.spans()
                   if s.name == spans.RELEASE) * 1e-6 / w.seconds
               for w in ws]
    assert max(unplaced) > 0 and max(release) > 0
    assert harness.reader("unplaced_per_tick")(CARD) == pytest.approx(
        statistics.median(unplaced))
    assert harness.reader("release_host_ms")(CARD) == pytest.approx(
        statistics.median(release))
    for name in ("unplaced_per_tick", "release_host_ms"):
        assert harness.reader(name)(SimpleNamespace(device_kind="cpu")) \
            is None
