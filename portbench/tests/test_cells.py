"""Each cell driven end to end on the CPU at a few thousand rows: the
reference agrees with the port, the controls come out not correct, and so
does a run with the program broken underneath it (a step that leaves its
state unchanged, half the fires left out, an answer altered where it is
produced, a bid that ignores the loads).  The chip command refuses to run
without a card; these call the harness directly."""

import pytest
import torch

from portbench import calibrate, harness, reference

SEED = 2**32 + 17


def _run(tiny, cell, seconds=1.0, trace=False, seed=SEED):
    line, checks, info = harness.run_cell(cell, seed, seconds, trace,
                                          device="cpu", pkg=tiny)
    return line, {n: v for n, v, _l in checks}, info


@pytest.mark.parametrize("cell", ["headline_steady", "headline_common"])
def test_a_planner_cell_agrees_with_the_reference(tiny, cell):
    line, checks, info = _run(tiny, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(checks) == {"due_mismatch_seconds", "ineligible_placements",
                           "unplaced_with_capacity",
                           "capacity_mismatch_nodes", "load_rel_gap",
                           "bid_excess"}
    assert set(line["metrics"]) == {"tick_ms_p99", "plan_fires_per_s",
                                    "setup_s"}


@pytest.mark.parametrize("cell", ["headline_steady", "headline_common"])
def test_the_planner_control_is_refused(tiny, cell):
    spec = harness.cell_spec(cell, pkg=tiny)
    checks, _att, _bad = calibrate.control(
        spec, SEED, (1753000000, 1753000160), torch.device("cpu"))
    got = {n: (v, lim) for n, v, lim in checks}
    assert got["load_rel_gap"][0] > 10 * got["load_rel_gap"][1]
    # its bid reads the same bfloat16 loads: the bid check may fail too
    assert all(v <= lim for n, (v, lim) in got.items()
               if n not in ("load_rel_gap", "bid_excess"))


def test_a_sound_control_passes_and_a_careless_bid_is_refused(tiny,
                                                               monkeypatch):
    """The reference's own bid in float32 passes every check; the bid over
    loads rounded to bfloat16 and the bid on the first eligible node fail
    the bid check alone, over a span long enough for the loads to pass
    bfloat16's integers."""
    spec = harness.cell_spec("headline_steady", pkg=tiny)
    span = (1753000000, 1753002000)
    monkeypatch.setitem(reference.CONTROLS, "sound", {})
    got = {}
    for kind in ("sound", "bf16_bid", "first_node"):
        checks, _att, _bad = calibrate.control(
            spec, SEED, span, torch.device("cpu"), kind)
        got[kind] = {n: (v, lim) for n, v, lim in checks}
    assert all(v <= lim for v, lim in got["sound"].values()), got["sound"]
    assert got["sound"]["bid_excess"][0] == 0.0
    for kind in ("bf16_bid", "first_node"):
        v, lim = got[kind]["bid_excess"]
        assert v > 10 * lim, (kind, v)
        assert all(v <= lim for n, (v, lim) in got[kind].items()
                   if n != "bid_excess"), (kind, got[kind])


# ------------------------------------------------------- the program broken

def _planner_faults(monkeypatch, fault):
    from cronsun_tpu_torch.ops import planner as pl
    if fault == "state_unchanged":
        orig = pl.TickPlanner._dispatch

        def dispatch(self, *a, **k):
            handle, _load, _cap, last, tok = orig(self, *a, **k)
            return handle, self.load, self.rem_cap, last, tok
        monkeypatch.setattr(pl.TickPlanner, "_dispatch", dispatch)
        return
    if fault == "bid_blind":
        from cronsun_tpu_torch.ops import assign
        orig_bid = assign.bid_argmin

        def bid(elig, load_eff, **k):
            # every open node bids as if empty: the loads are not read
            return orig_bid(elig, torch.where(torch.isfinite(load_eff),
                                              0.0, float("inf")), **k)
        monkeypatch.setattr(assign, "bid_argmin", bid)
        return
    orig = pl.TickPlanner.gather_window

    def gather(self, handle):
        plans = orig(self, handle)
        for p in plans:
            if fault == "half_left_out":
                keep = len(p.fired) // 2
                p.fired, p.assigned = p.fired[:keep], p.assigned[:keep]
                p.n_excl = min(p.n_excl, keep)
            elif fault == "answer_altered":
                a = p.assigned[:p.n_excl]
                a[a >= 0] = (a[a >= 0] + 1) % self.N
        return plans
    monkeypatch.setattr(pl.TickPlanner, "gather_window", gather)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "bid_blind"])
def test_a_broken_planner_is_not_correct(tiny, monkeypatch, fault):
    _planner_faults(monkeypatch, fault)
    line, checks, _info = _run(tiny, "headline_steady")
    assert not line["correct"]
    assert line["failed"] > 0 or fault in ("state_unchanged", "bid_blind")
    if fault == "bid_blind":
        limit = line["checks"]["bid_excess"]["limit"]
        assert checks["bid_excess"] > 10 * limit
        assert checks["ineligible_placements"] == 0
    elif fault == "state_unchanged":
        assert checks["load_rel_gap"] > 0.5
    elif fault == "half_left_out":
        assert checks["due_mismatch_seconds"] > 0
    else:
        assert checks["ineligible_placements"] > 0
