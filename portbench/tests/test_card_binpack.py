"""On the card: a short run of the bin-packing cell holds to its reference,
the program with half its exclusive placements dropped does not at the
cell's size, and the planner's bulk releases (the Common one a K2 launch)
equal the per-call releases bit for bit and wait for no stream.  Marked ``cuda``;
without a card each skips (decided in the ``card`` fixture).  On the card:
``python3 -m pytest -m cuda portbench/tests/test_card_binpack.py``."""

import numpy as np
import pytest
import torch

from portbench import harness

T0 = 1_753_000_000


@pytest.mark.cuda
def test_a_short_binpack_run_on_the_card_is_correct(card):
    line, _checks, info = harness.run_cell("binpack_steady", 2**31 + 99,
                                           3.0, False, device=card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert info["timed_windows_with_unplaced"] == 1.0
    assert info["full_node_second_share"] > 0.5


@pytest.mark.cuda
def test_half_the_placements_dropped_is_refused_at_the_cells_size(
        card, monkeypatch):
    from .test_binpack import _broken
    _broken(monkeypatch, "drop_half_placements")
    line, checks, _info = harness.run_cell("binpack_steady", 2**31 + 99,
                                           3.0, False, device=card)
    got = {n: v for n, v, _l in checks}
    assert not line["correct"]
    assert got["unplaced_with_capacity"] > 0, line["checks"]


@pytest.mark.cuda
def test_the_bulk_releases_equal_the_per_call_ones_on_the_card(card):
    from cronsun_tpu_torch.convert import planner_from_numpy
    from cronsun_tpu_torch.ops import spans
    from cronsun_tpu_torch.synth import synth_state
    st = synth_state(8192, 640, seed=23, specs=None, node_cap=4)
    bulk, loop = (planner_from_numpy(st, device=card) for _ in range(2))
    for p in (bulk, loop):
        p.plan_window(T0, 8)
    rng = np.random.default_rng(2)
    cols = rng.integers(0, 640, 300)
    costs = rng.integers(1, 5, 300).astype(np.float32)
    rows = rng.integers(0, 8192, 200).astype(np.int64)
    rcosts = rng.integers(1, 5, 200).astype(np.float32)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bulk.jobs_finished(cols, costs)
        bulk.commons_finished(rows, rcosts)
        torch.cuda.synchronize()
    waits = sum(e.count for e in prof.key_averages()
                if e.key == "cudaStreamSynchronize")
    assert waits == 0
    for c, w in zip(cols, costs):
        loop.job_finished(int(c), float(w))
    elig = st["elig"]
    n = np.arange(640)
    for r, w in zip(rows, rcosts):
        words = elig[r].astype(np.uint32)
        for node in n[(words[n // 32] >> (n % 32).astype(np.uint32)) & 1 == 1]:
            loop.common_finished(int(node), float(w))
    assert torch.equal(bulk.rem_cap, loop.rem_cap)
    assert torch.equal(bulk.load.view(torch.int32),
                       loop.load.view(torch.int32))
    for a, b in zip(bulk.plan_window(T0 + 8, 8), loop.plan_window(T0 + 8, 8)):
        assert np.array_equal(a.fired, b.fired)
        assert np.array_equal(a.assigned, b.assigned)
    names = [s.name for s in bulk.spans.windows()[-1].spans()]
    assert names[:2] == [spans.RELEASE, spans.RELEASE]
