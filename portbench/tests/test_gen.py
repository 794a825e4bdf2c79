"""The generator is deterministic in ``--seed``, and a seed changes the
draws."""

import torch

from portbench import gen, harness


def _spec(tiny, cell):
    return harness.cell_spec(cell, pkg=tiny)


def _rows(tiny, cell, seed):
    s = _spec(tiny, cell)
    return gen.planner_inputs(s.config, s.traffic, seed, "cpu")


def test_planner_rows_repeat_for_a_seed(tiny):
    for seed in (0, 7, 2**31 + 5, 3 * 2**40, -3):
        a, b = _rows(tiny, "headline_steady", seed), \
            _rows(tiny, "headline_steady", seed)
        for k in ("family", "period", "anchor", "exclusive", "cost", "elig"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (seed, k)


def test_planner_rows_differ_between_seeds(tiny):
    a, b = _rows(tiny, "headline_steady", 1), _rows(tiny, "headline_steady", 2)
    assert not torch.equal(a.elig, b.elig)
    assert not torch.equal(a.period, b.period)


def test_the_common_mix_draws_the_same_rows_all_common(tiny):
    a, b = _rows(tiny, "headline_steady", 9), _rows(tiny, "headline_common", 9)
    for k in ("period", "anchor", "elig", "cost"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert not bool(b.exclusive.any())
    assert 0.4 < float(a.exclusive.float().mean()) < 0.6


def test_planner_rows_keep_the_mix(tiny):
    a = _rows(tiny, "headline_steady", 4)
    assert bool(a.is_every.all())
    assert int(a.period.min()) >= 35 and int(a.period.max()) < 70
    phase = a.anchor - gen.ANCHOR_EPOCH
    assert bool((phase >= 0).all()) and bool((phase < a.period).all())
    bits = ((a.elig[:, :, None] >> torch.arange(32, dtype=torch.int32)) & 1)
    assert 0.48 < float(bits.float().mean()) < 0.52
