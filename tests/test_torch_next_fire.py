"""Port vs JAX: batched next-fire, exact against
``cronsun_tpu.ops.tick.next_fire`` — UTC, random specs, ``@every`` from its
phase, the 5-year give-up and a longer horizon's continuation, DST spring
forward and fall back, ``first_fire_offset``, the sparse day scan, a
random DST-zone differential, row passes of the scans, and the hypothesis
differential.  Mirrors tests/test_tick.py:133-317."""

import datetime as dt
import random
from datetime import timezone
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cronsun_tpu.ops import schedule_table as jst
from cronsun_tpu.ops import tick as jtick
from cronsun_tpu_torch.cron import parse
from cronsun_tpu_torch.cron.schedule import next_after
from cronsun_tpu_torch.ops import next_fire, tick
from cronsun_tpu_torch.ops import schedule_table as tst
from cronsun_tpu_torch.ops.tick import first_fire_offset, next_fire_one
from cronsun_tpu_torch.synth import bench_mixed_specs

UTC = timezone.utc
NY = ZoneInfo("America/New_York")

SPEC_CORPUS = [
    "* * * * * *", "0 * * * * *", "0 0 * * * *", "0 0 0 * * *",
    "5 4 3 2 1 ?", "*/15 * * * * *", "0 */5 * * * *",
    "30 30 14 ? * Mon-Fri", "0 0 12 1,15 * ?", "0 0 0 29 2 ?",
    "1-5 10-20/3 6-18 * * *", "0 0 0 ? * 0", "0 0 0 * 2 1", "7 7 7 7 7 ?",
    "@hourly", "@daily", "@weekly", "@monthly", "@yearly",
]


def _epoch(t: dt.datetime) -> int:
    return int(t.timestamp())


def _both(specs, **kw):
    return (jst.build_table(specs, **kw),
            tst.build_table(specs, device="cpu", **kw))


def _same(specs, afters, tz=UTC, **kw):
    """Port == JAX for every row at every instant; returns the port's."""
    jt, tt = _both(specs, **{k: v for k, v in kw.items()
                             if k == "phase_epoch_s"})
    kw.pop("phase_epoch_s", None)
    out = []
    for after in afters:
        ref = jtick.next_fire(jt, after, tz=tz, **kw)
        got = next_fire(tt, after, tz=tz, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=f"after={after}")
        out.append(got)
    return out


def _scalar(spec, after, tz=UTC):
    want = next_after(parse(spec), dt.datetime.fromtimestamp(after, tz))
    return -1 if want is None else _epoch(want)


def test_next_fire_differential_utc():
    rng = random.Random(1234)
    afters = [rng.randrange(1_600_000_000, 1_900_000_000) for _ in range(6)]
    for after, got in zip(afters, _same(SPEC_CORPUS, afters)):
        for j, spec in enumerate(SPEC_CORPUS):
            assert got[j] == _scalar(spec, after), (spec, after)


def _rand_spec(rng):
    def field(lo, hi):
        r = rng.random()
        if r < 0.3:
            return "*" if rng.random() < 0.7 else f"*/{rng.randint(2, 20)}"
        if r < 0.6:
            return str(rng.randint(lo, hi))
        a = rng.randint(lo, hi - 1)
        s = f"{a}-{rng.randint(a + 1, hi)}"
        return s + (f"/{rng.randint(1, 9)}" if rng.random() < 0.3 else "")
    return " ".join([field(0, 59), field(0, 59), field(0, 23), field(1, 28),
                     field(1, 12), field(0, 6)])


def test_next_fire_random_specs_differential():
    rng = random.Random(99)
    specs = [_rand_spec(rng) for _ in range(60)]
    _same(specs, [rng.randrange(1_600_000_000, 1_900_000_000)
                  for _ in range(4)])


def test_next_fire_every_from_phase():
    t0 = 1_750_000_000
    got = _same(["@every 90s", "@every 1s", "@every 7m"],
                [t0, t0 + 89, t0 + 90], phase_epoch_s=t0)
    assert [g[0] for g in got] == [t0 + 90, t0 + 90, t0 + 180]


def test_next_fire_unsatisfiable_gives_up():
    got = _same(["0 0 0 30 2 ?", "0 0 0 29 2 ?"], [1_700_000_000],
                horizon_s=90 * 86400)
    assert got[0].tolist() == [-1, -1]
    # the default 5-year horizon still finds Feb 29, never Feb 30
    got = _same(["0 0 0 30 2 ?", "0 0 0 29 2 ?"], [1_700_000_000])
    assert got[0][0] == -1 and got[0][1] > 0


def test_next_fire_horizon_past_the_day_window():
    """A horizon past the fused pass's _DAY_PAD days continues in day-scan
    chunks (UTC and a DST zone)."""
    specs = ["0 0 0 29 2 ?", "0 0 0 30 2 ?", "0 0 12 13 * Fri", "@every 9s"]
    for tz in (UTC, NY):
        got = _same(specs, [1_709_500_000, 1_800_000_000], tz=tz,
                    horizon_s=10 * 366 * 86400)
        assert got[0][0] > 0 and got[0][1] == -1


def test_next_fire_dst_spring_forward():
    after = _epoch(dt.datetime(2026, 3, 8, 1, 0, tzinfo=NY))
    got = int(_same(["0 30 2 * * *"], [after], tz=NY)[0][0])
    assert got == _scalar("0 30 2 * * *", after, NY)
    loc = dt.datetime.fromtimestamp(got, NY)
    assert (loc.month, loc.day, loc.hour, loc.minute) == (3, 9, 2, 30)


def test_next_fire_dst_fall_back_fires_both_occurrences():
    jt, tt = _both(["0 30 1 * * *"])
    after = _epoch(dt.datetime(2026, 11, 1, 0, 0, tzinfo=NY))
    first = int(next_fire(tt, after, tz=NY)[0])
    second = int(next_fire(tt, first, tz=NY)[0])
    assert second == first + 3600
    assert first == int(jtick.next_fire(jt, after, tz=NY)[0])
    assert second == int(jtick.next_fire(jt, first, tz=NY)[0])
    assert next_fire_one(tt, 0, after, tz=NY) == first


def test_first_fire_offset():
    jt, tt = _both(["30 * * * * *", "0 0 0 1 1 ?", "*/7 * * * * *"])
    start = 1_700_000_000 - (1_700_000_000 % 60)
    ref = jtick.first_fire_offset(jtick.fire_mask(jt, start, 60))
    got = first_fire_offset(tick.fire_mask(tt, start, 60))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    assert got[1].tolist() == [True, False, True, False] and got[0][0] == 30
    assert got[0].dtype == torch.int32


def test_ctz_matches_numpy():
    vals = np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x00010000,
                     0x7FFFFFFF, 0xF0000000] + [1 << k for k in range(32)],
                    np.uint32)
    want = np.array([32 if v == 0 else (int(v) & -int(v)).bit_length() - 1
                     for v in vals.tolist()])
    x = torch.from_numpy(vals.view(np.int32))
    assert tick._ctz32(x).tolist() == want.tolist()
    lo = torch.from_numpy(np.array([0, 0, 8], np.uint32).view(np.int32))
    hi = torch.from_numpy(np.array([0, 4, 1], np.uint32).view(np.int32))
    assert tick._ctz64(lo, hi).tolist() == [64, 34, 3]


def test_next_fire_sparse_specs_day_scan_differential():
    rng = random.Random(7)
    specs = [f"{rng.randint(0, 59)} {rng.randint(0, 59)} {rng.randint(0, 23)} "
             f"{rng.randint(1, 28)} {rng.randint(1, 12)} ?" for _ in range(40)]
    specs += ["0 0 5 ? 3 0", "30 15 22 ? 12 6", "0 0 0 29 2 ?"]
    afters = [rng.randrange(1_600_000_000, 1_900_000_000) for _ in range(4)]
    for after, got in zip(afters, _same(specs, afters)):
        for j in range(0, len(specs), 5):
            assert got[j] == _scalar(specs[j], after)


def test_next_fire_dst_zone_random_differential():
    """Random specs in a DST zone: day-scan results on transition days are
    re-walked by the scalar engine on both sides."""
    rng = random.Random(11)
    specs = [f"{rng.randint(0, 59)} {rng.randint(0, 59)} {rng.randint(0, 23)} "
             f"{rng.randint(1, 28)} {rng.randint(1, 12)} ?" for _ in range(25)]
    specs += ["0 30 2 * * *", "0 30 1 ? * Sun", "15 0 2 8 3 ?"]
    afters = [_epoch(dt.datetime(2026, 3, 7, 12, 0, tzinfo=NY)),
              _epoch(dt.datetime(2026, 10, 31, 12, 0, tzinfo=NY)),
              1_770_000_000]
    for after, got in zip(afters, _same(specs, afters, tz=NY)):
        for j, spec in enumerate(specs):
            assert got[j] == _scalar(spec, after, NY), (spec, after)


def test_next_fire_row_passes(monkeypatch):
    """The scans run in passes of NEXT_FIRE_CHUNK rows; a table of several
    passes (the last one short) gives the JAX result."""
    rng = random.Random(3)
    specs = [_rand_spec(rng) for _ in range(45)] + SPEC_CORPUS + \
        ["@every 13s", "@every 2m"]
    monkeypatch.setattr(tick, "NEXT_FIRE_CHUNK", 16)
    afters = [1_753_000_000, _epoch(dt.datetime(2026, 3, 6, tzinfo=NY))]
    _same(specs, afters, phase_epoch_s=1_700_000_017)
    _same(specs, afters, tz=NY, horizon_s=8 * 366 * 86400)


MONTH_NAMES = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
               "sep", "oct", "nov", "dec"]
DOW_NAMES = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]


def _field_st(lo, hi, names=None):
    scalar = st.integers(lo, hi).map(str)
    if names:
        scalar = st.one_of(scalar, st.sampled_from(names))
    rng_ = st.tuples(st.integers(lo, hi), st.integers(lo, hi)).map(
        lambda ab: f"{min(ab)}-{max(ab)}")
    stepped = st.tuples(rng_, st.integers(1, 15)).map(
        lambda rs: f"{rs[0]}/{rs[1]}")
    star = st.sampled_from(["*"] + [f"*/{k}" for k in (2, 3, 5, 7, 11, 30)])
    item = st.one_of(scalar, rng_, stepped)
    lst = st.lists(item, min_size=1, max_size=3).map(",".join)
    return st.one_of(star, lst)


spec_st = st.one_of(
    st.tuples(_field_st(0, 59), _field_st(0, 59), _field_st(0, 23),
              st.one_of(_field_st(1, 28), st.just("?")),
              _field_st(1, 12, MONTH_NAMES),
              st.one_of(_field_st(0, 6, DOW_NAMES), st.just("?")),
              ).map(" ".join),
    st.integers(1, 4000).map(lambda n: f"@every {n}s"),
)


@settings(max_examples=40, deadline=None)
@given(spec=spec_st, after=st.integers(1_600_000_000, 1_950_000_000))
def test_next_fire_hypothesis_differential(spec, after):
    """Fuzzed grammar (comma lists, names, ?, @every): the port equals the
    JAX package and the scalar engine."""
    got = int(_same([spec], [after], phase_epoch_s=after)[0][0])
    if spec.startswith("@every"):
        assert got == after + int(spec.split()[1][:-1])
    else:
        assert got == _scalar(spec, after)


@pytest.mark.parametrize("tz", [UTC, NY], ids=["utc", "new_york"])
def test_bench_mix_matches_jax(tz):
    """A slice of BASELINE config 2's mixed specs (bench.py:289-302)."""
    mixed = bench_mixed_specs(500)
    t0 = 1_772_700_000
    got = _same(mixed, [t0, t0 + 37], tz=tz, phase_epoch_s=t0)
    assert (got[0][:500] >= 0).all() and (got[0][500:] == -1).all()
