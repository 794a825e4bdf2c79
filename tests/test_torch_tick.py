"""Port vs JAX: the [J, W] fire mask (exact), over random tables and windows,
the @every phase, paused and inactive rows, DOM/DOW star rules and a DST
zone.  Mirrors tests/test_tick.py's fire-mask cases."""

import datetime as dt
import random
from datetime import timezone
from zoneinfo import ZoneInfo

import numpy as np
import pytest

from cronsun_tpu.ops import schedule_table as jst
from cronsun_tpu.ops.tick import fire_mask as jax_fire_mask
from cronsun_tpu_torch.ops import schedule_table as tst
from cronsun_tpu_torch.ops.tick import fire_mask
from cronsun_tpu_torch.synth import synth_state
from torch_parity import jax_table, one_torch_thread  # noqa: F401

UTC = timezone.utc

SPEC_CORPUS = [
    "* * * * * *", "0 * * * * *", "0 0 * * * *", "0 0 0 * * *",
    "5 4 3 2 1 ?", "*/15 * * * * *", "0 */5 * * * *",
    "30 30 14 ? * Mon-Fri", "0 0 12 1,15 * ?", "0 0 0 29 2 ?",
    "1-5 10-20/3 6-18 * * *", "0 0 0 ? * 0", "0 0 0 * 2 1", "7 7 7 7 7 ?",
    "59 59 23 31 12 *", "0 0 0 1 * Sun", "@hourly", "@daily", "@weekly",
    "@monthly", "@yearly", "@every 10s", "@every 1m30s", "@every 7s",
]


def _both(specs, **kw):
    return (jst.build_table(specs, **kw),
            tst.build_table(specs, device="cpu", **kw))


def _assert_masks_equal(jt, tt, start, W, tz=UTC):
    ref = np.asarray(jax_fire_mask(jt, start, W, tz=tz))
    got = fire_mask(tt, start, W, tz=tz)
    assert got.dtype.is_floating_point is False and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(ref, got.numpy())
    return ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fire_mask_matches_jax_random_windows(seed):
    rng = random.Random(seed)
    jt, tt = _both(SPEC_CORPUS, phase_epoch_s=1_650_000_000 + seed)
    for _ in range(4):
        start = rng.randrange(1_600_000_000, 2_000_000_000)
        ref = _assert_masks_equal(jt, tt, start, rng.choice([1, 8, 120]))
        assert not ref[len(SPEC_CORPUS):].any()   # padded rows never fire


def test_fire_mask_matches_jax_synth_table():
    st = synth_state(2048, 32, seed=5)
    st["paused"][::7] = True
    st["active"][::11] = False
    jt = jax_table(st)
    tt = tst.table_from_numpy(st, device="cpu")
    ref = _assert_masks_equal(jt, tt, 1_753_000_000, 90)
    assert ref.any() and not ref[::7].any() and not ref[::11].any()


def test_fire_mask_every_modular_phase():
    t0 = 1_700_000_000
    jt, tt = _both(["@every 10s", "@every 1m30s"], phase_epoch_s=t0)
    ref = _assert_masks_equal(jt, tt, t0, 200)
    assert ref[0].tolist() == [(w % 10) == 0 for w in range(200)]
    assert ref[1].tolist() == [(w % 90) == 0 for w in range(200)]


def test_paused_and_inactive_rows_do_not_fire():
    specs = ["* * * * * *"] * 3
    jt = jst.deactivate_rows(
        jst.build_table(specs, paused=[False, True, False]), np.array([2]))
    tt = tst.deactivate_rows(
        tst.build_table(specs, paused=[False, True, False], device="cpu"),
        np.array([2]))
    ref = _assert_masks_equal(jt, tt, 1_700_000_000, 5)
    assert ref[0].all() and not ref[1].any() and not ref[2].any()


def test_dom_dow_star_rules():
    # both restricted: OR; either a star: AND (node/cron/spec.go:149-158)
    specs = ["0 0 12 13 * Fri", "0 0 12 13 * *", "0 0 12 * * Fri",
             "0 0 12 ? * Fri", "0 0 12 13 * ?"]
    jt, tt = _both(specs)
    for day in range(1, 32):
        start = int(dt.datetime(2026, 3, day, 12, tzinfo=UTC).timestamp())
        _assert_masks_equal(jt, tt, start, 1)


def test_fire_mask_dst_zone_window():
    tz = ZoneInfo("America/New_York")
    # spring forward 2026-03-08 07:00 UTC (02:00 EST -> 03:00 EDT)
    start = int(dt.datetime(2026, 3, 8, 6, 58, tzinfo=UTC).timestamp())
    jt, tt = _both(["0 * 2 * * *", "0 30 1-3 * * *", "*/20 * * * * *",
                    "@every 77s"], phase_epoch_s=start)
    _assert_masks_equal(jt, tt, start, 300, tz=tz)
    # fall back 2026-11-01 06:00 UTC: the 01:xx hour repeats
    start = int(dt.datetime(2026, 11, 1, 5, 0, tzinfo=UTC).timestamp())
    ref = _assert_masks_equal(jt, tt, start, 7200, tz=tz)
    assert ref[1].sum() == 2     # 01:30 fires in both copies of the hour
