"""Port vs JAX: build_table / update_rows / deactivate_rows, column for column
as bit patterns (exact)."""

import random

import numpy as np
import pytest

from cronsun_tpu.ops import schedule_table as jst
from cronsun_tpu_torch.convert import planner_from_numpy, planner_to_numpy
from cronsun_tpu_torch.ops import schedule_table as tst
from cronsun_tpu_torch.synth import MIXED_SPECS, synth_state
from torch_parity import one_torch_thread  # noqa: F401

_FIELDS = ["*", "*/5", "0", "1-5", "10-20/3", "3,7,11", "?"]


def _random_specs(rng: random.Random, n: int):
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            out.append(f"@every {rng.randint(1, 400)}s")
        elif r < 0.3:
            out.append(rng.choice(["@hourly", "@daily", "@weekly", "@monthly"]))
        else:
            f = [rng.choice(_FIELDS[:6]) for _ in range(3)]
            out.append(" ".join(f + [rng.choice(["*", "1,15", "?"]),
                                     rng.choice(["*", "1-6", "Feb"]),
                                     rng.choice(["*", "?", "Mon-Fri", "0"])]))
    return out


def _assert_table_equal(jax_table, torch_table):
    got = tst.table_to_numpy(torch_table)
    assert set(got) == set(tst.DTYPES)
    for k, dt in tst.DTYPES.items():
        ref = np.asarray(getattr(jax_table, k))
        assert ref.dtype == got[k].dtype == dt, k
        np.testing.assert_array_equal(ref, got[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_table_matches_jax(seed):
    rng = random.Random(seed)
    specs = _random_specs(rng, 40)
    paused = [rng.random() < 0.2 for _ in specs]
    kw = dict(capacity=64, phase_epoch_s=1_700_000_123 + seed, paused=paused)
    _assert_table_equal(jst.build_table(specs, **kw),
                        tst.build_table(specs, device="cpu", **kw))


def test_build_table_default_capacity_and_empty():
    specs = ["0 * * * * *"] * 5
    t = tst.build_table(specs, device="cpu")
    assert t.capacity == 8 == jst.build_table(specs).capacity
    _assert_table_equal(jst.build_table([], capacity=4),
                        tst.build_table([], capacity=4, device="cpu"))
    with pytest.raises(ValueError):
        tst.build_table(specs, capacity=2, device="cpu")


def test_update_and_deactivate_rows_match_jax():
    rng = random.Random(9)
    specs = _random_specs(rng, 20)
    jt = jst.build_table(specs, capacity=32)
    tt = tst.build_table(specs, capacity=32, device="cpu")
    idx = np.array([3, 0, 25, 31])
    rows = [jst.make_row(s, phase_epoch_s=1_700_000_000, tenant=i,
                         jitter=7 * i)
            for i, s in enumerate(_random_specs(rng, 4))]
    rows[1] = jst.make_dep_row([5, jst.DEP_BROKEN], policy=2, tenant=3)
    jt = jst.update_rows(jt, idx, rows)
    tt = tst.update_rows(tt, idx, rows)
    _assert_table_equal(jt, tt)
    _assert_table_equal(jst.deactivate_rows(jt, np.array([25, 3])),
                        tst.deactivate_rows(tt, np.array([25, 3])))


def test_make_rows_match_jax():
    for s in MIXED_SPECS + ("@every 0s", "59 59 23 31 12 6"):
        assert tst.make_row(s, phase_epoch_s=1_600_000_007) == \
            jst.make_row(s, phase_epoch_s=1_600_000_007)
    assert tst.make_dep_row([1, 2], policy=1, paused=True, tenant=4) == \
        jst.make_dep_row([1, 2], policy=1, paused=True, tenant=4)
    assert (tst.MAX_DEPS, tst.FRAMEWORK_EPOCH, tst.DEP_EMPTY,
            tst.DEP_BROKEN) == (8, jst.FRAMEWORK_EPOCH, jst.DEP_EMPTY,
                                jst.DEP_BROKEN)


def test_state_round_trip_is_bit_exact():
    st = synth_state(256, 64, seed=4)
    st["sec_lo"][:] = 0xFFFFFFFF        # high bit set: must survive as uint32
    p = planner_from_numpy(st, device="cpu")
    back = planner_to_numpy(p)
    assert set(back) == set(st)
    for k, v in st.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the planner owns copies: editing the caller's arrays changes nothing
    st["elig"][:] = 0
    assert planner_to_numpy(p)["elig"].any()
