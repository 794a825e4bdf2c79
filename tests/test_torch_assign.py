"""Port vs JAX: assign, _assign_excl, waterfill_accept and _compact, exact
(integer costs keep every float sum exact), plus the properties of
tests/test_assign.py for the port."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cronsun_tpu.ops import assign as jas
from cronsun_tpu.ops.planner import _compact as jax_compact
from cronsun_tpu_torch.ops import assign as tas
from cronsun_tpu_torch.ops.eligibility import pack_bitmask
from cronsun_tpu_torch.ops.planner import _compact
from torch_parity import bits, one_torch_thread  # noqa: F401


def _bucket(seed, K, N, density=0.5, cap=6, fire_p=0.8, excl_p=0.6):
    rng = np.random.default_rng(seed)
    w32 = (N + 31) // 32
    elig = rng.random((K, N)) < density
    elig[rng.random(K) < 0.05] = False            # no eligible node at all
    packed = np.stack([pack_bitmask(np.nonzero(r)[0].tolist(), w32)
                       for r in elig])
    return dict(
        fire=rng.random(K) < fire_p, packed=packed,
        exclusive=rng.random(K) < excl_p,
        load=rng.integers(0, 5, N).astype(np.float32),
        rem_cap=np.where(rng.random(N) < 0.1, 0, cap).astype(np.int32),
        cost=rng.integers(1, 5, K).astype(np.float32)), elig


def _jax_args(d):
    return (jnp.asarray(d["fire"]), jnp.asarray(d["packed"]),
            jnp.asarray(d["exclusive"]), jnp.asarray(d["load"]),
            jnp.asarray(d["rem_cap"]), jnp.asarray(d["cost"]))


def _torch_args(d):
    return (torch.from_numpy(d["fire"]), bits(d["packed"]),
            torch.from_numpy(d["exclusive"]), torch.from_numpy(d["load"]),
            torch.from_numpy(d["rem_cap"]), torch.from_numpy(d["cost"]))


def _assert_equal(ref, got):
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("seed,K,N,rounds", [(0, 256, 40, 2), (1, 256, 96, 3),
                                             (2, 512, 320, 1), (3, 512, 8, 2)])
def test_assign_matches_jax(seed, K, N, rounds):
    d, _ = _bucket(seed, K, N)
    ref = jas.assign(*_jax_args(d), rounds=rounds, impl="jnp")
    got = tas.assign(*_torch_args(d), rounds=rounds)
    _assert_equal(ref, got)
    assert (got[0] >= 0).any()


@pytest.mark.parametrize("seed,rounds", [(4, 2), (5, 3)])
def test_assign_excl_matches_jax(seed, rounds):
    d, _ = _bucket(seed, 512, 128, cap=3)
    valid = d["fire"] & d["exclusive"]
    ref = jas._assign_excl(jnp.asarray(valid), jnp.asarray(d["packed"]),
                           jnp.asarray(d["load"]), jnp.asarray(d["rem_cap"]),
                           jnp.asarray(d["cost"]), rounds, "jnp")
    got = tas._assign_excl(torch.from_numpy(valid), bits(d["packed"]),
                           torch.from_numpy(d["load"]),
                           torch.from_numpy(d["rem_cap"]),
                           torch.from_numpy(d["cost"]), rounds)
    _assert_equal(ref, got)


@pytest.mark.parametrize("is_final", [False, True])
def test_waterfill_accept_matches_jax(is_final):
    rng = np.random.default_rng(8)
    K, N = 400, 16
    cand = rng.random(K) < 0.7
    choice = rng.integers(0, N, K).astype(np.int32)
    cost = rng.integers(1, 4, K).astype(np.float32)
    load = rng.integers(0, 20, N).astype(np.float32)
    rem_cap = rng.integers(0, 30, N).astype(np.int32)
    ref = jas.waterfill_accept(*map(jnp.asarray, (cand, choice, cost, load,
                                                  rem_cap)), is_final)
    got = tas.waterfill_accept(*map(torch.from_numpy, (cand, choice, cost, load,
                                                       rem_cap)), is_final)
    _assert_equal(ref, got)


@pytest.mark.parametrize("J,k,p", [(1024, 64, 0.05), (1024, 512, 0.3),
                                   (2048, 16, 0.5), (1000, 64, 0.05),
                                   (777, 1024, 0.5), (1024, 32, 0.0)])
def test_compact_matches_jax_and_nonzero(J, k, p):
    rng = np.random.default_rng(J + k)
    fire = rng.random(J) < p
    ri, rv, rt = jax_compact(jnp.asarray(fire), k)
    gi, gv, gt = _compact(torch.from_numpy(fire), k)
    assert gi.dtype == torch.int32 and gv.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(ri), gi.numpy())
    np.testing.assert_array_equal(np.asarray(rv), gv.numpy())
    assert int(rt) == int(gt) == fire.sum()
    nz = np.nonzero(fire)[0][:k]
    np.testing.assert_array_equal(gi.numpy()[:len(nz)], nz)


def test_choose_impl_names_the_device_route():
    assert tas.choose_impl(torch.device("cpu")) == "plain"
    assert tas.choose_impl("cuda") == "cuda"


# ----------------------------------------------------- properties (port only)

def _mk(J, N, elig_np, fire_np, excl_np, cap=10**6, cost=None):
    w32 = (N + 31) // 32
    packed = np.stack([pack_bitmask(np.nonzero(elig_np[j])[0].tolist(), w32)
                       for j in range(J)])
    return (torch.from_numpy(fire_np), bits(packed),
            torch.from_numpy(excl_np), torch.zeros(N),
            torch.full((N,), cap, dtype=torch.int32),
            torch.from_numpy(cost if cost is not None
                             else np.ones(J, np.float32)))


def test_assign_respects_eligibility_and_balances():
    rng = np.random.default_rng(0)
    J, N = 256, 16
    elig = rng.random((J, N)) < 0.5
    elig[:, 0] = True
    a, _, _ = tas.assign(*_mk(J, N, elig, np.ones(J, bool), np.ones(J, bool)))
    a = a.numpy()
    assert (a >= 0).all() and all(elig[j, a[j]] for j in range(J))
    assert np.bincount(a, minlength=N).max() <= 48


def test_assign_capacity_never_exceeded():
    J, N = 128, 4
    a, _, rem = tas.assign(*_mk(J, N, np.ones((J, N), bool), np.ones(J, bool),
                                np.ones(J, bool), cap=5))
    a = a.numpy()
    counts = np.bincount(a[a >= 0], minlength=N)
    assert (counts <= 5).all() and counts.sum() == 20
    assert (a < 0).sum() == J - 20 and rem.tolist() == [0, 0, 0, 0]


def test_assign_no_eligible_gives_minus_one():
    J, N = 64, 8
    a, load, _ = tas.assign(*_mk(J, N, np.zeros((J, N), bool),
                                 np.ones(J, bool), np.ones(J, bool)))
    assert (a == -1).all() and load.sum() == 0


def test_assign_common_fans_out_into_load_only():
    J, N = 64, 8
    elig = np.zeros((J, N), bool)
    elig[:, [2, 5]] = True
    fire = np.zeros(J, bool)
    fire[:10] = True
    a, load, _ = tas.assign(*_mk(J, N, elig, fire, np.zeros(J, bool),
                                 cost=np.full(J, 2.0, np.float32)))
    assert (a == -1).all()
    assert load[2] == 20.0 and load[5] == 20.0 and load.sum() == 40.0


def test_assign_prefers_lighter_nodes_and_is_deterministic():
    J, N = 64, 2
    f, p, e, _, cap, cost = _mk(J, N, np.ones((J, N), bool), np.ones(J, bool),
                                np.ones(J, bool))
    load = torch.tensor([100.0, 0.0])
    a1, l1, c1 = tas.assign(f, p, e, load, cap, cost)
    a2, l2, c2 = tas.assign(f, p, e, load, cap, cost)
    counts = np.bincount(a1.numpy(), minlength=N)
    assert counts[1] > counts[0]
    assert torch.equal(a1, a2) and torch.equal(l1, l2) and torch.equal(c1, c2)
    assert load.tolist() == [100.0, 0.0]      # inputs are not modified
