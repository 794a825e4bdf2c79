"""Port vs JAX: the plain versions of K1 bid_argmin and K2 fanout_add (with
and without the fused row gather ``rows`` and the ``active`` mask), the tie
hash, and a numpy model of the CUDA kernel's walk of a row.

Tolerances: bid ``choice`` and ``best`` exactly equal; fan-out exactly
equal for integer weights, ``rtol=1e-5`` for fractional ones (the two sum
in different orders).  The JAX side runs the Pallas kernels in interpret
mode, as tests/test_pallas_kernels.py does, and its jnp twin.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cronsun_tpu.ops.assign import _bid_jnp, _fanout_jnp, bid_block_jnp
from cronsun_tpu.ops.pallas_kernels import _tie as jax_tie
from cronsun_tpu.ops.pallas_kernels import bid_argmin as jax_bid
from cronsun_tpu.ops.pallas_kernels import fanout_add as jax_fanout
from cronsun_tpu_torch.ops import kernels
from cronsun_tpu_torch.ops.kernels import (
    _tie, bid_argmin, bid_block_plain, fanout_add, fanout_chunks)
from torch_k1_model import k1_model, tie_from_bits
from torch_parity import bits


def _tile(seed, K, w32, n_loads=4, empty=(7,)):
    """Random bits, loads quantized to ``n_loads`` values (forced exact-score
    ties), a closed node and empty rows."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (K, w32), dtype=np.uint32)
    packed[list(empty)] = 0
    packed[K // 2] &= 0x80000001           # sparse row
    load = rng.integers(0, n_loads, w32 * 32).astype(np.float32)
    load[3] = np.inf
    return packed, load


def test_tie_matches_jax_bit_exact():
    rng = np.random.default_rng(0)
    j = rng.integers(0, 2**32, 100_000, dtype=np.uint32)
    n = rng.integers(0, 2**32, 100_000, dtype=np.uint32)
    j[:4] = [0, 1, 2**31, 2**32 - 1]
    n[:4] = [2**32 - 1, 2**31, 0, 1]
    ref = np.asarray(jax_tie(jnp.asarray(j), jnp.asarray(n)))
    got = _tie(torch.from_numpy(j.astype(np.int64)),
               torch.from_numpy(n.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(ref.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("K,w32,n_loads", [(256, 3, 4), (256, 64, 1),
                                           (512, 17, 2), (512, 64, 4)])
def test_bid_plain_matches_jax(K, w32, n_loads):
    packed, load = _tile(K + w32, K, w32, n_loads)
    b_pal, c_pal = jax_bid(jnp.asarray(packed), jnp.asarray(load),
                           interpret=True)
    b_jnp, c_jnp = _bid_jnp(jnp.asarray(packed), jnp.asarray(load))
    best, choice = bid_argmin(bits(packed), torch.from_numpy(load))
    assert best.dtype == torch.float32 and choice.dtype == torch.int32
    for b_ref, c_ref in ((b_pal, c_pal), (b_jnp, c_jnp)):
        np.testing.assert_array_equal(np.asarray(c_ref), choice.numpy())
        np.testing.assert_array_equal(np.asarray(b_ref), best.numpy())
    assert np.isinf(best[7].item()) and choice[7].item() == 0


def test_bid_all_closed_row_gives_inf_and_zero():
    packed, load = _tile(1, 256, 4)
    load[:] = np.inf
    best, choice = bid_argmin(bits(packed), torch.from_numpy(load))
    assert torch.isinf(best).all() and (choice == 0).all()


@pytest.mark.parametrize("col0,bitplane_ties", [(0, False), (96, True),
                                                (4096, False)])
def test_bid_block_plain_matches_jax(col0, bitplane_ties):
    packed, load = _tile(3, 256, 5, n_loads=2)
    b_ref, c_ref = bid_block_jnp(jnp.asarray(packed), jnp.asarray(load),
                                 col0=col0, bitplane_ties=bitplane_ties)
    b, c = bid_block_plain(bits(packed), torch.from_numpy(load), col0=col0,
                           bitplane_ties=bitplane_ties)
    np.testing.assert_array_equal(np.asarray(c_ref), c.numpy())
    np.testing.assert_array_equal(np.asarray(b_ref), b.numpy())


def test_bid_plain_row_chunking_is_invisible(monkeypatch):
    packed, load = _tile(4, 512, 8)
    whole = bid_argmin(bits(packed), torch.from_numpy(load))
    monkeypatch.setattr(kernels, "_PLAIN_TILE", 3 * 8 * 32)  # 3 rows a step
    chunked = bid_argmin(bits(packed), torch.from_numpy(load))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,w32", [(256, 3), (512, 64)])
def test_fanout_plain_matches_jax_integer_weights_exact(K, w32):
    rng = np.random.default_rng(K * w32)
    packed, _ = _tile(K, K, w32)
    w = np.where(rng.random(K) < 0.5, rng.integers(1, 9, K), 0
                 ).astype(np.float32)
    got = fanout_add(bits(packed), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(
        np.asarray(jax_fanout(jnp.asarray(packed), jnp.asarray(w),
                              interpret=True)), got)
    np.testing.assert_array_equal(
        np.asarray(_fanout_jnp(jnp.asarray(packed), jnp.asarray(w))), got)


@pytest.mark.parametrize("K,w32", [(256, 3), (512, 64)])
def test_fanout_plain_matches_jax_fractional_weights(K, w32):
    rng = np.random.default_rng(K + w32)
    packed, _ = _tile(K, K, w32)
    w = np.where(rng.random(K) < 0.5, rng.random(K), 0).astype(np.float32)
    got = fanout_add(bits(packed), torch.from_numpy(w)).numpy()
    ref = np.asarray(jax_fanout(jnp.asarray(packed), jnp.asarray(w),
                                interpret=True))
    np.testing.assert_allclose(ref, got, rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    packed = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        bid_argmin(packed.to(torch.int64), torch.zeros(64))
    with pytest.raises(TypeError):
        bid_argmin(packed, torch.zeros(32))                 # N != 32 * W32
    with pytest.raises(TypeError):
        fanout_add(packed, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError):
        fanout_add(packed[0], torch.zeros(4))


def test_plain_path_counts_no_launches():
    kernels.reset_launch_counts()
    packed, load = _tile(2, 256, 2)
    bid_argmin(bits(packed), torch.from_numpy(load))
    kernels.bid_argmin_natural(bits(packed), torch.from_numpy(load), 64)
    fanout_add(bits(packed), torch.ones(256))
    assert kernels.launch_counts() == {"bid_argmin": 0,
                                       "bid_argmin_natural": 0,
                                       "fanout_add": 0}


@pytest.mark.parametrize("K,w32", [(2048, 320), (16384, 320), (65536, 320),
                                   (2048, 3200), (1, 1), (300, 7)])
def test_fanout_chunks_cover_every_row_once(K, w32):
    s, rows = fanout_chunks(K, w32)
    assert 1 <= s <= 512 and (s - 1) * rows < K <= s * rows


def _bucket(seed, K, J, prefix):
    """Row indices with repeats and row 0 as padding (the planner's empty
    bucket slots), and an active mask: random, or a prefix like ``valid``."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, J, K).astype(np.int32)
    rows[(K * 5) // 8:] = 0
    rows[1:K // 4:3] = rows[0]
    active = (np.arange(K) < (K * 5) // 8) if prefix else rng.random(K) < 0.6
    return rows, active


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("K,J,w32,n_loads", [(256, 300, 3, 4), (512, 700, 17, 2),
                                             (256, 1000, 64, 1)])
def test_bid_plain_rows_active_match_jax(prefix, K, J, w32, n_loads):
    table, load = _tile(K + J + w32, J, w32, n_loads)
    rows, active = _bucket(K * w32, K, J, prefix)
    b_pal, c_pal = jax_bid(jnp.asarray(table[rows]), jnp.asarray(load),
                           interpret=True)
    best, choice = bid_argmin(bits(table), torch.from_numpy(load),
                              rows=torch.from_numpy(rows),
                              active=torch.from_numpy(active))
    b_pal, c_pal = np.asarray(b_pal), np.asarray(c_pal)
    np.testing.assert_array_equal(c_pal[active], choice.numpy()[active])
    np.testing.assert_array_equal(b_pal[active], best.numpy()[active])
    assert np.isinf(best.numpy()[~active]).all()
    assert (choice.numpy()[~active] == 0).all()


@pytest.mark.parametrize("K,J,w32", [(256, 300, 3), (512, 900, 64)])
def test_fanout_plain_rows_match_jax(K, J, w32):
    table, _ = _tile(K * J, J, w32)
    rows, active = _bucket(K + w32, K, J, False)
    rng = np.random.default_rng(w32)
    w_int = np.where(active, rng.integers(1, 9, K), 0).astype(np.float32)
    w_frac = np.where(active, rng.random(K), 0).astype(np.float32)
    got = fanout_add(bits(table), torch.from_numpy(w_int),
                     rows=torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(np.asarray(jax_fanout(
        jnp.asarray(table[rows]), jnp.asarray(w_int), interpret=True)), got)
    got = fanout_add(bits(table), torch.from_numpy(w_frac),
                     rows=torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(np.asarray(jax_fanout(
        jnp.asarray(table[rows]), jnp.asarray(w_frac), interpret=True)),
        got, rtol=1e-5)


def test_wrappers_reject_bad_rows_and_active():
    packed = torch.zeros((4, 2), dtype=torch.int32)
    load = torch.zeros(64)
    with pytest.raises(TypeError):
        bid_argmin(packed, load, rows=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        bid_argmin(packed, load, rows=torch.zeros(3, dtype=torch.int32),
                   active=torch.ones(4, dtype=torch.bool))      # K mismatch
    with pytest.raises(TypeError):
        bid_argmin(packed, load, active=torch.ones(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        fanout_add(packed, torch.zeros(4), rows=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        fanout_add(packed, torch.zeros(3),
                   rows=torch.zeros((3, 1), dtype=torch.int32))


@pytest.mark.parametrize("bad", [-1, 4])
def test_wrappers_reject_rows_outside_the_table(bad):
    """An index outside [0, J) raises, where plain indexing would wrap a
    negative one; the kernels stop on it (tests/test_torch_cuda.py)."""
    packed = torch.zeros((4, 2), dtype=torch.int32)
    rows = torch.tensor([0, bad, 1], dtype=torch.int32)
    with pytest.raises(IndexError):
        bid_argmin(packed, torch.zeros(64), rows=rows)
    with pytest.raises(IndexError):
        fanout_add(packed, torch.zeros(3), rows=rows)


def test_tie_conversion_without_i2f_is_exact():
    """All 65536 values: v in the mantissa of 1.0f, minus 1.0f, equals
    float(v) / 65536 bit for bit (the subtraction is exact)."""
    v = np.arange(65536, dtype=np.uint32)
    ref = v.astype(np.float32) / np.float32(65536.0)
    np.testing.assert_array_equal(tie_from_bits(v).view(np.int32),
                                  ref.view(np.int32))


def _model_tile(seed, K, w32, kind):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (K, w32), dtype=np.uint32)
    packed[3] = 0
    packed[5] &= 0x00010001
    if kind == "two_loads":
        load = rng.integers(0, 2, w32 * 32).astype(np.float32)
    elif kind == "all_equal":
        load = np.full(w32 * 32, 7.0, np.float32)
    elif kind == "within_one":  # sparse rows whose winner may load 0.75
        for _ in range(4):      # while a bit of load 0 sets the bound
            packed &= rng.integers(0, 2**32, (K, w32), dtype=np.uint32)
        load = np.full(w32 * 32, 0.75, np.float32)
    else:                                    # spread, as real loads are
        load = rng.integers(1000, 1400, w32 * 32).astype(np.float32)
    load[::13] = np.inf
    if kind == "within_one":
        load[:32] = 0.0         # every plane's least load is 0
    return packed, load


@pytest.mark.parametrize("kind", ["two_loads", "all_equal", "within_one",
                                  "spread"])
# 33 and 70 words leave lanes with one word more than others; 70 by 32 ends
# on a partial node tile; 1 word leaves 31 lanes idle
@pytest.mark.parametrize("w32,tile", [(40, None), (40, 16), (7, None),
                                      (33, None), (70, 32), (1, None)])
def test_k1_walk_model_matches_plain(kind, w32, tile):
    """The kernel's walk (per-lane word order, pruning, candidate masks,
    node tiles, lexicographic warp reduction) gives the plain version's
    answer on tie-heavy tiles."""
    packed, load = _model_tile(w32 + len(kind), 24, w32, kind)
    best_p, choice_p = kernels.bid_argmin_plain(bits(packed),
                                                torch.from_numpy(load))
    best, choice = k1_model(packed, load, tile=tile)
    np.testing.assert_array_equal(choice_p.numpy(), choice)
    np.testing.assert_array_equal(best_p.numpy().view(np.int32),
                                  best.view(np.int32))


@pytest.mark.parametrize("prefix", [False, True])
def test_k1_walk_model_rows_active_matches_plain(prefix):
    table, load = _model_tile(9, 40, 12, "two_loads")
    rows, active = _bucket(3, 24, 40, prefix)
    best_p, choice_p = kernels.bid_argmin_plain(
        bits(table), torch.from_numpy(load), torch.from_numpy(rows),
        torch.from_numpy(active))
    best, choice = k1_model(table, load, rows, active)
    np.testing.assert_array_equal(choice_p.numpy(), choice)
    np.testing.assert_array_equal(best_p.numpy().view(np.int32),
                                  best.view(np.int32))
