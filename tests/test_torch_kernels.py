"""Port vs JAX: the plain versions of K1 bid_argmin and K2 fanout_add, and
the tie hash.

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
    fanout_add(bits(packed), torch.ones(256))
    assert kernels.launch_counts() == {"bid_argmin": 0, "fanout_add": 0}


@pytest.mark.parametrize("K,w32", [(2048, 320), (16384, 320), (65536, 320),
                                   (2048, 3200), (1, 1), (300, 7)])
def test_fanout_chunks_cover_every_row_once(K, w32):
    s, rows = fanout_chunks(K, w32)
    assert 1 <= s <= 512 and (s - 1) * rows < K <= s * rows
