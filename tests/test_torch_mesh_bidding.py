"""The mesh's bidding pieces one by one against the JAX package: the assign
helpers of the bucket-sharded reconcile (``local_bid_demand``,
``compact_demand``, ``scatter_demand``, ``waterfill_accept_presplit``), K1n's
plain version against ``bid_block_jnp(col0, bitplane_ties=False)``, and the
port's own differential contract — bucket-sharded bidding (dense and
compacted) equal to the replicated waterfill, with integer costs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cronsun_tpu.ops import assign as jax_assign
from cronsun_tpu_torch.ops import assign as port_assign
from cronsun_tpu_torch.ops import kernels
from cronsun_tpu_torch.parallel import mesh as port_mesh
from torch_parity import (assert_plans_equal, bits, cpu_mesh, mesh_state,
                          one_torch_thread, port_mesh_planner)  # noqa: F401

T0 = 1_753_000_000


def _bids(K, N, seed, frac=False):
    """Candidates crowding few nodes: (cand, choice, cost) as numpy."""
    rng = np.random.default_rng(seed)
    cand = rng.random(K) < 0.6
    choice = rng.integers(0, N // 4, K).astype(np.int32)
    cost = (rng.uniform(0.5, 3.5, K) if frac
            else rng.integers(1, 4, K)).astype(np.float32)
    return cand, choice, cost


@pytest.mark.parametrize("K,N,seed", [(64, 32, 0), (1000, 96, 1),
                                      (4096, 2048, 2)])
def test_local_bid_demand_equals_the_jax_helper(K, N, seed):
    cand, choice, cost = _bids(K, N, seed)
    rank, cum, demand = jax_assign.local_bid_demand(
        jnp.asarray(cand), jnp.asarray(choice), jnp.asarray(cost), N)
    got = port_assign.local_bid_demand(torch.from_numpy(cand),
                                       torch.from_numpy(choice),
                                       torch.from_numpy(cost), N)
    for ref, out, name in zip((rank, cum, demand), got,
                              ("rank", "cum", "demand")):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                      err_msg=name)
        assert out.numpy().dtype == np.asarray(ref).dtype, name


@pytest.mark.parametrize("k_comp", [8, 40, 96])
def test_compact_and_scatter_demand_equal_the_jax_helpers(k_comp):
    """Nonzero demand on nodes that are not contiguous (every third node and
    a few stragglers); compaction keeps them in ascending node order, pads
    with zero-demand ids, and the scatter rebuilds the dense block."""
    N = 96
    rng = np.random.default_rng(k_comp)
    demand = np.zeros((2, N), np.float32)
    hot = np.r_[np.arange(1, N, 3)[:k_comp // 3], [95, 50]]
    demand[0, hot] = rng.integers(1, 5, len(hot))
    demand[1, hot] = rng.integers(1, 9, len(hot))
    comp_j, idx_j = jax_assign.compact_demand(jnp.asarray(demand), k_comp)
    comp_t, idx_t = port_assign.compact_demand(torch.from_numpy(demand),
                                               k_comp)
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    stack = np.stack([np.asarray(comp_j), np.asarray(comp_j)[:, ::-1]])
    np.testing.assert_array_equal(
        port_assign.scatter_demand(torch.from_numpy(stack.copy()), N).numpy(),
        np.asarray(jax_assign.scatter_demand(jnp.asarray(stack), N)))


@pytest.mark.parametrize("is_final", [False, True])
def test_waterfill_accept_presplit_equals_the_jax_helper(is_final):
    K, N = 2000, 64
    cand, choice, cost = _bids(K, N, 7)
    rng = np.random.default_rng(8)
    load = rng.integers(0, 6, N).astype(np.float32)
    rem_cap = rng.integers(0, 4, N).astype(np.int32)
    rank = rng.integers(0, 5, K).astype(np.int32)
    cum = rng.integers(0, 9, K).astype(np.float32)
    ref = jax_assign.waterfill_accept_presplit(
        jnp.asarray(cand), jnp.asarray(choice), jnp.asarray(cost),
        jnp.asarray(load), jnp.asarray(rem_cap), is_final,
        jnp.asarray(rank), jnp.asarray(cum), jnp.float32(37.0))
    got = port_assign.waterfill_accept_presplit(
        *(torch.from_numpy(a) for a in (cand, choice, cost, load, rem_cap)),
        is_final, torch.from_numpy(rank), torch.from_numpy(cum),
        torch.tensor(37.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()


@pytest.mark.parametrize("col0", [0, 32, 96, 5120])
@pytest.mark.parametrize("ties", [False, True])
def test_k1n_plain_equals_bid_block_jnp(col0, ties):
    """K1n's plain version (the wrapper on the CPU) against the reference's
    natural-order block bid at several column offsets; ``ties`` makes every
    load equal over 2048 columns, so exact-score collisions of the 16-bit
    tie hash decide some rows' minimum."""
    K, w32 = (1000, 64) if ties else (300, 5)
    rng = np.random.default_rng(col0 + ties)
    packed = rng.integers(0, 2**32, (K, w32), dtype=np.uint64).astype(
        np.uint32)
    packed[::7] = 0                                   # no candidate
    load = (np.zeros(w32 * 32) if ties
            else rng.integers(0, 3, w32 * 32)).astype(np.float32)
    load[::13] = np.inf                               # closed nodes
    best_j, choice_j = jax_assign.bid_block_jnp(
        jnp.asarray(packed), jnp.asarray(load), col0=col0,
        bitplane_ties=False)
    best, choice = kernels.bid_argmin_natural(bits(packed),
                                              torch.from_numpy(load), col0)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(choice_j))
    if ties:   # some rows' minimum is attained at two nodes or more
        jix = torch.arange(K, dtype=torch.int64)[:, None]
        nix = col0 + torch.arange(w32 * 32, dtype=torch.int64)[None, :]
        score = torch.where(kernels.unpack_tile(bits(packed), w32 * 32),
                            torch.from_numpy(load)[None, :]
                            + kernels._tie(jix, nix), float("inf"))
        n_min = (score == best[:, None]).sum(1)
        assert int(((n_min > 1) & torch.isfinite(best)).sum()) > 0


def test_k1n_wrapper_gathers_rows_and_masks_inactive():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 2**32, (50, 3), dtype=np.uint64).astype(np.uint32)
    load = torch.from_numpy(rng.integers(0, 3, 96).astype(np.float32))
    rows = torch.tensor([4, 4, 0, 49, 17], dtype=torch.int32)
    active = torch.tensor([True, False, True, True, False])
    best, choice = kernels.bid_argmin_natural(bits(table), load, 64,
                                              rows=rows, active=active)
    ref_b, ref_c = kernels.bid_block_plain(bits(table)[rows.long()], load,
                                           col0=64, bitplane_ties=False)
    assert torch.equal(best[active], ref_b[active])
    assert torch.equal(choice[active], ref_c[active])
    assert torch.isinf(best[~active]).all() and (choice[~active] == 64).all()
    with pytest.raises(IndexError):
        kernels.bid_argmin_natural(bits(table), load, 0,
                                   rows=torch.tensor([50], dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.bid_argmin_natural(bits(table), load, -32)


@pytest.mark.parametrize("kind,shape", [("1d", 4), ("2d", (2, 4)),
                                        ("2d", (4, 2))])
def test_sharded_bidding_equals_the_replicated_waterfill(kind, shape):
    """The port's own differential contract (the reference's
    ``tests/test_mesh_bidding.py``): bucket-sharded bidding, dense and
    compacted, gives the replicated waterfill's plans and carried state,
    tick by tick and over a fused window."""
    cls = (port_mesh.ShardedTickPlanner if kind == "1d"
           else port_mesh.Sharded2DTickPlanner)
    mesh = cpu_mesh(shape) if kind == "1d" else cpu_mesh(*shape)
    state = mesh_state(4096, 128, seed=11 + len(str(shape)))
    repl = port_mesh_planner(cls, mesh, state, shard_bids=False,
                             max_fire_bucket=2048)
    ref = [repl.plan(T0 + i) for i in range(2)] + repl.plan_window(T0 + 2, 3)
    for fmt in ("dense", "compacted"):
        sp = port_mesh_planner(cls, mesh, state, demand_format=fmt,
                               max_fire_bucket=2048)
        got = [sp.plan(T0 + i) for i in range(2)] + sp.plan_window(T0 + 2, 3)
        assert_plans_equal(ref, got)
        assert torch.equal(sp.load, repl.load)
        assert torch.equal(sp.rem_cap, repl.rem_cap)
    assert sum(int((p.assigned >= 0).sum()) for p in ref) > 100


@pytest.mark.parametrize("natural", [False, True])
def test_plain_bid_of_the_active_rows_equals_the_masked_full_bid(natural):
    """The plain K1 and K1n compute only the active rows (the tie hash keeps
    each row's bucket position): equal to the bid of every row, masked."""
    rng = np.random.default_rng(5)
    table = rng.integers(0, 2**32, (300, 4), dtype=np.uint64).astype(
        np.uint32)
    load = torch.from_numpy(rng.integers(0, 2, 128).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 300, 500).astype(np.int32))
    active = torch.from_numpy(rng.random(500) < 0.3)
    col0 = 256 if natural else 0
    got = (kernels.bid_argmin_natural(bits(table), load, col0, rows=rows,
                                      active=active) if natural else
           kernels.bid_argmin(bits(table), load, rows=rows, active=active))
    best, choice = kernels.bid_block_plain(bits(table)[rows.long()], load,
                                           col0=col0,
                                           bitplane_ties=not natural)
    assert torch.equal(got[0], torch.where(active, best, float("inf")))
    assert torch.equal(got[1], torch.where(active, choice, col0))
