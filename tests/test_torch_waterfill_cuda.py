"""The accept kernel (``csrc/waterfill_accept.cu``) against the plain chain
(``assign.waterfill_accept_plain``) on the card: accept, load, rem_cap and
the placements equal bit for bit on integer and dyadic costs (sums exact),
over seeds, bucket sizes from 1 to the planners' largest (65536, taken in
chunks past 16384), two node counts and one where the node bits shrink a
pass, on loads summing past 2^24, and on the edges (no candidate, every
node full, one node bid by every row, rank-0 progress, capacity binding
before the quota); the inputs are left as they were; every bucket on the
card takes the kernel and counts a launch.  Needs an NVIDIA GPU; without
one every test here skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_waterfill_cuda.py
"""

import pytest
import torch

from cronsun_tpu_torch.ops import assign, kernels

pytestmark = pytest.mark.cuda

BIGGEST = 65536   # the headline planner's max_fire_bucket


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, K, N, seed, dyadic=False, cand_p=0.7, cap_hi=4,
            node_hi=None, load_lo=0, load_hi=50):
    """(cand, choice, cost, load, rem_cap, assigned) on ``dev``: integer
    loads in [load_lo, load_hi) and costs 1-4 (or multiples of 1/4 up to
    4), so every sum either route takes is exact in f64."""
    g = torch.Generator().manual_seed(seed)
    cand = torch.rand(K, generator=g) < cand_p
    choice = torch.randint(0, node_hi or N, (K,), generator=g,
                           dtype=torch.int32)
    if dyadic:
        cost = torch.randint(1, 17, (K,), generator=g).float() / 4
    else:
        cost = torch.randint(1, 5, (K,), generator=g).float()
    load = torch.randint(load_lo, load_hi, (N,), generator=g).float()
    rem_cap = torch.randint(0, cap_hi, (N,), generator=g, dtype=torch.int32)
    assigned = torch.randint(-1, N, (K,), generator=g, dtype=torch.int32)
    return [t.to(dev) for t in (cand, choice, cost, load, rem_cap,
                                assigned)]


def _check(args, is_final):
    """The kernel against the plain chain on the same tensors; the inputs
    unmodified.  Returns the kernel's accept."""
    cand, choice, cost, load, rem_cap, assigned = args
    before = [t.clone() for t in args]
    n0 = kernels.waterfill_accept.launches
    got = kernels.waterfill_accept(cand, choice, cost, load, rem_cap,
                                   is_final, assigned)
    torch.cuda.synchronize()
    assert kernels.waterfill_accept.launches == n0 + 1
    acc, lo, cap = assign.waterfill_accept_plain(cand, choice, cost, load,
                                                 rem_cap, is_final)
    want = (acc, lo, cap, torch.where(acc, choice, assigned))
    for name, g, w in zip(("accept", "load", "rem_cap", "assigned"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    return got[0]


@pytest.mark.parametrize("N", [10240, 102400])
@pytest.mark.parametrize("K", [1, 7, 2048, 16384, 16385, BIGGEST])
@pytest.mark.parametrize("dyadic", [False, True])
def test_the_kernel_equals_the_plain_chain(cuda, K, N, dyadic):
    for seed in range(3):
        for is_final in (False, True):
            args = _inputs(cuda, K, N, 1000 * K + N + seed, dyadic=dyadic,
                           node_hi=min(N, max(8, K // 4)))
            _check(args, is_final)


@pytest.mark.parametrize("is_final", [False, True])
def test_no_candidates(cuda, is_final):
    args = _inputs(cuda, 16384, 10240, 1, cand_p=0.0)
    assert not _check(args, is_final).any()


@pytest.mark.parametrize("is_final", [False, True])
def test_every_node_full(cuda, is_final):
    args = _inputs(cuda, 16384, 10240, 2)
    args[4].zero_()
    assert not _check(args, is_final).any()


@pytest.mark.parametrize("K", [2048, BIGGEST])
@pytest.mark.parametrize("is_final", [False, True])
def test_one_node_bid_by_every_row(cuda, K, is_final):
    """One segment of K bids, far longer than a thread's share."""
    args = _inputs(cuda, K, 10240, 3, cand_p=1.0)
    args[1].fill_(77)
    args[4][77] = K // 3
    acc = _check(args, is_final)
    assert 0 < int(acc.sum()) <= K // 3


def test_rank_zero_lands_above_the_level(cuda):
    """Every chosen node is far above the level: only the quota's rank-0
    exception places anything, one bid a node."""
    args = _inputs(cuda, 16384, 10240, 4, cap_hi=100, node_hi=512)
    args[4][args[4] == 0] = 1
    args[3][:512] = 1e6
    acc = _check(args, False)
    chosen = args[1][acc].to(torch.int64)
    assert acc.any() and chosen.unique().numel() == chosen.numel()


def test_capacity_binds_before_the_quota(cuda):
    """Loads far below the level, one slot a node: capacity, not the
    quota, stops each node at its first bid."""
    args = _inputs(cuda, 16384, 10240, 5, node_hi=1024)
    args[3].zero_()
    args[3][1024:] = 1e5
    args[4].fill_(1)
    acc = _check(args, False)
    cand = args[0]
    n_nodes = args[1][cand].unique().numel()
    assert int(acc.sum()) == n_nodes


@pytest.mark.parametrize("K", [16384, BIGGEST])
@pytest.mark.parametrize("is_final", [False, True])
def test_loads_summing_past_2_24(cuda, K, is_final):
    """Integer loads near 2^15 a node over 10240 nodes (a sum near 2^28,
    where a running f32 sum rounds), bids crowding a quarter of the nodes
    so the quota binds for some: the level is the same f64 sum on both
    routes, and so is everything else."""
    args = _inputs(cuda, K, 10240, 8, cap_hi=64, node_hi=2560,
                   load_lo=1 << 14, load_hi=1 << 15)
    open_load = torch.where(args[4] > 0, args[3], 0.0)
    assert open_load.sum(dtype=torch.float64) > 2 ** 24
    acc = _check(args, is_final)
    assert 0 < int(acc.sum()) < int(args[0].sum())


@pytest.mark.parametrize("K", [8192, 8193, 20000])
def test_node_bits_shrink_a_pass(cuda, K):
    """300000 nodes take 19 of the key's bits, so one pass takes 8192
    bids: a bucket past that is taken in chunks of 8192."""
    assert kernels._wf_chunk(300000) == 8192
    for is_final in (False, True):
        _check(_inputs(cuda, K, 300000, 9 + K, node_hi=K // 4), is_final)


def test_every_bucket_takes_the_kernel_and_counts(cuda):
    """assign.waterfill_accept on the card: one launch a call, at one pass
    and in chunks, and the plain chain's result."""
    for K in (2048, BIGGEST):
        args = _inputs(cuda, K, 10240, 10 + K)
        kernels.reset_launch_counts()
        got = assign.waterfill_accept(*args[:5], False)
        assert kernels.launch_counts()["waterfill_accept"] == 1
        want = assign.waterfill_accept_plain(*args[:5], False)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
