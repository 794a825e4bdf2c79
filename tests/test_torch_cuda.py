"""The hand-written CUDA kernels against their plain versions, and the planner
on the card against the planner on the CPU.  Needs an NVIDIA GPU (the
kernels have no CPU mode); without one every test here skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import kernels as k
from cronsun_tpu_torch.synth import synth_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tile(dev, K, w32, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-2**31, 2**31, (K, w32), dtype=torch.int32,
                           device=dev, generator=g)
    packed[::5] = 0
    packed[1::7] &= 0x10001
    load = torch.randint(0, 3, (w32 * 32,), device=dev, generator=g).float()
    load[::11] = float("inf")
    return packed, load


# w32 = 400 puts load_eff past 48 KB of shared memory: the __ldg variant
@pytest.mark.parametrize("K,w32", [(1, 1), (33, 5), (1000, 320), (300, 400)])
def test_bid_kernel_matches_plain(cuda, K, w32):
    packed, load = _tile(cuda, K, w32, K + w32)
    best, choice = k.bid_argmin(packed, load)
    best_p, choice_p = k.bid_argmin_plain(packed, load)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)


@pytest.mark.parametrize("K,w32", [(1, 1), (129, 7), (5000, 320), (300, 3200)])
def test_fanout_kernel_matches_plain(cuda, K, w32):
    packed, _ = _tile(cuda, K, w32, K * w32)
    w = torch.randint(0, 5, (K,), device=cuda).float()
    assert torch.equal(k.fanout_add(packed, w), k.fanout_add_plain(packed, w))
    wf = torch.rand(K, device=cuda)
    torch.testing.assert_close(k.fanout_add(packed, wf),
                               k.fanout_add_plain(packed, wf),
                               rtol=1e-5, atol=1e-5)
    # deterministic: no atomics, same bits every run
    assert torch.equal(k.fanout_add(packed, wf), k.fanout_add(packed, wf))


def test_wrappers_count_kernel_launches(cuda):
    k.reset_launch_counts()
    packed, load = _tile(cuda, 64, 2, 0)
    k.bid_argmin(packed, load)
    k.fanout_add(packed, torch.ones(64, device=cuda))
    k.fanout_add(packed, torch.ones(64, device=cuda))
    assert k.launch_counts() == {"bid_argmin": 1, "fanout_add": 2}
    with pytest.raises(ValueError):
        k.bid_argmin(packed[:, :1], load[:32].clone())   # not contiguous


def test_planner_on_the_card_matches_the_cpu(cuda):
    state = synth_state(8192, 320, seed=3, node_cap=3, empty_rows=0.05)
    gpu = planner_from_numpy(state, device=cuda, max_fire_bucket=2048)
    cpu = planner_from_numpy(state, device="cpu", max_fire_bucket=2048)
    for i in range(3):
        a = gpu.plan_window(1_753_000_000 + 4 * i, 4)
        b = cpu.plan_window(1_753_000_000 + 4 * i, 4)
        for x, y in zip(a, b):
            assert np.array_equal(x.fired, y.fired)
            assert np.array_equal(x.assigned, y.assigned)
            assert (x.overflow, x.total_fired, x.n_excl) == \
                (y.overflow, y.total_fired, y.n_excl)
    assert torch.equal(gpu.load.cpu(), cpu.load)
    assert torch.equal(gpu.rem_cap.cpu(), cpu.rem_cap)
