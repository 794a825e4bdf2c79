"""The hand-written CUDA kernels against their plain versions, and the planner
on the card against the planner on the CPU.  Needs an NVIDIA GPU (the
kernels have no CPU mode); without one every test here skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import subprocess
import sys
from pathlib import Path

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


def _bucket(dev, K, J, seed, prefix=False):
    """Row indices with repeats and row 0 as padding, and an active mask
    (random, or a prefix, as the planner's valid mask is)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, J, (K,), dtype=torch.int32, device=dev,
                         generator=g)
    rows[K // 2:] = 0                                     # padded slots
    rows[1:K // 4:3] = rows[0]                            # repeats
    if prefix:
        active = torch.arange(K, device=dev) < (K * 5) // 8
    else:
        active = torch.rand(K, device=dev, generator=g) < 0.6
    return rows, active


# w32: 5 and 7 take the direct-load path (rows not 16-byte aligned), 320 the
# headline width, 400 one shared-memory tile past 48 KB, 3200 node tiling
@pytest.mark.parametrize("K,J,w32", [(1, 7, 5), (37, 64, 7), (999, 2000, 320),
                                     (257, 300, 400), (65, 90, 3200)])
@pytest.mark.parametrize("prefix", [False, True])
def test_bid_kernel_rows_active_match_plain(cuda, K, J, w32, prefix):
    table, load = _tile(cuda, J, w32, K + w32)
    rows, active = _bucket(cuda, K, J, K * w32, prefix)
    best, choice = k.bid_argmin(table, load, rows=rows, active=active)
    best_p, choice_p = k.bid_argmin_plain(table, load, rows, active)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)
    assert torch.isinf(best[~active]).all() and (choice[~active] == 0).all()
    # without rows and active: the TPU kernel's function on every row
    best, choice = k.bid_argmin(table, load)
    best_p, choice_p = k.bid_argmin_plain(table, load)
    assert torch.equal(choice, choice_p) and torch.equal(best, best_p)


@pytest.mark.parametrize("w32", [5, 320, 3200])
def test_bid_kernel_all_closed_and_tie_heavy(cuda, w32):
    table, load = _tile(cuda, 129, w32, w32)
    closed = torch.full_like(load, float("inf"))
    best, choice = k.bid_argmin(table, closed)
    assert torch.isinf(best).all() and (choice == 0).all()
    flat = torch.zeros_like(load)                # every score a tie on load
    assert all(torch.equal(a, b) for a, b in zip(
        k.bid_argmin(table, flat), k.bid_argmin_plain(table, flat)))


@pytest.mark.parametrize("w32", [40, 320, 3200])
def test_bid_kernel_winner_within_one_unit(cuda, w32):
    """Sparse rows over loads of 0.75 with one word of 0: the candidate
    masks keep every bit that can still win."""
    table, _ = _tile(cuda, 257, w32, w32 + 1)
    g = torch.Generator(device=cuda).manual_seed(w32)
    for _ in range(4):
        table &= torch.randint(-2**31, 2**31, table.shape, dtype=torch.int32,
                               device=cuda, generator=g)
    load = torch.full((w32 * 32,), 0.75, device=cuda)
    load[:32] = 0.0
    assert all(torch.equal(a, b) for a, b in zip(
        k.bid_argmin(table, load), k.bid_argmin_plain(table, load)))


@pytest.mark.parametrize("K,J,w32", [(1, 3, 5), (129, 200, 7),
                                     (5001, 6000, 320), (301, 400, 3200)])
def test_fanout_kernel_rows_match_plain(cuda, K, J, w32):
    table, _ = _tile(cuda, J, w32, K + J)
    rows, active = _bucket(cuda, K, J, K)
    w = torch.randint(0, 5, (K,), device=cuda).float() * active
    assert torch.equal(k.fanout_add(table, w, rows=rows),
                       k.fanout_add_plain(table, w, rows))
    wf = torch.rand(K, device=cuda) * active
    got = k.fanout_add(table, wf, rows=rows)
    torch.testing.assert_close(got, k.fanout_add_plain(table, wf, rows),
                               rtol=1e-5, atol=1e-5)
    # one launch, no atomics on floats: the same bits every call
    assert torch.equal(got, k.fanout_add(table, wf, rows=rows))


_OUT_OF_RANGE = """
import os, torch
from cronsun_tpu_torch.ops import kernels as k
table = torch.zeros((64, 8), dtype=torch.int32, device="cuda")
rows = torch.tensor([0, {bad}, 1] * 40, dtype=torch.int32, device="cuda")
try:
    if "{name}" == "bid_argmin":
        k.bid_argmin(table, torch.zeros(256, device="cuda"), rows=rows)
    else:
        k.fanout_add(table, torch.ones(120, device="cuda"), rows=rows)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", type(e).__name__, str(e).splitlines()[0], flush=True)
    os._exit(0)
os._exit(3)
"""


@pytest.mark.parametrize("name", ["bid_argmin", "fanout_add"])
@pytest.mark.parametrize("bad", [-1, 64])
def test_kernel_stops_on_a_row_outside_the_table(cuda, name, bad):
    """A row index outside [0, J) stops the kernel, which leaves the CUDA
    context unusable, so each case runs in a process of its own."""
    r = subprocess.run([sys.executable, "-c",
                        _OUT_OF_RANGE.format(name=name, bad=bad)],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "stopped:" in r.stdout, (r.stdout, r.stderr)


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
