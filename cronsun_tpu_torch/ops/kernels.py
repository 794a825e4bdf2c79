"""The bid and fan-out steps: hand-written CUDA kernels and their plain versions.

Counterpart of ``cronsun_tpu/ops/pallas_kernels.py``.  Each wrapper takes
the bit-packed eligibility ``packed`` [K, W32] as int32 bit patterns (node
``n = w*32 + b`` is bit ``b`` of word ``w``) and:

- on a CUDA tensor launches its kernel (``csrc/<name>.cu``, built at first
  use by :mod:`._build`) on the current stream and adds one to its
  ``launches`` count — or raises; there is no fallback;
- on a CPU tensor runs the plain PyTorch version, which is also what the
  kernel is held against on the card.

K1 :func:`bid_argmin` — per job, min/argmin of ``load_eff + tie`` over its
eligible nodes.  K2 :func:`fanout_add` — per node, the summed weight of the
jobs eligible there.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_HASH_A = 2654435761
_HASH_B = 40503
_HASH_C = 2246822519
_HASH_D = 3266489917
_M32 = 0xFFFFFFFF

# elements of the dense [rows, N] score tile the plain bid materializes at once
_PLAIN_TILE = 1 << 24


# ------------------------------------------------------------ plain versions

def _tie(jix: torch.Tensor, nix: torch.Tensor) -> torch.Tensor:
    """Deterministic per-(job, node) tie-break in [0, 1): the uint32
    multiply-xorshift of the TPU kernel, carried in int64.  Masking after
    every multiply keeps the low 32 bits (int64 products wrap, and the low
    bits survive), and masking before the shift makes it logical."""
    h = ((jix * _HASH_A) & _M32) ^ ((nix * _HASH_B) & _M32)
    h = (h * _HASH_C) & _M32
    h = h ^ (h >> 15)
    h = (h * _HASH_D) & _M32
    return (h >> 16).to(torch.float32) * (1.0 / 65536.0)


def unpack_tile(packed: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[K, W32] int32 bit patterns -> [K, n_nodes] bool (dense; plain path)."""
    cols = torch.arange(n_nodes, device=packed.device)
    words = packed[:, cols // 32]
    return ((words >> (cols % 32).to(packed.dtype)) & 1) != 0


def bid_block_plain(packed: torch.Tensor, load_blk: torch.Tensor,
                    col0: int = 0, bitplane_ties: bool = True):
    """Dense plain bid over a node-column block (``cronsun_tpu``'s
    ``bid_block_jnp``), materialized ``_PLAIN_TILE`` elements at a time.

    ``col0`` puts the hash and the returned choice in global node
    coordinates.  Exact-score ties resolve per ``bitplane_ties``: True is the
    kernels' order (bit plane b outer, word w inner: lexicographic
    (score, b, w)), False the natural column order.  ``torch.argmin`` returns
    the first minimum, so an all-inf row gives choice ``col0``."""
    K, w32 = packed.shape
    n = w32 * 32
    dev = packed.device
    best = torch.empty(K, dtype=torch.float32, device=dev)
    choice = torch.empty(K, dtype=torch.int32, device=dev)
    nix = (col0 + torch.arange(n, dtype=torch.int64, device=dev))[None, :]
    step = max(1, _PLAIN_TILE // max(n, 1))
    for r0 in range(0, K, step):
        rows = packed[r0:r0 + step]
        k = rows.shape[0]
        jix = torch.arange(r0, r0 + k, dtype=torch.int64, device=dev)[:, None]
        score = torch.where(unpack_tile(rows, n),
                            load_blk[None, :] + _tie(jix, nix),
                            torch.tensor(float("inf"), device=dev))
        if bitplane_ties:
            score_bw = score.reshape(k, w32, 32).transpose(1, 2).reshape(k, n)
            p = torch.argmin(score_bw, dim=1)
            c = (p % w32) * 32 + p // w32
        else:
            c = torch.argmin(score, dim=1)
        best[r0:r0 + k] = score.min(dim=1).values
        choice[r0:r0 + k] = (c + col0).to(torch.int32)
    return best, choice


def bid_argmin_plain(packed: torch.Tensor, load_eff: torch.Tensor):
    """Plain K1: (best [K] f32, choice [K] int32) in the kernels' tie order."""
    return bid_block_plain(packed, load_eff, col0=0, bitplane_ties=True)


def fanout_add_plain(packed: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain K2: out[n] = sum_j weights[j] * bit(j, n), one [K] x [K, W32]
    product per bit plane (the TPU kernel's decomposition), so no dense
    [K, N] tile is ever built."""
    K, w32 = packed.shape
    out_t = torch.empty(32, w32, dtype=torch.float32, device=packed.device)
    for b in range(32):
        out_t[b] = weights @ ((packed >> b) & 1).to(torch.float32)
    return out_t.T.reshape(w32 * 32)


# ------------------------------------------------------------ kernel wrappers

def _check_packed(name: str, packed: torch.Tensor) -> "tuple[int, int]":
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise TypeError(f"{name}: packed must be a 2-D int32 tensor of bit "
                        f"patterns, got {packed.dtype} {tuple(packed.shape)}")
    return packed.shape


def _check_vector(name: str, packed: torch.Tensor, vec: torch.Tensor,
                  length: int) -> None:
    """Raise on what the kernel does not take."""
    if vec.dtype != torch.float32 or vec.dim() != 1 or vec.shape[0] != length:
        raise TypeError(f"{name}: expected a [{length}] float32 vector, got "
                        f"{vec.dtype} {tuple(vec.shape)}")
    if packed.device != vec.device:
        raise ValueError(f"{name}: inputs on {packed.device} and {vec.device}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")
    if packed.device.type == "cuda" and not (packed.is_contiguous()
                                             and vec.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


_K1_WARPS = 16   # rows per block, one warp each (csrc/bid_argmin.cu)
_K1_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def bid_argmin(packed: torch.Tensor, load_eff: torch.Tensor):
    """Per-job best node by load (K1).

    Args:
      packed: [K, W32] int32 eligibility bit patterns.
      load_eff: [W32*32] f32 effective load per node (+inf for closed nodes).
    Returns:
      (best [K] f32 — min load + tie, +inf if no eligible open node;
       choice [K] int32 — its node, 0 when there is none).
    """
    K, w32 = _check_packed("bid_argmin", packed)
    _check_vector("bid_argmin", packed, load_eff, 32 * w32)
    if packed.device.type == "cpu":
        return bid_argmin_plain(packed, load_eff)
    dev = packed.device
    best = torch.empty(K, dtype=torch.float32, device=dev)
    choice = torch.empty(K, dtype=torch.int32, device=dev)
    if K == 0 or w32 == 0:
        return best.fill_(float("inf")), choice.zero_()
    fn = _build.kernel_function("bid_argmin", "cronsun_bid_argmin", _K1_ARGS)
    grid = min(math.ceil(K / _K1_WARPS), 2 * _sm_count(dev))
    with torch.cuda.device(dev):
        rc = fn(packed.data_ptr(), load_eff.data_ptr(), best.data_ptr(),
                choice.data_ptr(), K, w32, grid,
                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "bid_argmin")
    bid_argmin.launches += 1
    return best, choice


bid_argmin.launches = 0

_K2_THREADS = 128    # word columns per block (csrc/fanout_add.cu)
_K2_BLOCKS = 512     # pass-1 blocks aimed for; a constant, not the SM count
_K2_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fanout_chunks(K: int, w32: int) -> "tuple[int, int]":
    """(S, rows per chunk) of K2's first pass — a function of the shape
    alone, so fractional sums round identically on every card."""
    word_tiles = math.ceil(w32 / _K2_THREADS)
    s = max(1, min(math.ceil(K / 128), _K2_BLOCKS // word_tiles))
    rows = math.ceil(K / s)
    return math.ceil(K / rows), rows


def fanout_add(packed: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-node total weight of the jobs eligible there (K2):
    out[n] = sum_j weights[j] * bit(j, n).

    Args:
      packed: [K, W32] int32 eligibility bit patterns.
      weights: [K] f32 (0 for rows that do not take part).
    Returns: [W32*32] f32, natural node order.
    """
    K, w32 = _check_packed("fanout_add", packed)
    _check_vector("fanout_add", packed, weights, K)
    if packed.device.type == "cpu":
        return fanout_add_plain(packed, weights)
    dev = packed.device
    out = torch.empty(w32 * 32, dtype=torch.float32, device=dev)
    if K == 0 or w32 == 0:
        return out.zero_()
    s, rows = fanout_chunks(K, w32)
    partial = torch.empty((s, w32 * 32), dtype=torch.float32, device=dev)
    fn = _build.kernel_function("fanout_add", "cronsun_fanout_add", _K2_ARGS)
    with torch.cuda.device(dev):
        rc = fn(packed.data_ptr(), weights.data_ptr(), partial.data_ptr(),
                out.data_ptr(), K, w32, s, rows,
                torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fanout_add")
    fanout_add.launches += 1
    return out


fanout_add.launches = 0

WRAPPERS = (bid_argmin, fanout_add)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
