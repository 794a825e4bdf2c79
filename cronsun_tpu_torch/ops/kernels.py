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

Both take an optional ``rows`` [K] int32: row j of the bucket is then
``packed[rows[j]]`` of the whole eligibility table, read by the kernel
itself (on the CPU the plain version gathers).  An index outside [0, J)
raises IndexError on the CPU and stops the kernel on the card (``__trap``:
the CUDA context reports an error at its next synchronisation, as after
PyTorch's own device-side index assert).  K1 also takes ``active`` [K]
bool: an inactive row reads nothing and gives (+inf, 0); K2's zero weights
play that part.  Without them each computes the TPU kernel's function on
every row of ``packed``.
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


def _take_rows(packed: torch.Tensor, rows) -> torch.Tensor:
    """The bucket's tile: ``packed[rows]``, or ``packed`` itself."""
    return packed if rows is None else packed[rows.to(torch.int64)]


def bid_argmin_plain(packed: torch.Tensor, load_eff: torch.Tensor,
                     rows=None, active=None):
    """Plain K1: (best [K] f32, choice [K] int32) in the kernels' tie order.

    Row ``j`` is ``packed[rows[j]]`` when ``rows`` is given; its tie hash
    still uses ``j``, the row's place in the bucket.  A row that ``active``
    marks False gives (+inf, 0)."""
    best, choice = bid_block_plain(_take_rows(packed, rows), load_eff,
                                   col0=0, bitplane_ties=True)
    if active is not None:
        best = torch.where(active, best, float("inf"))
        choice = torch.where(active, choice, 0)
    return best, choice


def fanout_add_plain(packed: torch.Tensor, weights: torch.Tensor,
                     rows=None) -> torch.Tensor:
    """Plain K2: out[n] = sum_j weights[j] * bit(j, n), one [K] x [K, W32]
    product per bit plane (the TPU kernel's decomposition), so no dense
    [K, N] tile is ever built.  Row ``j`` is ``packed[rows[j]]`` when
    ``rows`` is given."""
    packed = _take_rows(packed, rows)
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
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {packed.device}")
    return packed.shape


def _check_vector(name: str, packed: torch.Tensor, vec, length: int,
                  dtype=torch.float32, what: str = "float32") -> None:
    """Raise on what the kernel does not take (``vec`` None: absent)."""
    if vec is None:
        return
    if vec.dtype != dtype or vec.dim() != 1 or vec.shape[0] != length:
        raise TypeError(f"{name}: expected a [{length}] {what} vector, got "
                        f"{vec.dtype} {tuple(vec.shape)}")
    if packed.device != vec.device:
        raise ValueError(f"{name}: inputs on {packed.device} and {vec.device}")
    if packed.device.type == "cuda" and not (packed.is_contiguous()
                                             and vec.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _bucket_size(name: str, packed: torch.Tensor, rows) -> int:
    """K: the bucket's rows — ``rows``' length, else the tile's.  On the
    CPU an index outside [0, J) raises here; the kernels check their own
    (reading them here would stall the card's stream)."""
    if rows is None:
        return packed.shape[0]
    if rows.dim() != 1:
        raise TypeError(f"{name}: rows must be 1-D, got {tuple(rows.shape)}")
    _check_vector(name, packed, rows, rows.shape[0], torch.int32, "int32")
    if packed.device.type == "cpu" and rows.numel() and (
            int(rows.min()) < 0 or int(rows.max()) >= packed.shape[0]):
        raise IndexError(f"{name}: rows must lie in [0, {packed.shape[0]})")
    return rows.shape[0]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


_fns: dict = {}


def _launch(name: str, argtypes, dev: torch.device, *args) -> None:
    """Call the C entry ``cronsun_<name>`` (built on first use) on ``dev``'s
    current stream; raise if it reports a CUDA error."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.kernel_function(name, f"cronsun_{name}",
                                                 argtypes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


_K1_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def bid_argmin(packed: torch.Tensor, load_eff: torch.Tensor,
               rows=None, active=None):
    """Per-job best node by load (K1).

    Args:
      packed: [J, W32] int32 eligibility bit patterns — the bucket's tile,
        or with ``rows`` the whole table.
      load_eff: [W32*32] f32 effective load per node (+inf for closed nodes).
      rows: optional [K] int32 in [0, J) — row j of the tile is
        ``packed[rows[j]]`` (the gather runs inside the kernel; the tie hash
        keeps using j).
      active: optional [K] bool — a False row reads nothing and gives
        (+inf, 0).
    Returns:
      (best [K] f32 — min load + tie, +inf if no eligible open node;
       choice [K] int32 — its node, 0 when there is none).
    """
    J, w32 = _check_packed("bid_argmin", packed)
    _check_vector("bid_argmin", packed, load_eff, 32 * w32)
    K = _bucket_size("bid_argmin", packed, rows)
    _check_vector("bid_argmin", packed, active, K, torch.bool, "bool")
    if packed.device.type == "cpu":
        return bid_argmin_plain(packed, load_eff, rows, active)
    dev = packed.device
    best = torch.empty(K, dtype=torch.float32, device=dev)
    choice = torch.empty(K, dtype=torch.int32, device=dev)
    if K == 0 or w32 == 0:
        return best.fill_(float("inf")), choice.zero_()
    _launch("bid_argmin", _K1_ARGS, dev, packed.data_ptr(), _ptr(rows),
            _ptr(active), load_eff.data_ptr(), best.data_ptr(),
            choice.data_ptr(), J, K, w32)
    bid_argmin.launches += 1
    return best, choice


bid_argmin.launches = 0

_K2_TILE_WORDS = 32  # word columns per block, one per lane (csrc/fanout_add.cu)
_K2_BLOCKS = 128     # blocks aimed for (one per SM); a constant, so the
                     # summation order does not depend on the card
_K2_MIN_ROWS = 256   # least rows per chunk: 8 per warp
_K2_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_k2_counters: dict = {}


def fanout_chunks(K: int, w32: int) -> "tuple[int, int]":
    """(S, rows per chunk): K2 sums each chunk of rows per block and then the
    S chunk sums in order — a function of the shape alone, so fractional
    sums round identically on every card."""
    word_tiles = math.ceil(w32 / _K2_TILE_WORDS)
    s = max(1, min(math.ceil(K / _K2_MIN_ROWS), _K2_BLOCKS // word_tiles))
    rows = math.ceil(K / s)
    return math.ceil(K / rows), rows


def _zeroed_counters(dev: torch.device, n: int) -> torch.Tensor:
    """K2's per-word-tile arrival counters: zero between launches, because
    the last block of each tile resets its own."""
    c = _k2_counters.get(dev)
    if c is None or c.numel() < n:
        c = _k2_counters[dev] = torch.zeros(max(n, 64), dtype=torch.int32,
                                            device=dev)
    return c


def fanout_add(packed: torch.Tensor, weights: torch.Tensor,
               rows=None) -> torch.Tensor:
    """Per-node total weight of the jobs eligible there (K2):
    out[n] = sum_j weights[j] * bit(j, n).

    Args:
      packed: [J, W32] int32 eligibility bit patterns — the bucket's tile,
        or with ``rows`` the whole table.
      weights: [K] f32, non-negative; a row of weight 0 is not read.
      rows: optional [K] int32 in [0, J) — row j of the tile is
        ``packed[rows[j]]``.
    Returns: [W32*32] f32, natural node order.
    """
    J, w32 = _check_packed("fanout_add", packed)
    K = _bucket_size("fanout_add", packed, rows)
    _check_vector("fanout_add", packed, weights, K)
    if packed.device.type == "cpu":
        return fanout_add_plain(packed, weights, rows)
    dev = packed.device
    out = torch.empty(w32 * 32, dtype=torch.float32, device=dev)
    if K == 0 or w32 == 0:
        return out.zero_()
    s, chunk = fanout_chunks(K, w32)
    partial = torch.empty((s, w32 * 32), dtype=torch.float32, device=dev)
    counters = _zeroed_counters(dev, math.ceil(w32 / _K2_TILE_WORDS))
    _launch("fanout_add", _K2_ARGS, dev, packed.data_ptr(), _ptr(rows),
            weights.data_ptr(), partial.data_ptr(), counters.data_ptr(),
            out.data_ptr(), J, K, w32, s, chunk)
    fanout_add.launches += 1
    return out


fanout_add.launches = 0

WRAPPERS = (bid_argmin, fanout_add)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
