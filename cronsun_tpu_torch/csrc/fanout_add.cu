// K2 fanout_add — per node, the total weight of the jobs eligible there.
//
// Replaces the Pallas TPU kernel cronsun_tpu/ops/pallas_kernels.py:185
// (`fanout_add`, body `_fanout_kernel` :165-181), which ran one MXU
// [1, TJ] x [TJ, TW] dot per bit plane.
//
// Computes out[n] = sum_j weights[j] * bit(j, n) over a bucket of rows of a
// bit-packed eligibility table (node n = w*32 + b is bit b of word w; row j
// is table[rows[j]], or table[j] without `rows`), in natural node order.
// Weights are non-negative; a row of weight 0 is not read.  A row index
// outside [0, J) stops the kernel with __trap(), as PyTorch's own indexing
// stops with a device-side assert; the index is clamped first, so no read
// leaves the table.
//
// What bounds it on an H100: it reads 4*W32 bytes per row of nonzero weight
// and 8 bytes per row of the bucket once (21 MB at K = 16384, N = 10240,
// every row weighted: ~6 us at 3.35 TB/s) and does one add per set bit (~79 M
// at half density, ~1.2 us at the fp32 rate), so memory bandwidth is the
// bound.
//
// Design: one launch, deterministic, no float atomics — plans must be
// reproducible run to run, and multi-host planners require bit-identical
// inputs across ranks.
// - Grid (word tiles of 32 words) x (S row chunks); 32 warps a block.  A lane
//   owns one word column, so a warp's read of a row is one 128-byte line and
//   the row's weight a shuffle.  Warp q of a chunk takes its rows q, q+32, ...
//   in order; each lane keeps the 32 per-bit sums in registers and adds the
//   weight under the bit (a predicated add: for non-negative weights the
//   same bits as adding +0.0).
// - Rows come 32 at a time: the warp loads their indices and weights in one
//   step, and a __ballot_sync of the nonzero weights is the warp-uniform list
//   of rows to read — padded bucket slots (weight 0) cost nothing more.
//   Their words arrive through a per-warp cp.async ring kDepth rows deep.
// - The block adds its warps' sums in shared memory in warp order and writes
//   one partial row per chunk; the last block of a word tile to arrive (an
//   integer counter, reset by that block) adds the S partials in chunk order.
//   S depends on the shape alone (the wrapper's fanout_chunks), so the
//   summation order — and every rounding of fractional weights — is the same
//   on every card.
// - One block of 32 warps per SM (1024 threads, at most 64 registers, ~196
//   KB of shared memory), and the shape's block count aimed at the SM count
//   of an H100, so a call is one wave, the S chunk sums of a tile are few,
//   and the last block's sum over them is short.
// Tensor cores do not apply: a product with one weight vector (M = 1) reuses
// nothing, the per-element cost is unpacking the bits whatever unit adds
// them, and TF32 would round the fractional weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kDepth = 16;       // rows in flight per warp
constexpr int kTileWords = 32;   // one per lane
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kDepth - 1) : "memory");
}

// dynamic shared memory: the per-warp rings, then the warps' sums
constexpr size_t kRingBytes = sizeof(uint32_t) * kWarps * kDepth * 32;
constexpr size_t kSmemBytes = kRingBytes + sizeof(float) * kWarps * 32 * 33;

__global__ void __launch_bounds__(kThreads, 1)
fanout_add_kernel(const uint32_t* __restrict__ table,
                  const int32_t* __restrict__ rows,
                  const float* __restrict__ weights,
                  float* __restrict__ partial, int* __restrict__ counters,
                  float* __restrict__ out, int J, int K, int W32, int S,
                  int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  // ring[warp][slot][lane]; red[warp][lane*33 + b] (padded: no conflicts)
  auto ring = reinterpret_cast<uint32_t(*)[kDepth][32]>(smem);
  auto red = reinterpret_cast<float(*)[32 * 33]>(smem + kRingBytes);
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int s = blockIdx.y;
  const int w = tile * kTileWords + lane;
  const bool has_w = w < W32;
  const size_t n_nodes = static_cast<size_t>(W32) * 32;
  const int r0 = s * rows_per_chunk;
  const int r1 = min(K, r0 + rows_per_chunk);

  float acc[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) acc[b] = 0.0f;

  for (int base = r0 + warp; base < r1; base += kWarps * 32) {
    // lane e holds the batch's e-th row of this warp
    const int r = base + kWarps * lane;
    float wt = 0.0f;
    long long src = 0;
    if (r < r1) {
      wt = __ldg(weights + r);
      src = r;
      if (rows) {
        const uint32_t v = static_cast<uint32_t>(__ldg(rows + r));
        const bool ok = v < static_cast<uint32_t>(J);
        src = ok ? v : 0;
        if (!ok) __trap();
      }
    }
    uint32_t todo = __ballot_sync(kFull, wt != 0.0f);
    uint32_t pend = todo;
    int issued = 0;
    int used = 0;
    auto issue_next = [&]() {
      if (pend) {   // warp-uniform
        const int e = __ffs(pend) - 1;
        pend &= pend - 1;
        const long long row = __shfl_sync(kFull, src, e);
        if (has_w) {
          cp_async4(&ring[warp][issued % kDepth][lane],
                    table + row * W32 + w);
        }
        ++issued;
      }
      cp_async_commit();   // one group per step, empty or not
    };
#pragma unroll
    for (int d = 0; d < kDepth - 1; ++d) issue_next();
    while (todo) {
      issue_next();
      cp_async_wait_oldest();
      const int e = __ffs(todo) - 1;
      todo &= todo - 1;
      const float wt_e = __shfl_sync(kFull, wt, e);
      const uint32_t bits = has_w ? ring[warp][used % kDepth][lane] : 0u;
      ++used;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if ((bits >> b) & 1u) acc[b] = __fadd_rn(acc[b], wt_e);
      }
    }
  }

  // the block's sum, warps in order
#pragma unroll
  for (int b = 0; b < 32; ++b) red[warp][lane * 33 + b] = acc[b];
  __syncthreads();
  const int tile_nodes = min(kTileWords, W32 - tile * kTileWords) * 32;
  const size_t node0 = static_cast<size_t>(tile) * kTileWords * 32;
  const int i = threadIdx.x;   // one node of the tile per thread
  if (i < tile_nodes) {
    const int off = (i >> 5) * 33 + (i & 31);
    float v = red[0][off];
#pragma unroll 8
    for (int q = 1; q < kWarps; ++q) v = __fadd_rn(v, red[q][off]);
    partial[s * n_nodes + node0 + i] = v;
  }

  // the last block of this word tile adds the chunks, in order.  The
  // barrier orders the block's partial stores before thread 0's fence, and
  // the fence (cumulative) before its arrival on the counter.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counters + tile, 1) == S - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (i < tile_nodes) {
    float v = 0.0f;
#pragma unroll 8
    for (int q = 0; q < S; ++q) {
      v = __fadd_rn(v, __ldcg(partial + q * n_nodes + node0 + i));
    }
    out[node0 + i] = v;
  }
  if (threadIdx.x == 0) counters[tile] = 0;   // ready for the next launch
}

}  // namespace

// One launch on `stream`.  `rows` may be null, J is the table's row count;
// `partial` is [S, W32*32] f32 scratch; `counters` holds ceil(W32 / 32) ints that are zero on entry and
// on exit.  Returns cudaGetLastError() (0 on success).
extern "C" int cronsun_fanout_add(const void* table, const void* rows,
                                  const void* weights, void* partial,
                                  void* counters, void* out, int J, int K,
                                  int W32, int S, int rows_per_chunk,
                                  void* stream) {
  static bool opted[64];   // per device: the shared-memory opt-in is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(fanout_add_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const dim3 grid((W32 + kTileWords - 1) / kTileWords, S);
  fanout_add_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(rows),
      static_cast<const float*>(weights), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<float*>(out), J, K, W32, S,
      rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}
