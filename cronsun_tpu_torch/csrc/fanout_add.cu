// K2 fanout_add — per node, the total weight of the jobs eligible there.
//
// Replaces the Pallas TPU kernel cronsun_tpu/ops/pallas_kernels.py:185
// (`fanout_add`, body `_fanout_kernel` :165-181), which ran one MXU
// [1, TJ] x [TJ, TW] dot per bit plane.
//
// Computes out[n] = sum_j weights[j] * bit(j, n) over packed[K, W32]
// (node n = w*32 + b is bit b of word w), in natural node order.
//
// What bounds it on an H100: it reads 4*K*W32 + 4*K bytes once (21 MB at
// K = 16384, N = 10240: ~6 us at 3.35 TB/s) and does one add per set bit
// (~84 M at half density, ~1.3 us at the fp32 rate), so memory bandwidth is
// the bound.
//
// Design: deterministic two passes, no float atomics — plans must be
// reproducible run to run, and multi-host planners require bit-identical
// inputs across ranks.
//   Pass 1: grid (word tiles x S row chunks).  A thread owns one word column
//   w and walks the rows of its chunk; a warp's loads of one row are one
//   coalesced line, and the row's weight is a broadcast.  The 32 per-bit sums
//   live in registers (acc[b] += bit ? w_j : 0, a fixed row order) and are
//   written once to partial[s, w*32 + b].
//   Pass 2: one thread per node sums partial[0..S-1, n] in order s = 0, 1, ...
// S is chosen by the wrapper from (K, W32) alone, so the summation order —
// and every rounding of fractional weights — is the same on every card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fanout_partial_kernel(const uint32_t* __restrict__ packed,
                      const float* __restrict__ weights,
                      float* __restrict__ partial, int K, int W32,
                      int rows_per_chunk) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W32) return;
  const int s = blockIdx.y;
  const int r0 = s * rows_per_chunk;
  const int r1 = min(K, r0 + rows_per_chunk);
  float acc[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) acc[b] = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const uint32_t bits = __ldg(packed + static_cast<size_t>(r) * W32 + w);
    const float wt = __ldg(weights + r);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      acc[b] = __fadd_rn(acc[b], ((bits >> b) & 1u) ? wt : 0.0f);
    }
  }
  float* out = partial + static_cast<size_t>(s) * W32 * 32 +
               static_cast<size_t>(w) * 32;
#pragma unroll
  for (int b = 0; b < 32; ++b) out[b] = acc[b];
}

__global__ void fanout_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int S,
                                     int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    acc = __fadd_rn(acc, partial[static_cast<size_t>(s) * n_nodes + n]);
  }
  out[n] = acc;
}

}  // namespace

// Both passes on `stream`; `partial` is [S, W32*32] f32 scratch.  Returns
// cudaGetLastError() (0 on success).
extern "C" int cronsun_fanout_add(const void* packed, const void* weights,
                                  void* partial, void* out, int K, int W32,
                                  int S, int rows_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_nodes = W32 * 32;
  const dim3 grid1((W32 + kThreads - 1) / kThreads, S);
  fanout_partial_kernel<<<grid1, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(packed),
      static_cast<const float*>(weights), static_cast<float*>(partial), K,
      W32, rows_per_chunk);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fanout_reduce_kernel<<<(n_nodes + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), S,
      n_nodes);
  return static_cast<int>(cudaGetLastError());
}
