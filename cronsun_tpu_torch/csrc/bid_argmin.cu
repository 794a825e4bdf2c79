// K1 bid_argmin — per job row, the least-loaded open eligible node.
//
// Replaces the Pallas TPU kernel cronsun_tpu/ops/pallas_kernels.py:119
// (`bid_argmin`, body `_bid_kernel` :66-105, hash `_tie` :55-63).
//
// Computes, for each row j of a bit-packed eligibility tile packed[K, W32]
// (node n = w*32 + b is bit b of word w):
//   best[j]   = min over set bits n of  load_eff[n] + tie(j, n)
//   choice[j] = its node; exact ties go to the lower (b, w) pair — the bit
//               plane first, then the word — which is the order the TPU
//               kernel scans in.  A row with no eligible open node (no set
//               bit, or only +inf loads) gives best = +inf, choice = 0.
// tie() is a 16-bit multiply-xorshift hash of (row index within the tile,
// node id) in uint32 arithmetic, which wraps and shifts logically in C++.
//
// What bounds it on an H100: each row reads 4*W32 bytes once (21 MB per
// call at K = 16384, N = 10240: ~6 us at 3.35 TB/s), but every set bit costs
// a hash (three 32-bit multiplies, two xors, two shifts, a convert, an add
// and a compare) — ~84 M hashes at half density, so the 32-bit ALU, not
// memory, is the bound.
//
// Design: one warp per row, grid-strided over rows.  Lanes take consecutive
// words of the row, so each warp load is one coalesced 128-byte line; a lane
// walks only the set bits of its words with __ffs, so empty rows and sparse
// rows cost almost nothing.  load_eff sits in shared memory when 4*N fits the
// default 48 KB (N <= 12288, the 10k-node fleet), otherwise it is read through
// the read-only cache (__ldg) — wide fleets of any width stay correct.  Each
// lane keeps a lexicographic (score, b*W32 + w) minimum; five xor shuffles
// reduce it across the warp.  No atomics, no tiling constraint on K or W32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHashA = 2654435761u;
constexpr uint32_t kHashB = 40503u;
constexpr uint32_t kHashC = 2246822519u;
constexpr uint32_t kHashD = 3266489917u;
constexpr int kWarpsPerBlock = 16;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr size_t kSmemLimit = 48 * 1024;

// tie(j, n) with ja = j * kHashA precomputed per row
__device__ __forceinline__ float tie(uint32_t ja, uint32_t n) {
  uint32_t h = ja ^ (n * kHashB);
  h *= kHashC;
  h ^= h >> 15;
  h *= kHashD;
  // h >> 16 fits 16 bits: the int detour and the power-of-two scale are exact
  return __fmul_rn(static_cast<float>(static_cast<int>(h >> 16)),
                   1.0f / 65536.0f);
}

__device__ __forceinline__ bool lex_less(float s, uint32_t p, float bs,
                                         uint32_t bp) {
  return s < bs || (s == bs && p < bp);
}

template <bool kLoadInSmem>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bid_argmin_kernel(const uint32_t* __restrict__ packed,
                  const float* __restrict__ load_eff,
                  float* __restrict__ best_out,
                  int32_t* __restrict__ choice_out, int K, int W32) {
  extern __shared__ float s_load[];
  const int n_nodes = W32 * 32;
  if (kLoadInSmem) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
      s_load[i] = load_eff[i];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t w32 = static_cast<uint32_t>(W32);
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < K;
       row += gridDim.x * kWarpsPerBlock) {
    const uint32_t* words = packed + static_cast<size_t>(row) * W32;
    const uint32_t ja = static_cast<uint32_t>(row) * kHashA;
    float best = __int_as_float(0x7f800000);  // +inf
    uint32_t best_p = kNone;
    for (int w = lane; w < W32; w += 32) {
      uint32_t bits = __ldg(words + w);
      while (bits) {
        const uint32_t b = static_cast<uint32_t>(__ffs(bits) - 1);
        bits &= bits - 1;
        const uint32_t n = static_cast<uint32_t>(w) * 32u + b;
        const float l = kLoadInSmem ? s_load[n] : __ldg(load_eff + n);
        const float s = __fadd_rn(l, tie(ja, n));
        const uint32_t p = b * w32 + static_cast<uint32_t>(w);
        // +inf scores (closed nodes) never win: they equal "no candidate"
        if (s < __int_as_float(0x7f800000) && lex_less(s, p, best, best_p)) {
          best = s;
          best_p = p;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best, off);
      const uint32_t op = __shfl_xor_sync(0xffffffffu, best_p, off);
      if (lex_less(os, op, best, best_p)) {
        best = os;
        best_p = op;
      }
    }
    if (lane == 0) {
      best_out[row] = best;
      choice_out[row] = best_p == kNone
          ? 0
          : static_cast<int32_t>((best_p % w32) * 32u + best_p / w32);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cronsun_bid_argmin(const void* packed, const void* load_eff,
                                  void* best, void* choice, int K, int W32,
                                  int grid, void* stream) {
  const size_t smem = static_cast<size_t>(W32) * 32 * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarpsPerBlock * 32);
  if (smem <= kSmemLimit) {
    bid_argmin_kernel<true><<<grid, block, smem, st>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const float*>(load_eff), static_cast<float*>(best),
        static_cast<int32_t*>(choice), K, W32);
  } else {
    bid_argmin_kernel<false><<<grid, block, 0, st>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const float*>(load_eff), static_cast<float*>(best),
        static_cast<int32_t*>(choice), K, W32);
  }
  return static_cast<int>(cudaGetLastError());
}
