// K1 bid_argmin — per job row, the least-loaded open eligible node.
//
// Replaces the Pallas TPU kernel cronsun_tpu/ops/pallas_kernels.py:119
// (`bid_argmin`, body `_bid_kernel` :66-105, hash `_tie` :55-63).
//
// Computes, for each row j of a bucket over a bit-packed eligibility table
// (node n = w*32 + b is bit b of word w; row j is table[rows[j]], or
// table[j] without `rows`):
//   best[j]   = min over set bits n of  load_eff[n] + tie(j, n)
//   choice[j] = its node; exact ties go to the lower (b, w) pair — the bit
//               plane first, then the word — which is the order the TPU
//               kernel scans in.  A row with no eligible open node (no set
//               bit, or only +inf loads) gives best = +inf, choice = 0, and
//               so does a row that `active` marks 0, which reads nothing.
// tie() is a 16-bit multiply-xorshift hash of (j, n) in uint32 arithmetic —
// j is the row's place in the bucket, never rows[j].
//
// What bounds it on an H100: each active row reads 4*W32 bytes once (21 MB
// per call at K = 16384, N = 10240: ~6 us at 3.35 TB/s).  Hashing every set
// bit (~10 integer operations each, ~79 M bits) would cost ~12 us at the
// 32-bit rate, but most hashes are provably useless, so the design aims at
// the bytes:
// - Exact pruning.  tie() is in [0, 1), so s = fl(l + t) >= l: a set bit
//   whose load l exceeds the row's best can neither win nor tie, and needs
//   no hash.  Bits with l == best are kept, so the tie order is untouched,
//   and the rule holds in any scan order.  Per node tile the block builds
//   word masks from a threshold theta, the largest of the 32 planes' least
//   loads: a row with any set bit of load <= theta keeps only its bits of
//   load <= fl(theta + 65535/65536), the most its best can be, so most set
//   bits are dropped a word at a time without reading their loads.  Other
//   rows drop closed nodes' bits.
// - The tie's conversion without I2F: (h >> 16) placed in the mantissa of
//   1.0f, minus 1.0f, is float(h >> 16) / 65536 bit for bit (the subtraction
//   is exact by Sterbenz's lemma).
// - Load planes in shared memory: load_eff transposed to 32 planes
//   [32][W32p] — the TPU kernel's load_t layout — with W32p a multiple of 32,
//   so lanes on consecutive words hit 32 distinct banks whatever their bit.
//   Staged with coalesced loads transposed in registers (xor shuffles),
//   while each warp's first row is already on its way.
//   Past kMaxWholeWords the node axis is tiled through shared memory and
//   (best, priority) carried across tiles in the outputs, as the TPU kernel
//   tiles 512 words.
// - Row words through an asynchronous ring: per warp two buffers, each
//   filled by one cp.async.bulk of the row's words with completion on an
//   mbarrier, so the next active row arrives while the current one computes.
//   TMA tensor maps do not serve: Hopper's TMA has no row gather.  Where a
//   row is not 16-byte aligned (4*W32 not a multiple of 16) lanes load
//   their words directly.
// - Balance: a persistent grid, sized from the SM count and the resident
//   blocks the occupancy API reports (one block of 32 warps per SM, so each
//   SM stages the planes once); a warp walks rows on a fixed stride, reading
//   32 rows' flags and table rows at once, and an inactive row costs only
//   its flag and index.
// - The walk of a row's set bits: each lane walks the set bits of all its
//   words as one stream with __ffs, kBatch bits a step hashed without
//   branches so their latencies overlap.  (A warp-cooperative walk — the
//   candidate bits of 32 words compacted into a shared list by a __popc
//   prefix and dealt out 32 at a time — measured slower on every input.)
// - A row index outside [0, J) stops the kernel with __trap(), as PyTorch's
//   own indexing stops with a device-side assert; the index is clamped
//   first, so no read leaves the table.
// Tensor cores do not apply: K1 computes no product.
// Each lane keeps a lexicographic (score, b*W32 + w) minimum; five xor
// shuffles reduce it across the warp.  No atomics.
//
// K1n (cronsun_bid_argmin_natural) is the same kernel in natural tie order
// with a column offset: the reference computes it in jnp, not in Pallas
// (`bid_block_jnp(packed, load_blk, col0, bitplane_ties=False)`,
// cronsun_tpu/ops/assign.py:55-83), once per node block of the 2-D mesh
// (cronsun_tpu/parallel/mesh.py:315-324).  The block holds the global nodes
// col0 .. col0 + 32*W32 - 1, so
//   best[j]   = min over set bits n of  load_eff[n] + tie(j, col0 + n)
//   choice[j] = col0 + n, exact ties to the lowest n — the lowest global
//               node id, so placements do not depend on how the 2-D mesh
//               splits its columns; col0 when there is no candidate (or the
//               row is inactive).
// Only the key changes: the hash takes col0 + n and the lexicographic key
// is (score, n = w*32 + b).  Score and key travel together through the
// lanes' minimum and the shuffles; the load planes, the pruning (which
// keeps every bit with l == best) and the ring are K1's unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHashA = 2654435761u;
constexpr uint32_t kHashB = 40503u;
constexpr uint32_t kHashC = 2246822519u;
constexpr uint32_t kHashD = 3266489917u;
constexpr int kWarps = 32;          // one block per SM: planes staged once
constexpr int kThreads = kWarps * 32;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxWholeWords = 384;   // padded row width held as one tile
constexpr int kTileWords = 256;       // node tile past that width
constexpr int kBatch = 4;             // set bits hashed per step
constexpr float kTieMax = 65535.0f / 65536.0f;   // the largest tie()

struct Params {
  const uint32_t* table;
  const int32_t* rows;      // may be null: row j is table[j]
  const uint8_t* active;    // may be null: every row is active
  const float* load_eff;
  float* best;
  int32_t* choice;
  int J, K, W32;            // table rows, bucket rows, words per row
  int col0;                 // K1n: global id of the block's node 0
  int tile;                 // words per node tile
  int tile_p;               // its padded width (plane stride), % 32 == 0
  int n_tiles;
};

// Layout: planes [32][tile_p] f32, three word masks [tile_p], the row ring
// [warps][2][tile_p] words and its mbarriers.
size_t smem_bytes(int tile_p, bool bulk) {
  size_t b = 140ull * tile_p;
  if (bulk) b += 8ull * kWarps * tile_p + 2ull * kWarps * 8;
  return b;
}

// x[i] = M[i][lane] of a 32 x 32 matrix in; x[i] = M[lane][i] out: five
// butterfly stages of xor shuffles, with static register indices
__device__ __forceinline__ void warp_transpose(float (&x)[32], int lane) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & m) continue;
      const float send = upper ? x[i] : x[i | m];
      const float recv = __shfl_xor_sync(kFull, send, m);
      if (upper) {
        x[i] = recv;
      } else {
        x[i | m] = recv;
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One lane: `bytes` of global memory at `src` into shared `dst`, completion
// counted on `bar`.  The fence orders the warp's earlier generic reads of
// `dst` before the async proxy's write.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// tie(j, n) with ja = j * kHashA precomputed per row
__device__ __forceinline__ float tie(uint32_t ja, uint32_t n) {
  uint32_t h = ja ^ (n * kHashB);
  h *= kHashC;
  h ^= h >> 15;
  h *= kHashD;
  return __fsub_rn(__uint_as_float(0x3F800000u | ((h >> 16) << 7)), 1.0f);
}

__device__ __forceinline__ bool lex_less(float s, uint32_t p, float bs,
                                         uint32_t bp) {
  return s < bs || (s == bs && p < bp);
}

// Row state of one lane: its running lexicographic minimum.  K1 keys ties
// by (b, w): b*W32 + w; K1n (kNatural) by the node n = w*32 + b and hashes
// col0 + n.
template <bool kNatural>
struct Lane {
  float best;
  uint32_t prio;
  uint32_t ja;
  uint32_t w32;
  uint32_t col0;

  // set bit b of word w with load l (+inf: not a candidate); no branch
  __device__ __forceinline__ void consider(float l, uint32_t b, uint32_t w) {
    const uint32_t n = w * 32u + b;
    const float s = __fadd_rn(l, tie(ja, kNatural ? col0 + n : n));
    const uint32_t p = kNatural ? n : b * w32 + w;
    const bool take = s < __int_as_float(0x7f800000) &&
                      lex_less(s, p, best, prio);
    best = take ? s : best;
    prio = take ? p : prio;
  }
};

template <bool kBulk, bool kNatural>
__global__ void __launch_bounds__(kThreads)
bid_argmin_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane_bytes = 140ull * p.tile_p;   // planes, then masks
  const size_t ring_size = kBulk ? 8ull * kWarps * p.tile_p : 0;
  float* planes = reinterpret_cast<float*>(smem);
  uint32_t* hit_mask = reinterpret_cast<uint32_t*>(smem + 128ull * p.tile_p);
  uint32_t* cand_mask = hit_mask + p.tile_p;
  uint32_t* open_mask = cand_mask + p.tile_p;
  __shared__ float plane_min[32];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + plane_bytes) +
                   2ull * warp * p.tile_p;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plane_bytes +
                                               ring_size) + 2 * warp;
  if (kBulk && lane == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float inf = __int_as_float(0x7f800000);
  const uint32_t w32 = static_cast<uint32_t>(p.W32);
  const int nwarps = gridDim.x * kWarps;
  uint32_t parity = 0;   // bit i: the phase buffer i completes next

  for (int t = 0; t < p.n_tiles; ++t) {
    const int w0 = t * p.tile;
    const int tw = min(p.tile, p.W32 - w0);
    const bool first = t == 0;
    const bool last = t == p.n_tiles - 1;
    // this warp's rows (a fixed stride), 32 at a time: lane e reads the
    // flag and table row of row base + e * nwarps, so the loads overlap;
    // an inactive row's result is written once, on the first tile
    int base = blockIdx.x * kWarps + warp;
    uint32_t pending = 0u;   // bit e: row base + e * nwarps still to bid
    int64_t lane_src = 0;
    auto load_batch = [&]() {
      const int r = base + lane * nwarps;
      const bool in = r < p.K;
      const bool act = in && (p.active == nullptr || p.active[r]);
      int64_t src_r = r;
      if (in && p.rows) {
        const uint32_t v = static_cast<uint32_t>(p.rows[r]);
        const bool ok = v < static_cast<uint32_t>(p.J);
        src_r = ok ? v : 0;
        if (!ok) __trap();
      }
      lane_src = act ? src_r : 0;
      if (first && in && !act) {
        p.best[r] = inf;
        p.choice[r] = kNatural ? p.col0 : 0;
      }
      pending = __ballot_sync(kFull, act);
    };
    if (base < p.K) load_batch();
    // the next active row (p.K when none is left) and its table row
    auto next_row = [&](int64_t& src) {
      while (pending == 0u) {
        base += 32 * nwarps;
        if (base >= p.K) return p.K;
        load_batch();
      }
      const int e = __ffs(pending) - 1;
      pending &= pending - 1;
      src = __shfl_sync(kFull, lane_src, e);
      return base + e * nwarps;
    };
    auto issue = [&](int64_t src, int buf) {
      if (lane == 0) {
        bulk_load(ring + buf * p.tile_p, p.table + src * w32 + w0,
                  static_cast<uint32_t>(tw) * 4u, bars + buf);
      }
    };

    __syncthreads();   // the previous tile's plane and ring reads are done
    // the warp's first active row starts on its way before the planes are
    // staged (the ring is not part of the staging)
    int64_t src = 0;
    int j = next_row(src);
    if (kBulk && j < p.K) issue(src, 0);
    // stage load planes 32 words a warp: coalesced loads (lane = bit),
    // transposed in registers (lane = word), conflict-free stores
    for (int wb = warp * 32; wb < tw; wb += kWarps * 32) {
      const int nw = min(32, tw - wb);
      const float* src = p.load_eff + static_cast<size_t>(w0 + wb) * 32;
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = i < nw ? src[i * 32 + lane] : inf;
      warp_transpose(x, lane);
      if (lane < nw) {
#pragma unroll
        for (int b = 0; b < 32; ++b) planes[b * p.tile_p + wb + lane] = x[b];
      }
    }
    __syncthreads();
    // candidate masks: theta is the largest of the 32 planes' least finite
    // loads.  A row with a set bit of load <= theta has best <=
    // fl(theta + kTieMax) (rounding is monotone), so its bits of greater
    // load are pruned without reading their loads; other rows walk the
    // bits of open nodes.
    for (int b = warp; b < 32; b += kWarps) {
      float m = inf;
      for (int wl = lane; wl < tw; wl += 32) {
        m = fminf(m, planes[b * p.tile_p + wl]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fminf(m, __shfl_xor_sync(kFull, m, off));
      }
      if (lane == 0) plane_min[b] = m;
    }
    __syncthreads();
    float theta = -inf;
    for (int b = 0; b < 32; ++b) {
      if (plane_min[b] < inf) theta = fmaxf(theta, plane_min[b]);
    }
    const float upper = __fadd_rn(theta, kTieMax);
    for (int wl = threadIdx.x; wl < tw; wl += kThreads) {
      uint32_t h = 0u, c = 0u, o = 0u;
#pragma unroll 8
      for (int b = 0; b < 32; ++b) {
        const float l = planes[b * p.tile_p + wl];
        h |= static_cast<uint32_t>(l <= theta) << b;
        c |= static_cast<uint32_t>(l <= upper) << b;
        o |= static_cast<uint32_t>(l < inf) << b;
      }
      hit_mask[wl] = h;
      cand_mask[wl] = c;
      open_mask[wl] = o;
    }
    __syncthreads();

    int buf = 0;
    while (j < p.K) {
      int64_t nsrc = 0;
      const int nxt = next_row(nsrc);
      if (kBulk && nxt < p.K) issue(nsrc, buf ^ 1);
      const uint32_t* words;
      if (kBulk) {
        mbar_wait(bars + buf, (parity >> buf) & 1u);
        parity ^= 1u << buf;
        words = ring + buf * p.tile_p;
      } else {
        words = p.table + src * w32 + w0;
      }
      Lane<kNatural> st;
      st.ja = static_cast<uint32_t>(j) * kHashA;
      st.w32 = w32;
      st.col0 = static_cast<uint32_t>(p.col0);
      if (first) {
        st.best = inf;
        st.prio = kNone;
      } else {   // carried from the previous tile
        st.best = p.best[j];
        st.prio = static_cast<uint32_t>(p.choice[j]);
      }
      uint32_t hit = 0u;
      for (int wl = lane; wl < tw; wl += 32) {
        hit |= (kBulk ? words[wl] : __ldg(words + wl)) & hit_mask[wl];
      }
      const bool narrow = __any_sync(kFull, hit != 0u);
      auto row_word = [&](int wl) {
        const uint32_t bits = kBulk ? words[wl] : __ldg(words + wl);
        return bits & (narrow ? cand_mask[wl] : open_mask[wl]);
      };
      // the lane's words as one stream of set bits, kBatch a step, hashed
      // without a branch: the hashes are independent, so their latencies
      // overlap, and the warp steps as often as its busiest lane has
      // candidates in all its words (not in each word)
      int wl = lane;
      uint32_t bits = wl < tw ? row_word(wl) : 0u;
      bool more = true;
      while (more) {
        uint32_t bb[kBatch], ww[kBatch];
        float ll[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          while (bits == 0u && wl + 32 < tw) {
            wl += 32;
            bits = row_word(wl);
          }
          ww[u] = static_cast<uint32_t>(wl);
          bb[u] = bits ? static_cast<uint32_t>(__ffs(bits) - 1) : 0u;
          ll[u] = bits ? planes[bb[u] * p.tile_p + wl] : inf;
          bits &= bits - 1;
        }
        more = bits != 0u || wl + 32 < tw;
        float lmin = ll[0];
#pragma unroll
        for (int u = 1; u < kBatch; ++u) lmin = fminf(lmin, ll[u]);
        if (lmin <= st.best) {   // else no bit of the step can win or tie
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            st.consider(ll[u], bb[u], w0 + ww[u]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(kFull, st.best, off);
        const uint32_t op = __shfl_xor_sync(kFull, st.prio, off);
        if (lex_less(os, op, st.best, st.prio)) {
          st.best = os;
          st.prio = op;
        }
      }
      if (lane == 0) {
        p.best[j] = st.best;
        if (!last) {
          p.choice[j] = static_cast<int32_t>(st.prio);   // carried priority
        } else if (kNatural) {
          p.choice[j] = p.col0 + (st.prio == kNone
                                      ? 0
                                      : static_cast<int32_t>(st.prio));
        } else {
          p.choice[j] = st.prio == kNone
              ? 0
              : static_cast<int32_t>((st.prio % w32) * 32u + st.prio / w32);
        }
      }
      __syncwarp();   // every lane is done with this ring buffer
      j = nxt;
      src = nsrc;
      buf ^= 1;
    }
  }
}

template <bool kBulk, bool kNatural>
int launch(const Params& p, size_t smem, cudaStream_t st) {
  auto kern = bid_argmin_kernel<kBulk, kNatural>;
  struct Cfg {
    size_t smem;
    int blocks_per_sm;
    int sms;
  };
  static Cfg cfg[64];   // per device; the attribute and occupancy follow smem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  Cfg& c = cfg[dev];
  if (c.smem != smem || c.sms == 0) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.blocks_per_sm,
                                                        kern, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (c.blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    c.smem = smem;
  }
  const int want = (p.K + kWarps - 1) / kWarps;
  const int grid = want < c.sms * c.blocks_per_sm ? want
                                                  : c.sms * c.blocks_per_sm;
  kern<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNatural>
int launch_entry(const void* table, const void* rows, const void* active,
                 const void* load_eff, void* best, void* choice, int J, int K,
                 int W32, int col0, void* stream) {
  Params p;
  p.table = static_cast<const uint32_t*>(table);
  p.rows = static_cast<const int32_t*>(rows);
  p.active = static_cast<const uint8_t*>(active);
  p.load_eff = static_cast<const float*>(load_eff);
  p.best = static_cast<float*>(best);
  p.choice = static_cast<int32_t*>(choice);
  p.J = J;
  p.K = K;
  p.W32 = W32;
  p.col0 = col0;
  const int w32p = (W32 + 31) / 32 * 32;
  if (w32p <= kMaxWholeWords) {
    p.tile = W32;
    p.tile_p = w32p;
    p.n_tiles = 1;
  } else {
    p.tile = kTileWords;
    p.tile_p = kTileWords;
    p.n_tiles = (W32 + kTileWords - 1) / kTileWords;
  }
  // a tile's row segment is 16-byte aligned and sized when the row is
  const bool bulk = W32 % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const size_t smem = smem_bytes(p.tile_p, bulk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bulk ? launch<true, kNatural>(p, smem, st)
              : launch<false, kNatural>(p, smem, st);
}

}  // namespace

// K1: launch on `stream`; `rows` and `active` may be null, J is the table's
// row count.  Returns a CUDA error code (0 on success).
extern "C" int cronsun_bid_argmin(const void* table, const void* rows,
                                  const void* active, const void* load_eff,
                                  void* best, void* choice, int J, int K,
                                  int W32, void* stream) {
  return launch_entry<false>(table, rows, active, load_eff, best, choice, J,
                             K, W32, 0, stream);
}

// K1n: K1 in natural tie order over the node block starting at global node
// col0 (see the head of this file).  Same arguments as K1, plus col0.
extern "C" int cronsun_bid_argmin_natural(const void* table, const void* rows,
                                          const void* active,
                                          const void* load_eff, void* best,
                                          void* choice, int J, int K, int W32,
                                          int col0, void* stream) {
  return launch_entry<true>(table, rows, active, load_eff, best, choice, J, K,
                            W32, col0, stream);
}
