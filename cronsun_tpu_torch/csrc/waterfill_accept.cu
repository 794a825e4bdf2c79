// waterfill_accept — one accept round of the exclusive placement, in one
// launch.
//
// Replaces no TPU kernel: cronsun_tpu/ops/assign.py:331-363 computes the
// accept step in jnp, which XLA fuses.  The port's eager version of it (the
// plain route of ops/assign.py's waterfill_accept plus the placement update
// of _assign_excl) launches about a hundred device operations a round (115
// on a full headline bucket), and three of its calls wait for the stream;
// on the headline the host's issue of that chain set the pace.
//
// Computes, for a bucket of K bids (cand [K] bool, choice [K] int32 in
// [0, N), cost [K] f32) against the per-node state (load [N] f32, rem_cap
// [N] int32), the plain route's function:
//   level  = (sum of load over nodes with rem_cap > 0 + sum of the
//             candidates' costs) / max(open nodes, 1), each sum taken in
//             f64 and rounded once to f32
//   rank, cum: a candidate's place among the candidates of its node in
//             index order, and the cost of those before it
//   accept = rank < rem_cap[node]
//            & (is_final | rank == 0 | cum + cost <= level - load[node])
//   load_out[n]    = load[n] + (accepted cost of n, summed in f64, rounded
//                    once to f32)
//   rem_cap_out[n] = rem_cap[n] - accepted count of n
//   assigned_out   = accept ? choice : assigned   (when `assigned` is given)
// into fresh outputs; the inputs are not written.  A candidate whose choice
// lies outside [0, N) is never accepted.  Sums of costs are taken in f64 and
// rounded once, so they equal the plain route's f32 running sums bit for
// bit whenever those are exact (integer or dyadic costs).
//
// What bounds it on an H100: it reads and writes ~0.45 MB at K = 16384,
// N = 10240 (0.13 us at 3.35 TB/s) and does a few operations an element, so
// neither bytes nor operations bound it: it is a chain of dependent steps
// (a sort, two scans, their barriers) and latency bounds it.  The design
// keeps that chain short and on one SM:
// - One block of 1024 threads; keys, costs, histograms, ranks and scan
//   carries live in shared memory.  For the sort, bids are dealt to warps
//   in index order: warp w takes 32*IPT consecutive slots, 32 a round
//   (IPT = slots a thread, a power of two up to 16; unused slots hold a key
//   that sorts last).
// - The sort: a 32-bit key (node << idx_bits) | index — a non-candidate
//   takes node N — sorted by its node bits alone, least significant digit
//   first, 8 bits a pass (two passes at N < 65536).  A pass ranks each
//   round's digits among the warp's (8 ballots and a per-warp histogram),
//   scans the histograms, and scatters every key with its cost at once, so
//   it is stable by construction.  Keys sit one spare word in 33, so the
//   warps' rounds and the threads' runs below read 32 banks.
// - Two segmented scans over the sorted keys, thread t taking the run of
//   slots [t*IPT, t*IPT + IPT): the run's own sum, one warp scan and one
//   scan of the warps' sums give each thread the carry of the runs before
//   it, then the run again with the carry.  The first gives rank and
//   running cost (f64), so the verdicts, which land in shared memory by
//   index and go out in index order with the placements; the second sums
//   the accepted cost (f64) and count, and each segment's last slot writes
//   its node.  Every node is copied to the outputs first, many barriers
//   before that, so each output is complete when the launch ends.
// - A bucket larger than one pass of the block (16384 bids, or fewer where
//   the node bits leave the index fewer than 14 bits) is taken in chunks of
//   that size, in index order, by the same block in the same launch.  Each
//   chunk is sorted and scanned as above; a node's candidates of earlier
//   chunks count before its own (rank, running cost) and its accepted
//   totals carry over, through a per-node record in global scratch (`carry`,
//   24 bytes a node) that the launch zeroes first and that each segment's
//   last slot rewrites.  Reads of a record (the verdicts) and its rewrite
//   (after the second scan) are barriers apart, so no two threads race on
//   it.
// - No atomics and a fixed order for every sum: the result does not change
//   run to run.  A round with no candidate in range skips the sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kUnused = 0xFFFFFFFFu;   // a slot past the chunk: last
constexpr uint32_t kNoNode = 0xFFFFFFFFu;
constexpr int kMaxItems = 16;               // slots a thread in one pass
constexpr int kMaxChunk = kMaxItems * kThreads;

// A slot's word in the key buffer: one spare word every 32, so that a warp
// reading 32 consecutive slots and a thread reading its own run of IPT
// slots both meet 32 banks.
__host__ __device__ constexpr int pad(int p) { return p + (p >> 5); }

template <int IPT>
constexpr size_t smem_bytes() {
  // keys and their costs, then hist[warp][digit] and a rank a slot, u16
  return sizeof(uint32_t) * pad(kThreads * IPT) * 2 +
         sizeof(uint16_t) * (kWarps * kDigits + kThreads * IPT);
}

// A node's totals over the chunks before: its candidates and their cost,
// its accepted bids and their cost.
struct NodeCarry {
  int n;
  int acc_n;
  double s;
  double acc_s;
};
static_assert(sizeof(NodeCarry) == 24, "carry: 24 bytes a node");

// A run of a segmented sum: whether a segment starts in it, and the count
// and sum since the last start (or since its own start, with no head).
struct Seg {
  int head;
  int n;
  double s;
};

__device__ __forceinline__ Seg none() { return Seg{0, 0, 0.0}; }

// a to the left of b
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.head) return b;
  return Seg{a.head, a.n + b.n, a.s + b.s};
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int d) {
  return Seg{__shfl_up_sync(kFull, x.head, d), __shfl_up_sync(kFull, x.n, d),
             __shfl_up_sync(kFull, x.s, d)};
}

// inclusive segmented scan over the warp's 32 lanes, lane order
__device__ __forceinline__ Seg warp_scan(Seg x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up = shfl_up(x, d);
    if (lane >= d) x = combine(up, x);
  }
  return x;
}

// The combination of the runs `a` of every earlier thread (thread order),
// through the warps' aggregates in `agg`.  Called by every thread.
__device__ __forceinline__ Seg block_carry(const Seg& a, Seg* agg, int warp,
                                           int lane) {
  const Seg x = warp_scan(a, lane);
  Seg ex = shfl_up(x, 1);
  if (lane == 0) ex = none();
  if (lane == 31) agg[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const Seg y = warp_scan(agg[lane], lane);
    Seg ey = shfl_up(y, 1);
    if (lane == 0) ey = none();
    agg[lane] = ey;
  }
  __syncthreads();
  return combine(agg[warp], ex);
}

// the lanes whose digit equals this lane's (8 ballots: a cost that does not
// grow with the number of distinct digits, as __match_any_sync's does)
__device__ __forceinline__ uint32_t peers_of(uint32_t d) {
  uint32_t m = kFull;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const uint32_t v = __ballot_sync(kFull, (d >> b) & 1u);
    m &= ((d >> b) & 1u) ? v : ~v;
  }
  return m;
}

// kChunked: the bucket is taken `chunk` bids at a time (IPT = kMaxItems),
// with the per-node `carry`; else in one pass (K <= kThreads * IPT).
template <int IPT, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
waterfill_accept_kernel(const uint8_t* __restrict__ cand,
                        const int32_t* __restrict__ choice,
                        const float* __restrict__ cost,
                        const float* __restrict__ load,
                        const int32_t* __restrict__ rem_cap,
                        const int32_t* __restrict__ assigned,
                        uint8_t* __restrict__ accept_out,
                        float* __restrict__ load_out,
                        int32_t* __restrict__ rem_cap_out,
                        int32_t* __restrict__ assigned_out,
                        NodeCarry* __restrict__ carry, int K, int N,
                        int chunk, int idx_bits, int node_bits,
                        int is_final) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  float* costs = reinterpret_cast<float*>(keys + pad(kThreads * IPT));
  uint16_t* hist =
      reinterpret_cast<uint16_t*>(keys + pad(kThreads * IPT) * 2);
  uint16_t* rank = hist + kWarps * kDigits;
  uint8_t* verdict = reinterpret_cast<uint8_t*>(rank);   // after the sort
  __shared__ int digit_base[kDigits];
  __shared__ int digit_warp_sum[kDigits / 32];
  __shared__ double red_load[kWarps], red_w[kWarps];
  __shared__ int red_open[kWarps], red_in[kWarps];
  __shared__ Seg agg1[kWarps], agg2[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int slot0 = warp * 32 * IPT + lane;   // + 32 * r: round r's slot
  const uint32_t idx_mask = (1u << idx_bits) - 1u;

  // every node to the outputs (and a zero carry); the open nodes' load and
  // count
  double sum_load = 0.0;
  int n_open = 0;
#pragma unroll 8
  for (int n = tid; n < N; n += kThreads) {
    const float l = load[n];
    const int c = rem_cap[n];
    load_out[n] = l;
    rem_cap_out[n] = c;
    if constexpr (kChunked) carry[n] = NodeCarry{0, 0, 0.0, 0.0};
    if (c > 0) {
      sum_load += l;
      ++n_open;
    }
  }

  // a chunk's keys and costs, in registers, dealt to warps in index order;
  // the candidates' costs and the count in range
  uint32_t key[IPT];
  float kcost[IPT];
  auto load_chunk = [&](int base, int kc, double& sum_w, int& n_in) {
#pragma unroll
    for (int r = 0; r < IPT; ++r) {
      const int i = slot0 + 32 * r;
      key[r] = kUnused;
      kcost[r] = 0.0f;
      if (i < kc) {
        const bool c = cand[base + i] != 0;
        const int ch = choice[base + i];
        const bool in =
            c && static_cast<unsigned>(ch) < static_cast<unsigned>(N);
        const uint32_t node = in ? static_cast<uint32_t>(ch)
                                 : static_cast<uint32_t>(N);
        key[r] = (node << idx_bits) | static_cast<uint32_t>(i);
        const float w = c ? cost[base + i] : 0.0f;
        kcost[r] = in ? w : 0.0f;
        sum_w += static_cast<double>(w);
        n_in += in;
      }
    }
  };
  double sum_w = 0.0;
  int n_in = 0;
  load_chunk(0, min(chunk, K), sum_w, n_in);
  if constexpr (kChunked) {   // the later chunks' costs, for the level
    for (int i = chunk + tid; i < K; i += kThreads) {
      const bool c = cand[i] != 0;
      const int ch = choice[i];
      sum_w += c ? static_cast<double>(cost[i]) : 0.0;
      n_in += c && static_cast<unsigned>(ch) < static_cast<unsigned>(N);
    }
  }

  // block sums, warp by warp in a fixed order
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sum_load += __shfl_down_sync(kFull, sum_load, d);
    sum_w += __shfl_down_sync(kFull, sum_w, d);
    n_open += __shfl_down_sync(kFull, n_open, d);
    n_in += __shfl_down_sync(kFull, n_in, d);
  }
  if (lane == 0) {
    red_load[warp] = sum_load;
    red_w[warp] = sum_w;
    red_open[warp] = n_open;
    red_in[warp] = n_in;
  }
  __syncthreads();
  sum_load = 0.0;
  sum_w = 0.0;
  n_open = 0;
  n_in = 0;
  for (int q = 0; q < kWarps; ++q) {
    sum_load += red_load[q];
    sum_w += red_w[q];
    n_open += red_open[q];
    n_in += red_in[q];
  }

  if (n_in == 0) {   // nothing to rank: no bid is accepted
    for (int i = tid; i < K; i += kThreads) {
      accept_out[i] = 0;
      if (assigned_out) assigned_out[i] = assigned[i];
    }
    return;
  }
  const float level = __fdiv_rn(
      __fadd_rn(__double2float_rn(sum_load), __double2float_rn(sum_w)),
      static_cast<float>(n_open > 1 ? n_open : 1));

  const int end_bit = idx_bits + node_bits;
  uint16_t* my_hist = hist + warp * kDigits;
  for (int base = 0; base < K; base += chunk) {
    const int kc = min(chunk, K - base);
    if (base > 0) {
      // the previous chunk's reads of the keys and verdicts are done
      __syncthreads();
      double unused_w = 0.0;
      int unused_n = 0;
      load_chunk(base, kc, unused_w, unused_n);
    }

    // ---- the sort: by the node bits, 8 a pass, stable
    for (int bit = idx_bits; bit < end_bit; bit += kDigitBits) {
      const uint32_t dmask = (1u << min(kDigitBits, end_bit - bit)) - 1u;
      for (int j = tid; j < kWarps * kDigits / 2; j += kThreads) {
        reinterpret_cast<uint32_t*>(hist)[j] = 0;
      }
      __syncthreads();
      // per warp, round by round: each key's rank among the warp's keys of
      // its digit, and the count of each digit
#pragma unroll
      for (int r = 0; r < IPT; ++r) {
        const uint32_t d = (key[r] >> bit) & dmask;
        const uint32_t peers = peers_of(d);
        const int before = my_hist[d];
        rank[slot0 + 32 * r] =
            static_cast<uint16_t>(before + __popc(peers & lt_mask));
        __syncwarp();
        if ((peers & lt_mask) == 0) {
          my_hist[d] = static_cast<uint16_t>(before + __popc(peers));
        }
        __syncwarp();
      }
      __syncthreads();
      // per digit: its warps' exclusive offsets, then the digits' bases
      int total = 0;
      if (tid < kDigits) {
        for (int q = 0; q < kWarps; ++q) {
          const int c = hist[q * kDigits + tid];
          hist[q * kDigits + tid] = static_cast<uint16_t>(total);
          total += c;
        }
      }
      int incl = total;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (tid < kDigits && lane == 31) digit_warp_sum[warp] = incl;
      __syncthreads();
      if (tid < kDigits) {
        int base_d = incl - total;
        for (int q = 0; q < warp; ++q) base_d += digit_warp_sum[q];
        digit_base[tid] = base_d;
      }
      __syncthreads();
      // every key to its place: its digit's base, the digit's count in the
      // warps before, its rank in its own warp
#pragma unroll
      for (int r = 0; r < IPT; ++r) {
        const uint32_t d = (key[r] >> bit) & dmask;
        const int p = slot0 + 32 * r;
        const int to = pad(digit_base[d] + my_hist[d] + rank[p]);
        keys[to] = key[r];
        costs[to] = kcost[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < IPT; ++r) {
        key[r] = keys[pad(slot0 + 32 * r)];
        kcost[r] = costs[pad(slot0 + 32 * r)];
      }
    }

    // ---- the scans: thread t takes the sorted slots [t*IPT, t*IPT + IPT),
    // each thread's run first, then the carry of the runs before it
    const int q0 = tid * IPT;
    const uint32_t node_before =
        q0 > 0 && q0 <= kc ? keys[pad(q0 - 1)] >> idx_bits : kNoNode;
    uint32_t prev = node_before;
    Seg run = none();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int q = q0 + i;
      if (q < kc) {
        const uint32_t node = keys[pad(q)] >> idx_bits;
        run = combine(run, Seg{q == 0 || node != prev, 1, costs[pad(q)]});
        prev = node;
      }
    }
    // first scan, with the carry: rank and running cost within each node's
    // segment (after its earlier chunks'), and so the verdicts
    Seg c = block_carry(run, agg1, warp, lane);
    Seg c_start = none();
    if constexpr (kChunked) c_start = c;
    uint32_t accepted = 0;   // bit i: slot q0 + i
    Seg run2 = none();
    prev = node_before;
    uint32_t at = kNoNode;   // the node whose state is read
    float load_at = 0.0f;
    int cap_at = 0;
    int n_at = 0;        // its candidates in earlier chunks
    double s_at = 0.0;   // and their cost
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int q = q0 + i;
      if (q < kc) {
        const uint32_t k = keys[pad(q)];
        const uint32_t node = k >> idx_bits;
        const uint32_t idx = k & idx_mask;
        const bool in = node < static_cast<uint32_t>(N);
        const float w = costs[pad(q)];
        const bool head = q == 0 || node != prev;
        prev = node;
        double before = head ? 0.0 : c.s;
        c = combine(c, Seg{head, 1, w});
        bool acc = false;
        if (in) {
          if (node != at) {
            at = node;
            load_at = load[node];
            cap_at = rem_cap[node];
            if constexpr (kChunked) {
              n_at = carry[node].n;
              s_at = carry[node].s;
            }
          }
          int rank_q = c.n - 1;
          if constexpr (kChunked) {
            rank_q += n_at;
            before += s_at;
          }
          const bool fits =
              rank_q == 0 || __fadd_rn(__double2float_rn(before), w) <=
                                 __fsub_rn(level, load_at);
          acc = rank_q < cap_at && (is_final || fits);
        }
        verdict[idx] = acc;
        accepted |= static_cast<uint32_t>(acc) << i;
        run2 = combine(run2, Seg{head, acc, acc ? w : 0.0});
      }
    }
    // second scan: accepted cost and count per node; the segment's last
    // slot writes its node (and its carry)
    Seg c2 = block_carry(run2, agg2, warp, lane);
    // the verdicts and placements, in index order
#pragma unroll 4
    for (int i = tid; i < kc; i += kThreads) {
      const bool acc = verdict[i];
      accept_out[base + i] = acc;
      if (assigned_out) {
        assigned_out[base + i] = acc ? choice[base + i] : assigned[base + i];
      }
    }
    c = c_start;
    prev = node_before;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int q = q0 + i;
      if (q < kc) {
        const uint32_t node = keys[pad(q)] >> idx_bits;
        const float w = costs[pad(q)];
        const bool acc = (accepted >> i) & 1u;
        const bool head = q == 0 || node != prev;
        prev = node;
        c2 = combine(c2, Seg{head, acc, acc ? w : 0.0f});
        if constexpr (kChunked) c = combine(c, Seg{head, 1, w});
        const bool last =
            q == kc - 1 || (keys[pad(q + 1)] >> idx_bits) != node;
        if (last && node < static_cast<uint32_t>(N)) {
          int acc_n = c2.n;
          double acc_s = c2.s;
          if constexpr (kChunked) {
            const NodeCarry p = carry[node];
            acc_n += p.acc_n;
            acc_s += p.acc_s;
            carry[node] = NodeCarry{p.n + c.n, acc_n, p.s + c.s, acc_s};
          }
          load_out[node] = __fadd_rn(load[node], __double2float_rn(acc_s));
          rem_cap_out[node] = rem_cap[node] - acc_n;
        }
      }
    }
    if constexpr (!kChunked) break;   // one pass: K <= chunk
  }
}

template <int IPT, bool kChunked>
int launch(const void* cand, const void* choice, const void* cost,
           const void* load, const void* rem_cap, const void* assigned,
           void* accept_out, void* load_out, void* rem_cap_out,
           void* assigned_out, void* carry, int K, int N, int chunk,
           int idx_bits, int node_bits, int is_final, cudaStream_t stream) {
  static bool opted[64];   // per device: the shared-memory opt-in is set
  constexpr size_t smem = smem_bytes<IPT>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(waterfill_accept_kernel<IPT, kChunked>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  waterfill_accept_kernel<IPT, kChunked><<<1, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cand), static_cast<const int32_t*>(choice),
      static_cast<const float*>(cost), static_cast<const float*>(load),
      static_cast<const int32_t*>(rem_cap),
      static_cast<const int32_t*>(assigned),
      static_cast<uint8_t*>(accept_out), static_cast<float*>(load_out),
      static_cast<int32_t*>(rem_cap_out), static_cast<int32_t*>(assigned_out),
      static_cast<NodeCarry*>(carry), K, N, chunk, idx_bits, node_bits,
      is_final);
  return static_cast<int>(cudaGetLastError());
}

int bit_length(unsigned v) { return v ? 32 - __builtin_clz(v) : 0; }

}  // namespace

// One launch on `stream`.  `assigned` and `assigned_out` may both be null.
// One pass of the block takes up to 16384 bids, or 2^(32 - bit_length(N))
// where that is fewer (the 32-bit key's index bits); a larger bucket is
// taken in chunks of that size and needs `carry` (24 bytes a node,
// 8-aligned, overwritten), which may be null otherwise.  Takes K >= 0 and
// N >= 1; returns cudaErrorInvalidValue otherwise, else cudaGetLastError()
// (0 on success).
extern "C" int cronsun_waterfill_accept(
    const void* cand, const void* choice, const void* cost, const void* load,
    const void* rem_cap, const void* assigned, void* accept_out,
    void* load_out, void* rem_cap_out, void* assigned_out, void* carry, int K,
    int N, int is_final, void* stream) {
  if (K < 0 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int node_bits = bit_length(static_cast<unsigned>(N));
  const int chunk =
      32 - node_bits >= 14 ? kMaxChunk : 1 << (32 - node_bits);
  auto s = static_cast<cudaStream_t>(stream);
#define CRONSUN_WATERFILL_LAUNCH(IPT, CHUNKED, CHUNK, IDX_BITS)              \
  return launch<IPT, CHUNKED>(cand, choice, cost, load, rem_cap, assigned,   \
                              accept_out, load_out, rem_cap_out,             \
                              assigned_out, carry, K, N, CHUNK, IDX_BITS,    \
                              node_bits, is_final, s)
  if (K > chunk) {
    if (carry == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    CRONSUN_WATERFILL_LAUNCH(kMaxItems, true, chunk,
                             bit_length(static_cast<unsigned>(chunk - 1)));
  }
  const int idx_bits = K > 1 ? bit_length(static_cast<unsigned>(K - 1)) : 0;
  const int items = (K + kThreads - 1) / kThreads;
  if (items <= 1) CRONSUN_WATERFILL_LAUNCH(1, false, K, idx_bits);
  if (items <= 2) CRONSUN_WATERFILL_LAUNCH(2, false, K, idx_bits);
  if (items <= 4) CRONSUN_WATERFILL_LAUNCH(4, false, K, idx_bits);
  if (items <= 8) CRONSUN_WATERFILL_LAUNCH(8, false, K, idx_bits);
  CRONSUN_WATERFILL_LAUNCH(16, false, K, idx_bits);
#undef CRONSUN_WATERFILL_LAUNCH
}
