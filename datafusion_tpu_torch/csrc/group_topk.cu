// group_topk: the k best live groups of a hash group table by one int64
// lane, ascending or descending (k <= 65,536).
//
// Replaces the selection of the JAX package's top-k emit,
// datafusion_tpu/physical/plan/device_aggregate.py:1127 _emit_topk (jit
// :1157): `lax.top_k` over the order lane with empty slots masked to
// INT64_MIN. compact_groups.cu then gathers the chosen slots' rows.
//
// Design: compact, then select, all on the device in a fixed count of
// launches, so the host never waits. Each value maps to an unsigned order
// key u (the sign bit flipped; all bits flipped for ascending), so the k
// best groups are the k largest u.
//   1. compact, one pass over the table: each live slot appends (u, slot)
//      to a dense candidate list, one atomic on the count a tile of 2048
//      slots (an atomic a warp would put millions on one address at 2^28
//      slots), and the pass reduces the AND and OR of every u, whose
//      difference gives the highest byte in which the live keys differ;
//   2. select, kRounds launches of one kernel, byte 7 down to byte 0: a
//      round above the highest varying byte returns at once; the others
//      histogram digit `byte` of the candidates whose higher bytes equal
//      the prefix chosen so far (a shared-memory histogram a block, one
//      shared atomic a distinct digit of a warp, merged with global
//      atomics), and the last block to finish picks the bin that holds the
//      k-th largest u with a block-wide scan and how many of it are still
//      needed. After byte 0 the prefix is the k-th value T itself;
//   3. gather, over the candidates: every u > T and the first `need` with
//      u == T, in no particular order. With k or fewer live groups the
//      rounds return at once and the gather takes them all.
// The candidate list holds at most `cand_cap` entries (the wrapper's
// TOPK_CANDIDATES, 12 bytes each). With more live groups than that the
// compaction still counts them and reduces their keys, and the rounds and
// the gather read the table itself instead, each a pass over the key row
// and the live lanes: the same launches, more bytes.
// Which of the groups tied at T are kept may differ from lax.top_k's
// choice; both are valid SQL, since the SortExec above orders the k rows
// again. The output is a [k] list of slots, -1 where there are fewer
// than k.
//
// Bounds. The table is read once: the key row (8 bytes a slot) and the
// order lane of the occupied slots, a 32-byte sector each where groups are
// sparse. The candidates (12 bytes a live group) are written once and read
// by each round that runs and by the gather; ClickBench Q16's 1.9M groups
// (23 MB) stay in the 50 MB L2. ClickBench Q17 at 99,997,497 rows (cap
// 2^28, 4.1M groups) must read its 2.1 GB key row and about 0.13 GB of
// lane sectors: 0.68 ms at 3.35 TB/s (NVIDIA H100 80GB HBM3, 700 W data
// sheet).

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRounds = 8;     // one a byte, from the top
constexpr int kUnroll = 8;     // slots a thread loads before it appends

// state words, zeroed by the caller: the prefix chosen so far, the
// candidates known to be above it, the candidate count, the OR of every
// ~u (the complement of their AND) and of every u, the gather's cursors
// and the rounds' ticket
enum {
  S_PREFIX, S_ABOVE, S_COUNT, S_NAND, S_OR, S_GT, S_EQ, S_TICKET, S_WORDS = 8
};

__device__ __forceinline__ u64 order_key(i64 v, int asc) {
  const u64 u = (u64)v ^ 0x8000000000000000ull;
  return asc ? ~u : u;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// the highest byte in which the live keys differ; -1 when all are equal
__device__ __forceinline__ int top_byte(const i64* state) {
  const u64 diff = ~(u64)state[S_NAND] ^ (u64)state[S_OR];
  return diff ? (63 - __clzll((long long)diff)) >> 3 : -1;
}

// Block b takes tiles of kThreads * kUnroll slots, slot tile + r *
// kThreads + t for thread t; one atomic a tile reserves the block's
// candidates, and each warp writes its live slots in slot order. The
// next tile's keys load while this one's atomic is in flight.
__global__ void __launch_bounds__(kThreads)
topk_compact_kernel(const i64* __restrict__ table, i64 cap, int lane_row,
                    int asc, i64* __restrict__ state, u64 cand_cap,
                    u64* __restrict__ cand_u, unsigned* __restrict__ cand_s) {
  __shared__ unsigned warp_live[kWarps];
  __shared__ u64 tile_at;
  __shared__ u64 sh_and[kWarps], sh_or[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64* order = table + (i64)lane_row * cap;
  const unsigned below = lanes_below();
  u64 all = ~0ull, any = 0;
  constexpr i64 kTileSlots = (i64)kThreads * kUnroll;
  const i64 step = (i64)gridDim.x * kTileSlots;
  i64 next[kUnroll];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    const i64 s = (i64)blockIdx.x * kTileSlots + r * kThreads + threadIdx.x;
    next[r] = s < cap ? table[s] : kEmpty;
  }
  for (i64 tile = (i64)blockIdx.x * kTileSlots; tile < cap; tile += step) {
    i64 key[kUnroll];
    unsigned live[kUnroll];
    unsigned count = 0;
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      key[r] = next[r];
      const i64 s = tile + step + r * kThreads + threadIdx.x;
      next[r] = s < cap ? table[s] : kEmpty;
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      live[r] = __ballot_sync(0xffffffffu, key[r] != kEmpty);
      count += __popc(live[r]);
    }
    if (lane == 0) warp_live[warp] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned total = 0;
      for (int w = 0; w < kWarps; ++w) total += warp_live[w];
      tile_at = total ? atomicAdd((u64*)&state[S_COUNT], (u64)total) : 0;
    }
    __syncthreads();
    u64 at = tile_at;
    for (int w = 0; w < warp; ++w) at += warp_live[w];
    __syncthreads();   // warp_live and tile_at are reused by the next tile
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (key[r] != kEmpty) {
        const i64 s = tile + r * kThreads + threadIdx.x;
        const u64 u = order_key(order[s], asc);
        all &= u;
        any |= u;
        const u64 p = at + __popc(live[r] & below);
        if (p < cand_cap) {
          cand_u[p] = u;
          cand_s[p] = (unsigned)s;
        }
      }
      at += __popc(live[r]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    all &= __shfl_xor_sync(0xffffffffu, all, o);
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
  if (lane == 0) {
    sh_and[warp] = all;
    sh_or[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      all &= sh_and[w];
      any |= sh_or[w];
    }
    if (all != ~0ull) atomicOr((u64*)&state[S_NAND], ~all);
    if (any != 0) atomicOr((u64*)&state[S_OR], any);
  }
}

// Candidate i: its order key, and whether it is one. From the list, or,
// when the list overflowed, slot i of the table (live or not).
struct Candidates {
  const i64* table;
  i64 cap;
  int lane_row, asc;
  u64 cand_cap;
  const u64* cand_u;

  __device__ __forceinline__ bool spilled(i64 m) const {
    return (u64)m > cand_cap;
  }
  __device__ __forceinline__ i64 count(i64 m) const {
    return spilled(m) ? cap : m;
  }
  __device__ __forceinline__ bool at(i64 i, bool spill, u64& u) const {
    if (!spill) {
      u = cand_u[i];
      return true;
    }
    if (table[i] == kEmpty) return false;
    u = order_key(table[(i64)lane_row * cap + i], asc);
    return true;
  }
};

// One round of the select: digit `byte` of the candidates under the prefix
__global__ void __launch_bounds__(kThreads)
topk_round_kernel(int byte, i64 k, Candidates c, i64* __restrict__ state,
                  u64* __restrict__ hist) {
  const i64 m = state[S_COUNT];
  const int top = top_byte(state);
  if (m <= k || byte > top) return;   // uniform over the grid
  __shared__ unsigned sh[kBins];
  __shared__ i64 warp_sum[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sh[threadIdx.x] = 0;
  __syncthreads();
  const int shift = 8 * byte;
  const u64 hi = byte == 7 ? 0ull : ~0ull << (shift + 8);
  // the bytes above `top` are the same in every candidate
  const u64 prefix = byte == top ? (~(u64)state[S_NAND] & hi)
                                 : (u64)state[S_PREFIX];
  const i64 krem = k - state[S_ABOVE];
  const bool spill = c.spilled(m);
  const i64 n = c.count(m);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 b = (i64)blockIdx.x * blockDim.x + warp * 32; b < n;
       b += stride) {
    const i64 i = b + lane;
    u64 u = 0;
    bool ok = i < n && c.at(i, spill, u);
    unsigned d = kBins;
    if (ok) {
      ok = ((u ^ prefix) & hi) == 0;
      d = ok ? (unsigned)(u >> shift) & 255u : kBins;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok && (__ffs(peers) - 1) == lane) {
      atomicAdd(&sh[d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  if (sh[threadIdx.x]) atomicAdd(&hist[threadIdx.x], (u64)sh[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd((u64*)&state[S_TICKET], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: thread t holds bin 255 - t; `above` = candidates in
  // the bins above it
  const int bin = kBins - 1 - threadIdx.x;
  const i64 h = (i64)*(volatile u64*)&hist[bin];
  i64 x = h;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  i64 above = x - h;
  for (int w = 0; w < warp; ++w) above += warp_sum[w];
  if (above < krem && above + h >= krem) {
    state[S_PREFIX] = (i64)(prefix | ((u64)bin << shift));
    state[S_ABOVE] += above;
  }
  hist[bin] = 0;
  if (threadIdx.x == 0) state[S_TICKET] = 0;
}

// out[0..k): every u > T, then the first `need` with u == T; or, with k
// or fewer candidates, every candidate and -1 past them
__global__ void __launch_bounds__(kThreads)
topk_gather_kernel(i64 k, Candidates c, const unsigned* __restrict__ cand_s,
                   i64* __restrict__ state, i64* __restrict__ out) {
  const i64 m = state[S_COUNT];
  const u64 t = top_byte(state) < 0 ? ~(u64)state[S_NAND]
                                    : (u64)state[S_PREFIX];
  const i64 need = k - state[S_ABOVE];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 first = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (m <= k) {   // the wrapper keeps cand_cap >= min(cap, k)
    for (i64 i = first; i < k; i += stride) {
      out[i] = i < m ? (i64)cand_s[i] : -1;
    }
    return;
  }
  const bool spill = c.spilled(m);
  const i64 n = c.count(m);
  for (i64 i = first; i < n; i += stride) {
    u64 u;
    if (!c.at(i, spill, u)) continue;
    const i64 slot = spill ? i : (i64)cand_s[i];
    if (u > t) {
      out[atomicAdd((u64*)&state[S_GT], 1ull)] = slot;
    } else if (u == t) {
      const i64 e = (i64)atomicAdd((u64*)&state[S_EQ], 1ull);
      if (e < need) out[k - need + e] = slot;
    }
  }
}

}  // namespace

// table: device int64 [rows][cap] (row 0 keys, EMPTY = -1; cap <= 2^32);
// lane_row: the row of the order lane; state: device int64 [8] of zeros;
// hist: device int64 [256] of zeros; cand_u, cand_s: device scratch of
// cand_cap uint64 and cand_cap uint32, min(cap, k) <= cand_cap <= cap;
// out: device int64 [k]. Launches the compaction,
// kRounds select rounds and the gather on `stream` (group_topk's
// TOPK_LAUNCHES); returns cudaGetLastError().
extern "C" int dft_group_topk(const void* table, long long cap, int lane_row,
                              int asc, long long k, void* state, void* hist,
                              long long cand_cap, void* cand_u, void* cand_s,
                              void* out, void* stream) {
  const unsigned blocks = grid_blocks(cap, kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  // the compaction loops over its tiles: one wave of resident blocks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_compact_kernel,
                                                kThreads, 0);
  const i64 wave = (i64)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  const unsigned compact_blocks = (unsigned)(wave < blocks ? wave : blocks);
  topk_compact_kernel<<<compact_blocks, kThreads, 0, st>>>(
      (const i64*)table, cap, lane_row, asc, (i64*)state, (u64)cand_cap,
      (u64*)cand_u, (unsigned*)cand_s);
  const Candidates c{(const i64*)table, cap, lane_row, asc, (u64)cand_cap,
                     (const u64*)cand_u};
  for (int byte = kRounds - 1; byte >= 0; --byte) {
    topk_round_kernel<<<blocks, kThreads, 0, st>>>(byte, k, c, (i64*)state,
                                                   (u64*)hist);
  }
  topk_gather_kernel<<<blocks, kThreads, 0, st>>>(
      k, c, (const unsigned*)cand_s, (i64*)state, (i64*)out);
  return (int)cudaGetLastError();
}
