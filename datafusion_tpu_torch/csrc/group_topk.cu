// group_topk: the k best live groups of a hash group table by one int64
// lane, ascending or descending (k <= 65,536).
//
// Replaces the selection of the JAX package's top-k emit,
// datafusion_tpu/physical/plan/device_aggregate.py:1127 _emit_topk (jit
// :1157): `lax.top_k` over the order lane with empty slots masked to
// INT64_MIN. compact_groups.cu then gathers the chosen slots' rows.
//
// Design: a radix select in eight passes of 8 bits, all on the device, so
// the host never waits between passes. Each value maps to an unsigned
// order key u (the sign bit flipped; all bits flipped for ascending), so
// the k best groups are the k largest u. Pass p builds a 256-bin histogram
// of digit p over the live slots whose higher digits equal the prefix
// chosen so far (shared-memory histogram per block, merged with global
// atomics), and one thread picks the bin that holds the k-th largest u and
// how many of it are still needed. After the eighth pass the prefix is
// the k-th value T itself: the gather takes every slot with u > T and the
// first `need` slots with u == T, in no particular order. Which of the
// groups tied at T are kept may differ from lax.top_k's choice; both are
// valid SQL, since the SortExec above orders the k rows again. With k or
// fewer live groups the first pass notices and the gather takes them all.
// The output is a [k] list of slots, -1 where there are fewer than k.
//
// Bounds. Each of the 9 passes reads the key row (8 bytes a slot) and the
// order lane of the occupied slots. For ClickBench Q17 at 99,997,497 rows
// (cap 2^28, 4.1M groups) that is about 19.5 GB, 5.8 ms at 3.35 TB/s
// (NVIDIA H100 80GB HBM3, 700 W data sheet).

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr i64 kEmpty = -1;

// state words (groupby.py fills S_KREM with k, the rest with 0)
enum { S_PREFIX, S_KREM, S_ALL, S_GT, S_EQ, S_WORDS = 8 };

__device__ __forceinline__ u64 order_key(i64 v, int asc) {
  const u64 u = (u64)v ^ 0x8000000000000000ull;
  return asc ? ~u : u;
}

__global__ void __launch_bounds__(kThreads)
topk_hist_kernel(const i64* __restrict__ table, i64 cap, int lane_row,
                 int asc, int pass, const i64* __restrict__ state,
                 u64* __restrict__ hist) {
  if (state[S_ALL]) return;
  __shared__ unsigned int sh[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int shift = 56 - 8 * pass;
  const u64 prefix = (u64)state[S_PREFIX];
  const u64 hi = pass == 0 ? 0ull : (~0ull << (shift + 8));
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < cap;
       s += stride) {
    if (table[s] == kEmpty) continue;
    const u64 u = order_key(table[(i64)lane_row * cap + s], asc);
    if (((u ^ prefix) & hi) == 0) atomicAdd(&sh[(u >> shift) & 0xff], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    if (sh[b]) atomicAdd(&hist[b], (u64)sh[b]);
  }
}

// one thread: choose digit `pass` of the k-th largest key; clear hist
__global__ void topk_select_kernel(int pass, i64* __restrict__ state,
                                   u64* __restrict__ hist) {
  if (state[S_ALL]) return;
  i64 krem = state[S_KREM];
  if (pass == 0) {
    i64 total = 0;
    for (int b = 0; b < kBins; ++b) total += (i64)hist[b];
    if (total <= krem) {   // k or fewer live groups: take them all
      state[S_ALL] = 1;
      for (int b = 0; b < kBins; ++b) hist[b] = 0;
      return;
    }
  }
  int digit = 0;
  for (int b = kBins - 1; b >= 0; --b) {
    const i64 h = (i64)hist[b];
    if (h >= krem) {
      digit = b;
      break;
    }
    krem -= h;
  }
  state[S_PREFIX] = (i64)((u64)state[S_PREFIX] |
                          ((u64)digit << (56 - 8 * pass)));
  state[S_KREM] = krem;
  for (int b = 0; b < kBins; ++b) hist[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
topk_gather_kernel(const i64* __restrict__ table, i64 cap, int lane_row,
                   int asc, i64 k, i64* __restrict__ state,
                   i64* __restrict__ out) {
  const bool all = state[S_ALL] != 0;
  const u64 t = (u64)state[S_PREFIX];
  const i64 need = state[S_KREM];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < cap;
       s += stride) {
    if (table[s] == kEmpty) continue;
    if (all) {
      out[atomicAdd((u64*)&state[S_GT], 1ull)] = s;
      continue;
    }
    const u64 u = order_key(table[(i64)lane_row * cap + s], asc);
    if (u > t) {
      out[atomicAdd((u64*)&state[S_GT], 1ull)] = s;
    } else if (u == t) {
      const i64 e = (i64)atomicAdd((u64*)&state[S_EQ], 1ull);
      if (e < need) out[k - need + e] = s;
    }
  }
}

}  // namespace

// table: device int64 [rows][cap] (row 0 keys, EMPTY = -1); lane_row: the
// row of the order lane; state: device int64 [8], S_KREM = k, others 0;
// hist: device int64 [256] of zeros; out: device int64 [k] of -1.
// Launches every pass on `stream`; returns cudaGetLastError().
extern "C" int dft_group_topk(const void* table, long long cap, int lane_row,
                              int asc, long long k, void* state, void* hist,
                              void* out, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (cap + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = (cudaStream_t)stream;
  for (int pass = 0; pass < 8; ++pass) {
    topk_hist_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const i64*)table, cap, lane_row, asc, pass, (const i64*)state,
        (u64*)hist);
    topk_select_kernel<<<1, 1, 0, st>>>(pass, (i64*)state, (u64*)hist);
  }
  topk_gather_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const i64*)table, cap, lane_row, asc, k, (i64*)state, (i64*)out);
  return (int)cudaGetLastError();
}
