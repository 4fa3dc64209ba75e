// compact_groups: the live groups of a hash group table, optionally those
// that pass a HAVING predicate, written densely in slot order.
//
// Replaces two of the JAX package's jitted programs (datafusion_tpu/):
//   - physical/plan/device_aggregate.py:1279 _apply_post_filter (jit
//     :1359): the fused HAVING, evaluated over the group table with every
//     referenced output column finalised from its lanes;
//   - the compaction branches of :1017 _fetch_state (:1043-1079) and of
//     :1181 _execute_big (:1254-1272): live groups first, cut to their
//     count, so one device-to-host copy moves only them.
// With a list of slots (the output of group_topk.cu) it keeps the live
// ones among them in the list's order: the top-k emit of :1127 _emit_topk.
//
// Layout. In: the [L + 2][cap] table of hash_group_aggregate.cu (row 0
// keys, EMPTY = -1; row 1 row counts; rows 2.. lanes). Out: [L + 2][ng],
// the same rows for the ng groups kept.
//
// Design. Three launches, all on the caller's stream:
//   1. count: each block takes a tile of 2,048 slots, runs the keep test
//      (occupied, and the HAVING program through program.cuh with the
//      `GroupColumns` loader below) and writes its tile's count;
//   2. scan: one block turns the tile counts into exclusive offsets and
//      writes ng;
//   3. scatter: each block runs the keep test again and writes its kept
//      slots' rows at its offset, in slot order. So the output is the
//      same from run to run.
// The caller reads ng between 2 and 3 to size the output.
//
// Bounds. Each of the two passes reads the key row (8 bytes a slot) and,
// for occupied slots, the rows the HAVING reads: for Q18's subquery at
// SF10 that is 0.54 GB of keys over 2^26 slots plus 16 bytes for each of
// 15M groups, about 1.6 GB in all, 0.47 ms at 3.35 TB/s (NVIDIA H100 80GB
// HBM3, 700 W data sheet). The scatter writes only the survivors.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                 // slots per thread
constexpr int kTile = kThreads * kPer;  // slots per block (groupby.py)
constexpr int kScanThreads = 1024;

// finaliser kinds: datafusion_tpu_torch/device/groupby.py
enum { FIN_KEY = 0, FIN_COUNT = 1, FIN_SUM = 2, FIN_AVG = 3, FIN_MIN = 4,
       FIN_MAX = 5 };
constexpr int kFinWords = 6;

__device__ __forceinline__ double sum_value(int kind, i64 bits) {
  switch (kind) {
    case LANE_SUM_F64: return as_f(bits);
    case LANE_SUM_F32: return (double)__int_as_float((int)(bits & 0xffffffff));
    default: return (double)bits;
  }
}

// Column loads of a HAVING program: output column `idx` of group `slot`,
// finalised from the table as _apply_post_filter does
// (device_aggregate.py:1301-1352). Descriptor words per column:
//   FIN_KEY   (shift, bits, offset, is_bool, is_float)  ((k >> shift) &
//             mask) - 1 + offset (bool: != 0; float: as float64, a
//             date_part key), valid when that field is not 0
//   FIN_COUNT (count row)
//   FIN_SUM   (sum row, count row, lane kind)       valid when count > 0
//   FIN_AVG   (sum row, count row, lane kind)       s / c, float64
//   FIN_MIN/MAX (value row, count row, lane kind, nancnt row or -1):
//             NaN restored (min: all values NaN; max: any value NaN)
struct GroupColumns {
  static constexpr bool kFull = true;   // a HAVING may use every opcode
  const i64* fin;
  const i64* table;
  i64 cap;

  __device__ __forceinline__ i64 at(i64 r, i64 slot) const {
    return table[r * cap + slot];
  }

  __device__ bool operator()(i64 idx, i64 slot, i64* v) const {
    const i64* f = fin + kFinWords * idx;
    switch ((int)f[0]) {
      case FIN_KEY: {
        const i64 raw = (at(0, slot) >> f[1]) & ((1ll << f[2]) - 1);
        const i64 code = wadd(raw - 1, f[3]);
        *v = f[4] ? (i64)(code != 0) : f[5] ? as_i((double)code) : code;
        return raw != 0;
      }
      case FIN_COUNT:
        *v = at(f[1], slot);
        return true;
      case FIN_SUM: {
        const i64 s = at(f[1], slot);
        *v = f[3] == LANE_SUM_F32 ? as_i(sum_value(LANE_SUM_F32, s)) : s;
        return at(f[2], slot) > 0;
      }
      case FIN_AVG: {
        const i64 c = at(f[2], slot);
        const double s = sum_value((int)f[3], at(f[1], slot));
        *v = as_i(s / (double)(c > 0 ? c : 1));
        return c > 0;
      }
      default: {  // FIN_MIN, FIN_MAX
        const i64 c = at(f[2], slot);
        i64 x = at(f[1], slot);
        if (f[4] >= 0 && c > 0) {
          const i64 nn = at(f[4], slot);
          if (f[0] == FIN_MIN ? nn == c : nn > 0) x = as_i(NAN);
        }
        *v = x;
        return c > 0;
      }
    }
  }
};

struct Keep {
  const i64* meta;
  const i64* table;
  i64 cap;
  const i64* slots;   // null: every slot in order

  // keep entry j (slot j, or slots[j]); its slot goes to *slot
  __device__ bool operator()(i64 j, i64* slot) const {
    const i64 s = slots != nullptr ? slots[j] : j;
    *slot = s;
    if (s < 0 || table[s] == kEmpty) return false;
    if (meta[H_PRED] < 0) return true;
    const GroupColumns cols{meta + meta[H_OFF_COLS], table, cap};
    i64 x;
    const bool valid = run(meta, nullptr, (int)meta[H_PRED], s, cols, &x);
    return valid && x != 0;
  }
};

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
template <int NT>
__device__ i64 block_exclusive_scan(i64 v, i64* total) {
  __shared__ i64 warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  i64 x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < NT / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const i64 excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const i64* __restrict__ meta_g, int meta_len,
                     const i64* __restrict__ table, i64 cap,
                     const i64* __restrict__ slots, i64 n,
                     i64* __restrict__ counts) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const Keep keep{smem, table, cap, slots};
  const i64 base = (i64)blockIdx.x * kTile + (i64)threadIdx.x * kPer;
  i64 c = 0, s;
  for (int i = 0; i < kPer; ++i) {
    if (base + i < n && keep(base + i, &s)) ++c;
  }
  i64 total;
  block_exclusive_scan<kThreads>(c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// counts[0..nb) -> exclusive offsets in place; *ng = the sum
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(i64* __restrict__ counts, i64 nb, i64* __restrict__ ng) {
  const i64 per = (nb + kScanThreads - 1) / kScanThreads;
  const i64 lo = (i64)threadIdx.x * per;
  const i64 hi = lo + per < nb ? lo + per : nb;
  i64 sum = 0;
  for (i64 i = lo; i < hi; ++i) sum += counts[i];
  i64 total;
  i64 run_ = block_exclusive_scan<kScanThreads>(sum, &total);
  for (i64 i = lo; i < hi; ++i) {
    const i64 c = counts[i];
    counts[i] = run_;
    run_ += c;
  }
  if (threadIdx.x == 0) *ng = total;
}

__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const i64* __restrict__ meta_g, int meta_len,
                       const i64* __restrict__ table, i64 cap, int nrows,
                       const i64* __restrict__ slots, i64 n,
                       const i64* __restrict__ offsets, i64* __restrict__ out,
                       i64 ng) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const Keep keep{smem, table, cap, slots};
  const i64 base = (i64)blockIdx.x * kTile + (i64)threadIdx.x * kPer;
  i64 kept[kPer];
  int c = 0;
  for (int i = 0; i < kPer; ++i) {
    i64 s;
    if (base + i < n && keep(base + i, &s)) kept[c++] = s;
  }
  i64 total;
  i64 pos = offsets[blockIdx.x] + block_exclusive_scan<kThreads>(c, &total);
  for (int i = 0; i < c; ++i, ++pos) {
    for (int r = 0; r < nrows; ++r) out[r * ng + pos] = table[r * cap + kept[i]];
  }
}

}  // namespace

// meta: device int64 descriptor (groupby.py; H_PRED < 0 when there is no
// HAVING); table: device int64 [nrows][cap]; slots: device int64 [n]
// slot list, or null to scan all n = cap slots; counts: device int64
// scratch of ceil(n / 2048) words (at least 1); ng: device int64 word.
// Launches the count and scan passes on `stream`; returns
// cudaGetLastError().
extern "C" int dft_compact_count(const void* meta, int meta_len,
                                 const void* table, long long cap,
                                 const void* slots, long long n,
                                 void* counts, void* ng, void* stream) {
  long long nb = (n + kTile - 1) / kTile;
  if (nb < 1) nb = 1;
  cudaStream_t st = (cudaStream_t)stream;
  compact_count_kernel<<<(unsigned)nb, kThreads, (size_t)meta_len * 8, st>>>(
      (const i64*)meta, meta_len, (const i64*)table, cap, (const i64*)slots,
      n, (i64*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>((i64*)counts, nb, (i64*)ng);
  return (int)cudaGetLastError();
}

// The scatter pass: out is device int64 [nrows][ng], offsets the counts
// scratch after dft_compact_count, ng the value it wrote.
extern "C" int dft_compact_scatter(const void* meta, int meta_len,
                                   const void* table, long long cap,
                                   int nrows, const void* slots, long long n,
                                   const void* offsets, void* out,
                                   long long ng, void* stream) {
  long long nb = (n + kTile - 1) / kTile;
  if (nb < 1) nb = 1;
  compact_scatter_kernel<<<(unsigned)nb, kThreads, (size_t)meta_len * 8,
                           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)table, cap, nrows,
      (const i64*)slots, n, (const i64*)offsets, (i64*)out, ng);
  return (int)cudaGetLastError();
}
