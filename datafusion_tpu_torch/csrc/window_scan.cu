// window_scan: one window function over rows already sorted by partition
// and order words, with its results scattered back to the rows' original
// order.
//
// Replaces the segmentation, scans and inverse permutation of the JAX
// package's fused window program, _build_step
// (datafusion_tpu/device/window.py:122, jit :86, driven by
// device_window_eval :54). Its first step, the sort that carries the words
// and the value lanes into sorted order, is radix_sort.cu and
// gather_lanes.cu here. The formulas are _build_step's: row_number, rank,
// dense_rank, percent_rank, cume_dist, ntile, lag/lead with an optional
// default, and sum/count frame aggregates (int64 and float64 sums, valid
// counts) between partition, current-row, peer-group and ROWS-offset
// bounds, each a difference of prefix sums.
//
// Design, five launches on one stream:
//   1. flags: a row starts a partition when a partition word differs from
//      the row before, and a peer group when any word does;
//   2-4. a forward scan of (partition start, peer start, sum, count): the
//      starts are max-scans of (flag ? row : 0), the sum and count plain
//      prefix sums (the count of valid values, or of peer starts for
//      dense_rank). Blocks run in no order, so it is three launches: a
//      reduce of each tile of 2,048 rows, one block's exclusive scan of
//      the tile totals, and each tile's scan from its tile's offset. The
//      last row of each partition and of each peer group writes its index
//      at the segment's start, so a row finds its segment's end through
//      its start: one store a segment instead of a reverse scan;
//   5. eval: each row's result by _build_step's formula, written at
//      out[perm[i]]. The scatter replaces the JAX program's second sort.
// There is no padding: sizes are exact, so no row outside the input can
// join a segment or a sum.
//
// Bounds. The work must read the sorted words and lanes once, the
// permutation once, and write each output once: for query W1's rank at
// TPC-H SF10 (60M rows, two uint8 and two uint64 words) that is 26 B a row
// in and 8 B out, 2.0 GB: 0.61 ms at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 (700 W data sheet). The design writes and reads back five int64
// arrays a row (starts, sums, counts) and the flags, about 90 B a row
// more: the price of three simple launches for each cross-block scan.

#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // rows a thread
constexpr int kTile = kThreads * kPer;    // rows a block (device/window.py)
constexpr int kTopThreads = 1024;
constexpr int kMaxWords = 32;

enum { F_PART = 1, F_PEER = 2 };          // row flags

// spec words and codes: datafusion_tpu_torch/device/window.py
enum { S_KIND, S_ARG, S_AGG, S_LO_KIND, S_LO_OFF, S_HI_KIND, S_HI_OFF,
       kSpecWords };
enum { K_ROW_NUMBER, K_RANK, K_DENSE_RANK, K_PERCENT_RANK, K_CUME_DIST,
       K_NTILE, K_SHIFT, K_AGG };
enum { A_SUM_I, A_SUM_F, A_CNT };
enum { B_PART, B_CUR, B_PEER, B_ROWS };
enum { SUM_NONE, SUM_I64, SUM_F64 };      // what the scan sums
enum { CNT_NONE, CNT_VALID, CNT_PEER };   // what the scan counts

__device__ __forceinline__ double as_f(i64 b) {
  return __longlong_as_double(b);
}
__device__ __forceinline__ i64 as_i(double f) {
  return __double_as_longlong(f);
}
__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}

// ---- 1. flags ---------------------------------------------------------------

struct Words {
  const void* p[kMaxWords];
  int width[kMaxWords];
  int n_words;
  int n_part;
};

__device__ __forceinline__ u64 word_at(const Words& w, int k, i64 i) {
  return w.width[k] == 8 ? ((const u64*)w.p[k])[i]
                         : (u64)((const uint8_t*)w.p[k])[i];
}

__global__ void __launch_bounds__(kThreads)
flags_kernel(const Words w, i64 n, uint8_t* __restrict__ flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool part = i == 0, peer = i == 0;
    if (i > 0) {
      for (int k = 0; k < w.n_part; ++k) {
        part |= word_at(w, k, i) != word_at(w, k, i - 1);
      }
      peer = part;
      for (int k = w.n_part; k < w.n_words; ++k) {
        peer |= word_at(w, k, i) != word_at(w, k, i - 1);
      }
    }
    flags[i] = (uint8_t)((part ? F_PART : 0) | (peer ? F_PEER : 0));
  }
}

// ---- 2-4. the forward scan -------------------------------------------------

struct Carry {
  i64 ps, qs;   // partition start, peer start: max
  i64 s;        // sum: int64, or float64 bits
  i64 c;        // count
};

struct ScanIn {
  const uint8_t* flags;
  i64 n;
  const i64* val;       // sorted value lane (int64, or float64 bits)
  const uint8_t* valid; // its validity, or null: all valid
  int sum_mode;
  int cnt_mode;
};

struct ScanOut {
  i64* part_start;
  i64* peer_start;
  i64* sum;             // inclusive prefix sums, or null
  i64* cnt;             // inclusive prefix counts, or null
  i64* part_end_at;     // [partition start] = its last row
  i64* peer_end_at;     // [peer start] = its last row
};

__device__ __forceinline__ Carry identity() { return Carry{0, 0, 0, 0}; }

// a then b (a holds the earlier rows)
__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b,
                                         int sum_mode) {
  Carry r;
  r.ps = a.ps > b.ps ? a.ps : b.ps;
  r.qs = a.qs > b.qs ? a.qs : b.qs;
  r.s = sum_mode == SUM_F64 ? as_i(as_f(a.s) + as_f(b.s)) : wadd(a.s, b.s);
  r.c = a.c + b.c;
  return r;
}

__device__ __forceinline__ Carry row_value(const ScanIn& in, i64 i) {
  const uint8_t f = in.flags[i];
  const bool ok = in.valid == nullptr || in.valid[i];
  Carry v;
  v.ps = (f & F_PART) ? i : 0;
  v.qs = (f & F_PEER) ? i : 0;
  v.s = in.sum_mode != SUM_NONE && ok ? in.val[i] : 0;   // 0 = +0.0 too
  v.c = in.cnt_mode == CNT_VALID ? (i64)ok
        : in.cnt_mode == CNT_PEER ? (i64)((f & F_PEER) != 0) : 0;
  return v;
}

__device__ __forceinline__ Carry shfl_up(const Carry& x, int o) {
  Carry y;
  y.ps = __shfl_up_sync(0xffffffffu, x.ps, o);
  y.qs = __shfl_up_sync(0xffffffffu, x.qs, o);
  y.s = __shfl_up_sync(0xffffffffu, x.s, o);
  y.c = __shfl_up_sync(0xffffffffu, x.c, o);
  return y;
}

// Exclusive scan of v over the block; *total gets the block's whole.
// Every thread of the block must call it.
template <int NT>
__device__ Carry block_exclusive(const Carry& v, Carry* total, int mode) {
  __shared__ Carry warp_tot[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Carry x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const Carry y = shfl_up(x, o);
    if (lane >= o) x = combine(y, x, mode);
  }
  const Carry before = shfl_up(x, 1);    // this lane's exclusive in the warp
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Carry w = lane < NT / 32 ? warp_tot[lane] : identity();
    for (int o = 1; o < 32; o <<= 1) {
      const Carry y = shfl_up(w, o);
      if (lane >= o) w = combine(y, w, mode);
    }
    if (lane < NT / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  Carry excl = warp > 0 ? warp_tot[warp - 1] : identity();
  if (lane > 0) excl = combine(excl, before, mode);
  *total = warp_tot[NT / 32 - 1];
  __syncthreads();   // warp_tot is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const ScanIn in, Carry* __restrict__ tile_tot) {
  const i64 base = (i64)blockIdx.x * kTile + (i64)threadIdx.x * kPer;
  Carry acc = identity();
  for (int k = 0; k < kPer; ++k) {
    if (base + k < in.n) acc = combine(acc, row_value(in, base + k),
                                       in.sum_mode);
  }
  Carry total;
  block_exclusive<kThreads>(acc, &total, in.sum_mode);
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = total;
}

// tile_tot[0..nt) -> exclusive prefixes in place (one block)
__global__ void __launch_bounds__(kTopThreads)
scan_top_kernel(Carry* __restrict__ tile_tot, i64 nt, int mode) {
  const i64 per = (nt + kTopThreads - 1) / kTopThreads;
  const i64 lo = (i64)threadIdx.x * per;
  const i64 hi = lo + per < nt ? lo + per : nt;
  Carry s = identity();
  for (i64 t = lo; t < hi; ++t) s = combine(s, tile_tot[t], mode);
  Carry total;
  Carry run = block_exclusive<kTopThreads>(s, &total, mode);
  for (i64 t = lo; t < hi; ++t) {
    const Carry c = tile_tot[t];
    tile_tot[t] = run;
    run = combine(run, c, mode);
  }
}

__global__ void __launch_bounds__(kThreads)
scan_apply_kernel(const ScanIn in, const Carry* __restrict__ tile_tot,
                  const ScanOut out) {
  const i64 base = (i64)blockIdx.x * kTile + (i64)threadIdx.x * kPer;
  const int mode = in.sum_mode;
  Carry acc = identity();
  for (int k = 0; k < kPer; ++k) {
    if (base + k < in.n) acc = combine(acc, row_value(in, base + k), mode);
  }
  Carry total;
  const Carry excl = block_exclusive<kThreads>(acc, &total, mode);
  Carry run = combine(tile_tot[blockIdx.x], excl, mode);
  for (int k = 0; k < kPer; ++k) {
    const i64 i = base + k;
    if (i >= in.n) break;
    run = combine(run, row_value(in, i), mode);    // inclusive at i
    out.part_start[i] = run.ps;
    out.peer_start[i] = run.qs;
    if (out.sum != nullptr) out.sum[i] = run.s;
    if (out.cnt != nullptr) out.cnt[i] = run.c;
    // the last row of a segment: the next row starts one, or there is none
    const uint8_t next = i + 1 < in.n ? in.flags[i + 1] : (F_PART | F_PEER);
    if (next & F_PART) out.part_end_at[run.ps] = i;
    if (next & F_PEER) out.peer_end_at[run.qs] = i;
  }
}

// ---- 5. eval ----------------------------------------------------------------

struct EvalIn {
  const i64* perm;
  i64 n;
  const i64* part_start;
  const i64* part_end_at;
  const i64* peer_start;
  const i64* peer_end_at;
  const i64* sum;
  const i64* cnt;
  const void* val;        // shift: the sorted value lane, `width` bytes
  const uint8_t* valid;   // and its validity (null: all valid)
  const void* dflt;       // the sorted default lane, or null
  const uint8_t* dvalid;  // and its validity (null: all valid)
  int width;
  i64 spec[kSpecWords];
  void* out0;             // data (ranks, ntile, shift) or sum
  void* out1;             // shift: validity (uint8); agg: count
};

__device__ __forceinline__ void copy_value(void* dst, i64 d, const void* src,
                                           i64 s, int width) {
  switch (width) {
    case 1: ((uint8_t*)dst)[d] = ((const uint8_t*)src)[s]; break;
    case 2: ((uint16_t*)dst)[d] = ((const uint16_t*)src)[s]; break;
    case 4: ((uint32_t*)dst)[d] = ((const uint32_t*)src)[s]; break;
    default: ((u64*)dst)[d] = ((const u64*)src)[s]; break;
  }
}

// a frame bound in sorted rows (window.py: _build_step's `bound`)
__device__ __forceinline__ i64 frame_bound(const EvalIn& in, int kind,
                                           i64 off, bool lo, i64 i, i64 ps,
                                           i64 pe) {
  switch (kind) {
    case B_PART: return lo ? ps : pe;
    case B_CUR: return i;
    case B_PEER: {
      const i64 qs = in.peer_start[i];
      return lo ? qs : in.peer_end_at[qs];
    }
    default: return i + off;   // B_ROWS
  }
}

__global__ void __launch_bounds__(kThreads) eval_kernel(const EvalIn in) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const int kind = (int)in.spec[S_KIND];
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < in.n;
       i += stride) {
    const i64 ps = in.part_start[i];
    const i64 pe = in.part_end_at[ps];
    const i64 row = i - ps, len = pe - ps + 1;
    const i64 dst = in.perm[i];
    i64* out = (i64*)in.out0;
    switch (kind) {
      case K_ROW_NUMBER: out[dst] = row + 1; break;
      case K_RANK: out[dst] = in.peer_start[i] - ps + 1; break;
      case K_DENSE_RANK: out[dst] = in.cnt[i] - in.cnt[ps] + 1; break;
      case K_PERCENT_RANK: {
        const i64 rank = in.peer_start[i] - ps + 1;
        const double denom = (double)(len - 1 > 1 ? len - 1 : 1);
        out[dst] = as_i((double)(rank - 1) / denom);
        break;
      }
      case K_CUME_DIST: {
        const i64 qe = in.peer_end_at[in.peer_start[i]];
        out[dst] = as_i((double)(qe - ps + 1) / (double)len);
        break;
      }
      case K_NTILE: {
        const i64 k = in.spec[S_ARG];
        const i64 t = row * k / (len > 1 ? len : 1) + 1;
        out[dst] = t < k ? t : k;
        break;
      }
      case K_SHIFT: {
        const i64 src = i + in.spec[S_ARG];
        const bool in_part = src >= ps && src <= pe;
        const i64 safe = src < 0 ? 0 : (src > in.n - 1 ? in.n - 1 : src);
        bool v = in_part && (in.valid == nullptr || in.valid[safe]);
        if (in.dflt != nullptr && !in_part) {
          copy_value(in.out0, dst, in.dflt, i, in.width);
          v = in.dvalid == nullptr || in.dvalid[i];
        } else {
          copy_value(in.out0, dst, in.val, safe, in.width);
        }
        ((uint8_t*)in.out1)[dst] = (uint8_t)v;
        break;
      }
      default: {   // K_AGG
        i64 lo = frame_bound(in, (int)in.spec[S_LO_KIND], in.spec[S_LO_OFF],
                             true, i, ps, pe);
        i64 hi = frame_bound(in, (int)in.spec[S_HI_KIND], in.spec[S_HI_OFF],
                             false, i, ps, pe);
        lo = lo > ps ? lo : ps;
        hi = hi < pe ? hi : pe;
        const bool empty = lo > hi;
        const int agg = (int)in.spec[S_AGG];
        if (agg != A_CNT) {
          i64 s = 0;   // +0.0 too
          if (!empty) {
            const i64 top = in.sum[hi];
            if (agg == A_SUM_F) {
              s = as_i(as_f(top) - (lo >= 1 ? as_f(in.sum[lo - 1]) : 0.0));
            } else {
              s = wsub(top, lo >= 1 ? in.sum[lo - 1] : 0);
            }
          }
          out[dst] = s;
        }
        ((i64*)in.out1)[dst] =
            empty ? 0 : in.cnt[hi] - (lo >= 1 ? in.cnt[lo - 1] : 0);
        break;
      }
    }
  }
}

inline i64 tiles(i64 n) {
  const i64 nt = (n + kTile - 1) / kTile;
  return nt > 0 ? nt : 1;
}

}  // namespace

// flags[i] of n sorted rows from their words: host arrays `words` (device
// pointers) and `widths` (1 or 8 bytes) of n_words words, the first n_part
// of them partition words. One launch; returns cudaGetLastError(), or
// cudaErrorInvalidValue for more than 32 words or another width.
extern "C" int dft_window_flags(const void* const* words, const int* widths,
                                int n_words, int n_part, long long n,
                                void* flags, void* stream) {
  if (n_words < 0 || n_words > kMaxWords || n_part < 0 || n_part > n_words) {
    return (int)cudaErrorInvalidValue;
  }
  Words w;
  w.n_words = n_words;
  w.n_part = n_part;
  for (int k = 0; k < n_words; ++k) {
    if (widths[k] != 1 && widths[k] != 8) return (int)cudaErrorInvalidValue;
    w.p[k] = words[k];
    w.width[k] = widths[k];
  }
  flags_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      w, n, (uint8_t*)flags);
  return (int)cudaGetLastError();
}

// The forward scan of n flagged rows: val (int64 or float64 bits, null
// when sum_mode is SUM_NONE) and valid (uint8, or null) are sorted lanes;
// tiles: device int64 scratch of 4 * ceil(n / 2048) words; every output is
// device int64 [n] (sum and cnt may be null). Three launches; returns the
// first error.
extern "C" int dft_window_scan(const void* flags, long long n, const void* val,
                               const void* valid, int sum_mode, int cnt_mode,
                               void* tiles_, void* part_start,
                               void* peer_start, void* sum, void* cnt,
                               void* part_end_at, void* peer_end_at,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ScanIn in{(const uint8_t*)flags, n, (const i64*)val,
                  (const uint8_t*)valid, sum_mode, cnt_mode};
  const ScanOut out{(i64*)part_start, (i64*)peer_start, (i64*)sum,
                    (i64*)cnt, (i64*)part_end_at, (i64*)peer_end_at};
  const i64 nt = tiles(n);
  Carry* tot = (Carry*)tiles_;
  scan_reduce_kernel<<<(unsigned)nt, kThreads, 0, st>>>(in, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_top_kernel<<<1, kTopThreads, 0, st>>>(tot, nt, sum_mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_apply_kernel<<<(unsigned)nt, kThreads, 0, st>>>(in, tot, out);
  return (int)cudaGetLastError();
}

// Each row's result, scattered to out[perm[i]]: spec is a host array of 7
// words (device/window.py), the other pointers are device arrays from
// dft_window_scan and the sorted lanes (null where the kind reads none).
// One launch; returns cudaGetLastError().
extern "C" int dft_window_eval(const long long* spec, const void* perm,
                               long long n, const void* part_start,
                               const void* part_end_at,
                               const void* peer_start,
                               const void* peer_end_at, const void* sum,
                               const void* cnt, const void* val,
                               const void* valid, const void* dflt,
                               const void* dvalid, int width, void* out0,
                               void* out1, void* stream) {
  EvalIn in;
  in.perm = (const i64*)perm;
  in.n = n;
  in.part_start = (const i64*)part_start;
  in.part_end_at = (const i64*)part_end_at;
  in.peer_start = (const i64*)peer_start;
  in.peer_end_at = (const i64*)peer_end_at;
  in.sum = (const i64*)sum;
  in.cnt = (const i64*)cnt;
  in.val = val;
  in.valid = (const uint8_t*)valid;
  in.dflt = dflt;
  in.dvalid = (const uint8_t*)dvalid;
  in.width = width;
  for (int k = 0; k < kSpecWords; ++k) in.spec[k] = spec[k];
  in.out0 = out0;
  in.out1 = out1;
  eval_kernel<<<grid_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      in);
  return (int)cudaGetLastError();
}
