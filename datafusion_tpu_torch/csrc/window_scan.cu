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
// Design: one forward pass (window_pass_kernel), and a second launch
// (eval_kernel) only for a function that needs a segment's end.
//   - A block takes a tile of kTile consecutive sorted rows, in order from
//     an atomic tile counter; a thread takes kPer consecutive rows and the
//     row before them and finds, from the words in registers, which of its
//     rows start a partition and which a peer group (no flag array).
//   - It scans only the fields its function reads, chosen by a template
//     on the function kind (F_*): the partition start for row_number,
//     ntile and lag/lead, the peer start too for rank, percent_rank and
//     cume_dist, a peer count within the partition for dense_rank, the
//     value sum and valid count for a frame aggregate. The starts are
//     segmented: a partition start ends the carry from earlier rows.
//   - The carry crosses tiles by decoupled look-back (Merrill and Garland,
//     2016; lookback.cuh's protocol with a record of several words a tile
//     beside its status word): a tile publishes its own aggregate, the
//     first warp folds the records of earlier tiles back to the nearest
//     inclusive one (or, with no sum, to the nearest tile that starts a
//     partition: the starts before it do not matter), and the tile then
//     publishes its inclusive record.
//   - Functions that need no segment end write their results in this
//     pass at out[perm[i]] (the scatter replaces the JAX program's second
//     sort): row_number, rank, dense_rank, lag, a lead whose source row
//     lies in the tile or in the kHalo rows past it, and frames whose upper
//     bound is the current row or behind it, with a lower bound at the
//     partition start, the current row or a ROWS offset within kHalo rows.
//     Such a frame reads the prefix sums of the rows before its tile from
//     the last rows the tile before published with its inclusive record.
//   - The others (percent_rank, cume_dist, ntile, a lead past the halo,
//     frames that end at the partition's or peer group's end or look at a
//     peer start) write the per-row starts and prefix sums they read, and
//     the last row of each partition and peer group writes its index at
//     the segment's start, for eval_kernel: two launches.
// Float sums keep _build_step's arithmetic: a frame is the difference of
// two prefix sums, each running from +0.0, so one thread taking the tiles
// in order reproduces a sequential cumulative sum bit for bit; on the card
// the tiles' order of addition differs as any parallel scan's does. Sizes
// are exact: no row outside the input joins a segment or a sum.
//
// Bounds. The work must read the sorted words and lanes once, the
// permutation once, and write each output once: for query W1's rank at
// TPC-H SF10 (60M rows, two uint8 and two uint64 words) that is 26 B a row
// in and 8 B out, 2.0 GB: 0.61 ms at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 (700 W data sheet). One pass reads just that; the scatter to
// out[perm[i]] writes 8 B a row at random, a partial sector each, which the
// bound does not count (the floor `index_copy_` of one int64 lane shows).

#include <stdint.h>

#include <type_traits>

#include "lookback.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // consecutive rows a thread
constexpr int kTile = kThreads * kPer;    // rows a tile on the card
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 32;
constexpr int kHalo = 64;                 // rows a tile reads past its edges
constexpr int kRec = 7;                   // words of a tile's record
constexpr unsigned kAll = 0xffffffffu;

// spec words and codes: datafusion_tpu_torch/device/window.py
enum { S_KIND, S_ARG, S_AGG, S_LO_KIND, S_LO_OFF, S_HI_KIND, S_HI_OFF,
       kSpecWords };
enum { K_ROW_NUMBER, K_RANK, K_DENSE_RANK, K_PERCENT_RANK, K_CUME_DIST,
       K_NTILE, K_SHIFT, K_AGG };
enum { A_SUM_I, A_SUM_F, A_CNT };
enum { B_PART, B_CUR, B_PEER, B_ROWS };
// the fields a pass carries (window.py `_pass_plan`)
enum { F_QS = 1, F_DENSE = 2, F_SUM_I = 4, F_SUM_F = 8, F_CNT = 16 };

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

// ---- the carry -----------------------------------------------------------

// What a span of sorted rows carries to the rows after it. Fields the
// template flags leave out stay at their identity.
struct Carry {
  i64 ps, qs;     // the last partition / peer start in the span, -1: none
  i64 d;          // peer starts since ps (all of the span's without one)
  i64 s, c;       // value sum (int64, or float64 bits) and valid count
  i64 pbs, pbc;   // s and c of the rows before ps (when ps >= 0)
};

template <int F> constexpr bool kSums = (F & (F_SUM_I | F_SUM_F)) != 0;
template <int F> constexpr bool kCounts = (F & F_CNT) != 0;

template <int F>
__device__ __forceinline__ i64 add_sum(i64 a, i64 b) {
  return (F & F_SUM_F) ? as_i(as_f(a) + as_f(b)) : wadd(a, b);
}

__device__ __forceinline__ Carry identity() {
  return Carry{-1, -1, 0, 0, 0, 0, 0};   // a sum's 0 is +0.0 too
}

// a then b (a holds the earlier rows)
template <int F>
__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b) {
  Carry r = identity();
  const bool bp = b.ps >= 0;
  r.ps = bp ? b.ps : a.ps;
  if (F & F_QS) r.qs = b.qs >= 0 ? b.qs : a.qs;
  if (F & F_DENSE) r.d = bp ? b.d : a.d + b.d;
  if (kSums<F>) {
    r.s = add_sum<F>(a.s, b.s);
    r.pbs = bp ? add_sum<F>(a.s, b.pbs) : a.pbs;
  }
  if (kCounts<F>) {
    r.c = a.c + b.c;
    r.pbc = bp ? a.c + b.pbc : a.pbc;
  }
  return r;
}

// row i: starts a partition (part), a peer group (peer), its value x (0 =
// +0.0 when not valid) and validity
template <int F>
__device__ __forceinline__ Carry row_value(i64 i, bool part, bool peer,
                                           i64 x, bool ok) {
  Carry v = identity();
  v.ps = part ? i : -1;
  if (F & F_QS) v.qs = peer ? i : -1;
  if (F & F_DENSE) v.d = peer;
  if (kSums<F>) v.s = x;
  if (kCounts<F>) v.c = ok;
  return v;
}

template <int F, class Shfl>
__device__ __forceinline__ Carry shuffled(const Carry& x, Shfl shfl) {
  Carry y = identity();
  y.ps = shfl(x.ps);
  if (F & F_QS) y.qs = shfl(x.qs);
  if (F & F_DENSE) y.d = shfl(x.d);
  if (kSums<F>) {
    y.s = shfl(x.s);
    y.pbs = shfl(x.pbs);
  }
  if (kCounts<F>) {
    y.c = shfl(x.c);
    y.pbc = shfl(x.pbc);
  }
  return y;
}

template <int F>
__device__ __forceinline__ Carry shfl_up(const Carry& x, int o) {
  return shuffled<F>(x, [o](i64 v) { return __shfl_up_sync(kAll, v, o); });
}

template <int F>
__device__ __forceinline__ Carry shfl_down(const Carry& x, int o) {
  return shuffled<F>(x, [o](i64 v) { return __shfl_down_sync(kAll, v, o); });
}

template <int F>
__device__ __forceinline__ Carry from_lane0(const Carry& x) {
  return shuffled<F>(x, [](i64 v) { return __shfl_sync(kAll, v, 0); });
}

__device__ __forceinline__ void store_record(i64* at, const Carry& c) {
  volatile i64* v = at;
  v[0] = c.ps;
  v[1] = c.qs;
  v[2] = c.d;
  v[3] = c.s;
  v[4] = c.c;
  v[5] = c.pbs;
  v[6] = c.pbc;
}

__device__ __forceinline__ Carry load_record(const i64* at) {
  const volatile i64* v = at;
  return Carry{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
}

// Exclusive scan of v over the block; *total gets the block's whole.
// Every thread of the block calls it.
template <int F>
__device__ Carry block_exclusive(const Carry& v, Carry* total) {
  __shared__ Carry warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  Carry x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const Carry y = shfl_up<F>(x, o);
    if (lane >= o) x = combine<F>(y, x);
  }
  const Carry before = shfl_up<F>(x, 1);   // this lane's exclusive
  if (lane == 31 || threadIdx.x == blockDim.x - 1) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Carry w = lane < warps ? warp_tot[lane] : identity();
    for (int o = 1; o < 32; o <<= 1) {
      const Carry y = shfl_up<F>(w, o);
      if (lane >= o) w = combine<F>(y, w);
    }
    if (lane < warps) warp_tot[lane] = w;
  }
  __syncthreads();
  Carry excl = warp > 0 ? warp_tot[warp - 1] : identity();
  if (lane > 0) excl = combine<F>(excl, before);
  *total = warp_tot[warps - 1];
  return excl;
}

// The carry of every tile before `tile` (> 0), by the first warp (every
// lane returns it): lane l reads tile t - l's status and record, 32 tiles a
// round trip, and the walk folds the records back to the nearest one that
// closes it: an inclusive record, or, without a sum or count, one that
// starts a partition.
template <int F>
__device__ Carry carry_before(const u64* status, const i64* aggs,
                           const i64* incls, i64 tile) {
  const int lane = threadIdx.x & 31;
  Carry excl = identity();
  for (i64 t = tile - 1;; t -= 32) {
    const i64 mine = t - lane;
    Carry v;
    unsigned close;
    for (;;) {
      // past tile 0 (whose record is inclusive) a lane reads nothing
      const u64 st = mine >= 0 ? load_status(status + mine) : kInclusive;
      v = identity();
      if (st != 0 && mine >= 0) {
        __threadfence();
        v = load_record((st == kInclusive ? incls : aggs) + mine * kRec);
      }
      const bool closes = st == kInclusive ||
          (st == kAggregate && !kSums<F> && !kCounts<F> && v.ps >= 0);
      const unsigned ready = __ballot_sync(kAll, st != 0);
      close = __ballot_sync(kAll, closes);
      // the lanes up to the nearest closing record (all 32 without one)
      const unsigned need = close ? (close & (0u - close)) * 2u - 1u : kAll;
      if ((ready & need) == need) break;
    }
    const int stop = close ? __ffs(close) - 1 : 31;
    if (lane > stop) v = identity();
    // lane l holds tile t - l: fold the older lanes into lane 0
    for (int o = 1; o < 32; o <<= 1) {
      const Carry older = shfl_down<F>(v, o);
      if (lane + o <= stop) v = combine<F>(older, v);
    }
    excl = combine<F>(from_lane0<F>(v), excl);
    if (close) return excl;
  }
}

// ---- the words -----------------------------------------------------------

struct Words {
  const void* p[kMaxWords];
  int width[kMaxWords];   // 1 or 8 bytes
  int n_words;
  int n_part;             // the first n_part words are partition words
};

__device__ __forceinline__ u64 word_at(const Words& w, int k, i64 i) {
  return w.width[k] == 8 ? ((const u64*)w.p[k])[i]
                         : (u64)((const uint8_t*)w.p[k])[i];
}

// Bits r = 0 .. kPer of *pm and *qm: row first + r starts a partition, a
// peer group. Row 0 and the rows past n start both (a segment ends at
// n - 1).
__device__ __forceinline__ void row_flags(const Words& w, i64 first, i64 n,
                                          unsigned* pm, unsigned* qm) {
  unsigned part = 0, peer = 0;
  for (int r = 0; r <= kPer; ++r) {
    if (first + r == 0 || first + r >= n) part |= 1u << r;
  }
  for (int k = 0; k < w.n_words; ++k) {
    unsigned diff = 0;
    u64 prev = first > 0 && first <= n ? word_at(w, k, first - 1) : 0;
    for (int r = 0; r <= kPer && first + r < n; ++r) {
      const u64 v = word_at(w, k, first + r);
      if (v != prev) diff |= 1u << r;
      prev = v;
    }
    if (k < w.n_part) {
      part |= diff;
    } else {
      peer |= diff;
    }
  }
  *pm = part;
  *qm = part | peer;
}

// whether row i (>= 0) starts a partition; rows past n do
__device__ __forceinline__ bool starts_partition(const Words& w, i64 i,
                                                 i64 n) {
  if (i == 0 || i >= n) return true;
  for (int k = 0; k < w.n_part; ++k) {
    if (word_at(w, k, i) != word_at(w, k, i - 1)) return true;
  }
  return false;
}

// ---- the pass ------------------------------------------------------------

struct PassIn {
  Words w;
  i64 n;
  const i64* perm;
  const i64* val;         // sorted value lane: the summed int64 or float64
                          // bits, or a shifted value of `width` bytes
  const uint8_t* valid;   // its validity (null: all valid)
  const void* dflt;       // a shift's sorted default lane, or null
  const uint8_t* dvalid;  // and its validity (null: all valid)
  int width;
  i64 spec[kSpecWords];
  int halo;               // rows behind the tile a frame reads, or past
                          // it that a lead tests
  int arrays;             // write eval_kernel's inputs, not results
  void* out0;             // data (ranks, shift) or sum
  void* out1;             // shift: validity (uint8); agg: count
  i64* part_start;        // eval_kernel's inputs [n], null where unread
  i64* peer_start;
  i64* sum;
  i64* cnt;
  i64* part_end_at;       // [a partition's start] = its last row
  i64* peer_end_at;       // [a peer group's start] = its last row
  u64* status;            // [tiles] status words, then the tile counter
  i64* aggs;              // [tiles][kRec] the tiles' own records
  i64* incls;             // [tiles][kRec] the inclusive records
  i64* halo_out;          // [tiles][2][halo] a frame's P and C of each
                          // tile's last `halo` rows, or null
  i64 tiles;
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

// A shift's value and validity for sorted row i (at dst), whose source row
// src is in its partition or not (_build_step's `in_part`); `in` is either
// kernel's input.
template <class In>
__device__ __forceinline__ void shift_out(const In& in, i64 i, i64 src,
                                          bool in_part, i64 dst) {
  const i64 safe = src < 0 ? 0 : (src > in.n - 1 ? in.n - 1 : src);
  bool v = in_part && (in.valid == nullptr || in.valid[safe]);
  if (in.dflt != nullptr && !in_part) {
    copy_value(in.out0, dst, in.dflt, i, in.width);
    v = in.dvalid == nullptr || in.dvalid[i];
  } else {
    copy_value(in.out0, dst, in.val, safe, in.width);
  }
  ((uint8_t*)in.out1)[dst] = (uint8_t)v;
}

// A frame's sum (int64, or float64 bits when `fsum`) of the rows between
// two prefix sums: top, and below, the sum before the frame (none when the
// frame starts at row 0), as _build_step takes the difference.
__device__ __forceinline__ i64 frame_sum(bool fsum, i64 top, i64 below,
                                         bool has_below) {
  if (fsum) return as_i(as_f(top) - (has_below ? as_f(below) : 0.0));
  return wsub(top, has_below ? below : 0);
}

// One tile of the forward pass (module comment). Dynamic shared memory: a
// one-pass frame's prefix sums P and C of rows [b - halo, b + tile) (two
// int64 arrays of tile + halo), or with `arrays` a buffer of kPer + 1
// int64 a thread, else none.
template <int F>
__global__ void __launch_bounds__(kThreads)
window_pass_kernel(const __grid_constant__ PassIn in) {
  extern __shared__ i64 smem[];
  __shared__ i64 tile_sh;
  __shared__ Carry carry_sh, incl_sh;
  __shared__ uint8_t lead_starts[kTile + kHalo];
  const int kind = (int)in.spec[S_KIND];
  const bool frame = kCounts<F> && !in.arrays;    // results from P and C
  const bool lead = kind == K_SHIFT && in.spec[S_ARG] > 0 && !in.arrays;
  const int H = in.halo;
  const i64 n = in.n;
  const i64 T = (i64)blockDim.x * kPer;
  if (threadIdx.x == 0) {
    tile_sh = (i64)atomicAdd((u64*)(in.status + in.tiles), 1ull);
  }
  __syncthreads();
  const i64 tile = tile_sh;
  const i64 b = tile * T;
  const i64 first = b + (i64)threadIdx.x * kPer;
  i64* Ps = smem;               // row r at [r - b + H]
  i64* Cs = smem + T + H;

  // 1. the thread's rows: flags, values, its aggregate
  unsigned pm, qm, okm = 0;
  row_flags(in.w, first, n, &pm, &qm);
  i64 x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    x[k] = 0;
    if (!kCounts<F> || first + k >= n) continue;
    const bool ok = in.valid == nullptr || in.valid[first + k];
    okm |= (unsigned)ok << k;
    if (kSums<F> && ok) x[k] = in.val[first + k];
  }
  Carry agg = identity();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (first + k < n) {
      agg = combine<F>(agg, row_value<F>(first + k, pm >> k & 1,
                                         qm >> k & 1, x[k], okm >> k & 1));
    }
  }
  Carry total;
  const Carry excl = block_exclusive<F>(agg, &total);

  // 2. the carry from the tiles before
  if (tile > 0 && threadIdx.x == 0) {
    store_record(in.aggs + tile * kRec, total);
    __threadfence();
    store_status(in.status + tile, kAggregate);
  }
  if (threadIdx.x < 32) {
    const Carry e = tile > 0 ? carry_before<F>(in.status, in.aggs,
                                                in.incls, tile)
                             : identity();
    if (threadIdx.x == 0) carry_sh = e;
  }
  __syncthreads();
  const Carry E = carry_sh;
  const Carry start = combine<F>(E, excl);

  // 3. the tile's inclusive record: the running carry of its last row (a
  // frame's P and C of every row too)
  if (frame || threadIdx.x == blockDim.x - 1) {
    Carry r = start;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (first + k >= n) break;
      r = combine<F>(r, row_value<F>(first + k, pm >> k & 1, qm >> k & 1,
                                     x[k], okm >> k & 1));
      if (frame) {
        Ps[first + k - b + H] = r.s;
        Cs[first + k - b + H] = r.c;
      }
    }
    if (threadIdx.x == blockDim.x - 1) incl_sh = r;
  }
  // a frame's prefix sums before the tile: row b - 1's is E's; the rows
  // before it the tile before published (its last H rows)
  const bool behind = frame && H > 1 && tile > 0;
  auto load_halo = [&]() {
    if (threadIdx.x == 0) {
      while (load_status(in.status + tile - 1) != kInclusive) {
      }
      __threadfence();
    }
    __syncthreads();
    const volatile i64* h = in.halo_out + (tile - 1) * 2 * H;
    for (int m = threadIdx.x; m < H - 1; m += blockDim.x) {
      Ps[m] = h[m];
      Cs[m] = h[H + m];
    }
  };
  if (frame && threadIdx.x == 0) {
    Ps[H - 1] = E.s;
    Cs[H - 1] = E.c;
  }
  // tiles shorter than the halo (one thread a block) reach past the tile
  // before: they take its halo before they publish their own
  if (behind && T < H) load_halo();
  if (lead) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      lead_starts[first + k - b] = pm >> k & 1;
    }
    for (int m = threadIdx.x; m < H; m += blockDim.x) {
      lead_starts[T + m] = starts_partition(in.w, b + T + m, n);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    store_record(in.incls + tile * kRec, incl_sh);
    if (frame && in.halo_out != nullptr) {
      volatile i64* h = in.halo_out + tile * 2 * H;
      for (int m = 0; m < H; ++m) {
        h[m] = Ps[T + m];
        h[H + m] = Cs[T + m];
      }
    }
    __threadfence();
    store_status(in.status + tile, kInclusive);
  }
  if (behind && T >= H) load_halo();
  __syncthreads();

  // 4. each row's result at out[perm[i]], or eval_kernel's inputs
  Carry r = start;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const i64 i = first + k;
    if (i >= n) break;
    r = combine<F>(r, row_value<F>(i, pm >> k & 1, qm >> k & 1, x[k],
                                   okm >> k & 1));
    if (in.arrays) {   // the segment ends (the per-row arrays below)
      if (pm >> (k + 1) & 1) in.part_end_at[r.ps] = i;
      if (in.peer_end_at != nullptr && (qm >> (k + 1) & 1)) {
        in.peer_end_at[r.qs] = i;
      }
      continue;
    }
    const i64 dst = in.perm[i];
    i64* out = (i64*)in.out0;
    switch (kind) {
      case K_ROW_NUMBER: out[dst] = i - r.ps + 1; break;
      case K_RANK: out[dst] = r.qs - r.ps + 1; break;
      case K_DENSE_RANK: out[dst] = r.d; break;
      case K_SHIFT: {
        const i64 off = in.spec[S_ARG];
        bool in_part = i + off >= r.ps;
        if (off > 0) {
          in_part = i + off < n;
          for (i64 m = 1; m <= off && in_part; ++m) {
            in_part = !lead_starts[i - b + m];
          }
        }
        shift_out(in, i, i + off, in_part, dst);
        break;
      }
      default: {   // K_AGG: lo at the partition start, the row or a ROWS
                   // offset, hi at the row or behind it
        const int lk = (int)in.spec[S_LO_KIND];
        i64 lo = lk == B_PART ? r.ps : i + (lk == B_ROWS ? in.spec[S_LO_OFF]
                                                         : 0);
        const i64 hi = i + ((int)in.spec[S_HI_KIND] == B_ROWS
                                ? in.spec[S_HI_OFF] : 0);
        lo = lo > r.ps ? lo : r.ps;
        i64 s = 0, c = 0;   // an empty frame's: +0.0 too
        if (lo <= hi) {
          // the sums before lo: row ps - 1's from the carry when the
          // partition started before the tile
          const bool from_carry = lo == r.ps && r.ps < b;
          i64 bs = 0, bc = 0;
          if (from_carry) {
            bs = E.pbs;
            bc = E.pbc;
          } else if (lo >= 1) {
            bs = Ps[lo - 1 - b + H];
            bc = Cs[lo - 1 - b + H];
          }
          s = frame_sum(in.spec[S_AGG] == A_SUM_F, Ps[hi - b + H], bs,
                        lo >= 1);
          c = Cs[hi - b + H] - (lo >= 1 ? bc : 0);
        }
        if (in.spec[S_AGG] != A_CNT) out[dst] = s;
        ((i64*)in.out1)[dst] = c;
        break;
      }
    }
  }
  if (!in.arrays) return;
  // eval_kernel's per-row inputs, each through shared memory so that a
  // warp's stores are coalesced (a thread holds consecutive rows)
  auto field = [&](i64* out, auto get) {
    __syncthreads();   // the buffer is free
    Carry q = start;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (first + k >= n) break;
      q = combine<F>(q, row_value<F>(first + k, pm >> k & 1, qm >> k & 1,
                                     x[k], okm >> k & 1));
      smem[threadIdx.x * (kPer + 1) + k] = get(q);
    }
    __syncthreads();
    for (int j = 0; j < kPer; ++j) {
      const i64 m = (i64)j * blockDim.x + threadIdx.x;
      if (b + m < n) out[b + m] = smem[m / kPer * (kPer + 1) + m % kPer];
    }
  };
  field(in.part_start, [](const Carry& q) { return q.ps; });
  if (in.peer_start != nullptr) {
    field(in.peer_start, [](const Carry& q) { return q.qs; });
  }
  if (kSums<F>) field(in.sum, [](const Carry& q) { return q.s; });
  if (kCounts<F>) field(in.cnt, [](const Carry& q) { return q.c; });
}

// ---- eval: the functions that need a segment's end -----------------------

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
        shift_out(in, i, src, src >= ps && src <= pe, dst);
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
          out[dst] = empty ? 0 : frame_sum(agg == A_SUM_F, in.sum[hi],
                                           lo >= 1 ? in.sum[lo - 1] : 0,
                                           lo >= 1);   // 0: +0.0 too
        }
        ((i64*)in.out1)[dst] =
            empty ? 0 : in.cnt[hi] - (lo >= 1 ? in.cnt[lo - 1] : 0);
        break;
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

// fn(std::integral_constant<int, F>) for a valid set of pass fields F;
// false for another
template <class Fn>
bool with_fields(int f, Fn fn) {
  switch (f) {
#define DFT_FIELDS(v) \
    case (v): fn(std::integral_constant<int, (v)>()); return true;
    DFT_FIELDS(0)
    DFT_FIELDS(F_QS)
    DFT_FIELDS(F_DENSE)
    DFT_FIELDS(F_CNT)
    DFT_FIELDS(F_CNT | F_QS)
    DFT_FIELDS(F_CNT | F_SUM_I)
    DFT_FIELDS(F_CNT | F_SUM_I | F_QS)
    DFT_FIELDS(F_CNT | F_SUM_F)
    DFT_FIELDS(F_CNT | F_SUM_F | F_QS)
#undef DFT_FIELDS
    default: return false;
  }
}

// The pass's inputs; false for more than 32 words, another width or a
// halo past kHalo.
inline bool pass_in(PassIn* in, const void* const* words, const int* widths,
                    int n_words, int n_part, i64 n, const i64* spec,
                    int halo, int arrays, const void* perm, const void* val,
                    const void* valid, const void* dflt, const void* dvalid,
                    int width, void* out0, void* out1, void* const* eval,
                    void* state, void* records, void* halo_out, i64 tiles) {
  if (n_words < 0 || n_words > kMaxWords || n_part < 0 || n_part > n_words ||
      halo < 0 || halo > kHalo) {
    return false;
  }
  in->w.n_words = n_words;
  in->w.n_part = n_part;
  for (int k = 0; k < n_words; ++k) {
    if (widths[k] != 1 && widths[k] != 8) return false;
    in->w.p[k] = words[k];
    in->w.width[k] = widths[k];
  }
  in->n = n;
  in->perm = (const i64*)perm;
  in->val = (const i64*)val;
  in->valid = (const uint8_t*)valid;
  in->dflt = dflt;
  in->dvalid = (const uint8_t*)dvalid;
  in->width = width;
  for (int k = 0; k < kSpecWords; ++k) in->spec[k] = spec[k];
  in->halo = halo;
  in->arrays = arrays;
  in->out0 = out0;
  in->out1 = out1;
  in->part_start = (i64*)eval[0];
  in->peer_start = (i64*)eval[1];
  in->sum = (i64*)eval[2];
  in->cnt = (i64*)eval[3];
  in->part_end_at = (i64*)eval[4];
  in->peer_end_at = (i64*)eval[5];
  in->status = (u64*)state;
  in->aggs = (i64*)records;
  in->incls = (i64*)records + tiles * kRec;
  in->halo_out = (i64*)halo_out;
  in->tiles = tiles;
  return true;
}

inline EvalIn eval_in(const PassIn& p) {
  EvalIn in;
  in.perm = p.perm;
  in.n = p.n;
  in.part_start = p.part_start;
  in.part_end_at = p.part_end_at;
  in.peer_start = p.peer_start;
  in.peer_end_at = p.peer_end_at;
  in.sum = p.sum;
  in.cnt = p.cnt;
  in.val = p.val;
  in.valid = p.valid;
  in.dflt = p.dflt;
  in.dvalid = p.dvalid;
  in.width = p.width;
  for (int k = 0; k < kSpecWords; ++k) in.spec[k] = p.spec[k];
  in.out0 = p.out0;
  in.out1 = p.out1;
  return in;
}

}  // namespace

// One window function over n sorted rows (the module comment): words and
// widths are host arrays of n_words device pointers and their widths (1 or
// 8 bytes), the first n_part of them partition words; spec a host array of
// 7 words and fields the pass's F_* set (device/window.py); halo the rows
// a one-pass frame reads behind a tile or a lead past it (at most 64);
// with `arrays`, eval: a host array of 6 device int64 [n] pointers
// (part_start, peer_start, sum, cnt, part_end_at, peer_end_at; null where
// the function reads none) for a second launch that writes the results,
// else null. perm and the sorted lanes (val, valid, dflt, dvalid; null
// where the function reads none) and the outputs are device arrays; state:
// device uint64 [tiles + 1], zeroed; records: device int64 [2 * tiles *
// 7]; halo_out: device int64 [tiles * 2 * halo] for a one-pass frame, else
// null; tiles = ceil(n / 2048). One launch, or two with `arrays`; returns
// the first error, or cudaErrorInvalidValue for a bad spec.
extern "C" int dft_window_pass(const void* const* words, const int* widths,
                               int n_words, int n_part, long long n,
                               const long long* spec, int fields, int halo,
                               int arrays, const void* perm, const void* val,
                               const void* valid, const void* dflt,
                               const void* dvalid, int width, void* out0,
                               void* out1, void* const* eval, void* state,
                               void* records, void* halo_out,
                               long long tiles, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* none[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  PassIn in;
  if (!pass_in(&in, words, widths, n_words, n_part, n, spec, halo, arrays,
               perm, val, valid, dflt, dvalid, width, out0, out1,
               arrays ? eval : none, state, records, halo_out, tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  // a one-pass frame's prefix sums, or the buffer of eval_kernel's inputs
  const size_t shared = arrays ? (size_t)kThreads * (kPer + 1) * 8
                        : (fields & F_CNT) ? (size_t)2 * (kTile + halo) * 8
                                           : 0;
  const bool ok = with_fields(fields, [&](auto f) {
    window_pass_kernel<decltype(f)::value>
        <<<(unsigned)tiles, kThreads, shared, st>>>(in);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !arrays) return (int)err;
  eval_kernel<<<grid_for(n, kThreads), kThreads, 0, st>>>(eval_in(in));
  return (int)cudaGetLastError();
}
