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
// Design. Two launches on the caller's stream, designed for the H100:
//   1. mark: tiles of kTile = 4,096 entries (slots, or positions in the
//      slot list) are taken in order from an atomic tile counter. A warp
//      owns 512 consecutive entries and reads the key row coalesced: lane
//      l holds entries base + 64 i + 2 l and + 1 through 16-byte loads, 4
//      at a time (few registers, so 8 blocks an SM hide the tile counter)
//      when the table is 16-byte aligned (entries base + 32 i + l
//      otherwise, and through the list in slot-list mode). The keep test
//      (occupied, and the HAVING) runs once an entry; __ballot_sync turns it
//      into one 32-bit keep word per 32 entries, in entry order, written
//      to a bitmask scratch (cap / 8 bytes). __popc and a block sum give
//      the tile's count, and the decoupled look-back of lookback.cuh turns
//      the counts into the tile's exclusive offset (warp 0 walks back 32
//      tiles a round trip), so the count and the scan are one launch. The
//      last tile writes ng;
//   2. copy: one block a tile with a kept entry reads its 128 keep words
//      and its offset (its inclusive status word less its count), ranks
//      the kept entries into a shared list of at most 4,096 tile
//      positions in entry order, then consecutive threads copy
//      consecutive kept entries (one a thread where tiles keep few, four
//      where they keep more than 256 on average), four rows at a time:
//      out[r * ng + off + j] =
//      table[r * cap + slot_j]. The writes are coalesced and the reads go
//      in rising slot order. The key row is read again only at the kept
//      slots.
// The HAVING. The host splits it into its top-level conjuncts
// (groupby.py `HavingSpec`) and lays each out in the join walk's record
// form (program.cuh CJ_*): a column tested against a constant (its
// constant folded, so Q18's rescaled `sum(l_quantity) > 300` is one
// CJ_CMP_I), a column or an IN list. When every conjunct tests a count,
// a sum, or a min or max without a NaN count against a constant or an IN
// list (HAVING_DIRECT), the 16-byte layout tests them inline for the
// lane's pairs of slots (`having_pairs`: the value row's loads in flight
// together behind the key row's, `conjunct_test`, the count row only
// where the test passed), with no call, no interpreter and no stack
// array, 4 blocks an SM (kDirectBlocks). Any other HAVING
// (HAVING_PROGRAM), and any HAVING over a slot list, takes a slot at a
// time through `passes`, one block an SM: a direct conjunct finalises its
// column whole and tests it without the interpreter, a program conjunct
// runs through program.cuh's interpreter. A slot is kept when every
// conjunct is valid and true: the Kleene AND of the whole HAVING.
// The caller reads ng between 1 and 2 to size the output (its one
// synchronisation) and skips 2 when ng is 0. The output is the same from
// run to run: entry order.
//
// Bounds. The key row is read once (8 bytes a slot) with, for occupied
// slots, the rows a HAVING reads (a sum's count row only where its test
// passed); the kept groups' rows are read and
// written once. ClickBench Q17 (4.1M groups in 2^28 slots, 3 rows) must
// move its 2.15 GB key row and about 0.1 GB of kept rows: 0.69 ms at 3.35
// TB/s (NVIDIA H100 80GB HBM3, 700 W data sheet). The bitmask (32 MiB at
// 2^28) is written once and read once; a kept slot's rows are read
// through 32-byte sectors, so sparse groups cost more than their bytes.

#include "lookback.cuh"
#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                // entries a tile (groupby.py)
constexpr int kWords = kTile / 32;         // keep words a tile
constexpr int kWarpWords = kWords / kWarps;   // 16 a warp: 512 entries
constexpr int kLoads = 4;        // 16-byte loads a lane issues at once
constexpr int kMarkBlocks = 8;   // resident mark blocks an SM (no HAVING)
constexpr int kCopyRows = 4;     // rows a copy thread loads at once
// HAVING_DIRECT: resident mark blocks an SM. Measured on Q18's subquery
// (H100, `chip_smoke.py --marks`): 4 blocks of 63 registers and no stack,
// 0.43 ms; the no-HAVING mark's 8 blocks cap a thread at 32 registers and
// spill (72 B of stack; 40 B testing 2 pairs at a time, not 4), 0.50-0.57.
constexpr int kDirectBlocks = 4;
constexpr u64 kEpoch = 1;                  // one pass; status zeroed a call

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

// HAVING modes (groupby.py HavingSpec.mode): none; every conjunct a lean
// direct one (`having_pairs`); any other (a slot at a time through
// `passes`)
enum { HAVING_NONE = 0, HAVING_DIRECT = 1, HAVING_PROGRAM = 2 };

// The second column of a lean conjunct: none (conjunct_test reads one only
// for CJ_CMPC_*, which is not lean)
struct NoColumns {
  static constexpr bool kFull = false;
  __device__ __forceinline__ bool operator()(i64, i64, i64*) const {
    return false;
  }
};

// Direct conjunct `cj` at slot s, its column finalised whole. Not inlined:
// `passes` calls it for each direct conjunct.
__device__ __noinline__ bool conjunct_at(const i64* meta, const i64* cj,
                                         const i64* table, i64 cap, i64 s) {
  const GroupColumns cols{meta + meta[H_OFF_COLS], table, cap};
  i64 x;
  return cols(cj[1], s, &x) && conjunct_test(meta, nullptr, cj, x, s, cols);
}

// The HAVING of an occupied slot s: every conjunct in the descriptor's
// order, a program through the interpreter. Not inlined: the mark pass
// calls it at 8 sites, one body serves them all.
__device__ __noinline__ bool passes(const i64* meta, const i64* table,
                                    i64 cap, i64 s) {
  const GroupColumns cols{meta + meta[H_OFF_COLS], table, cap};
  const i64* hv = meta + meta[H_OFF_CHAIN];
  const i64* cj = hv + 1;
  for (int c = 0; c < (int)hv[0]; ++c, cj += kConjWords) {
    if ((int)cj[0] == CJ_PROG) {
      i64 x;
      if (!(run(meta, nullptr, (int)cj[1], s, cols, &x) && x != 0)) {
        return false;
      }
    } else if (!conjunct_at(meta, cj, table, cap, s)) {
      return false;
    }
  }
  return true;
}

// Entry e of a lane whose round starts at slot j0 in the 16-byte layout:
// pairs of slots 64 apart
__device__ __forceinline__ i64 pair_slot(i64 j0, int e) {
  return j0 + 64 * (e >> 1) + (e & 1);
}

// HAVING_DIRECT over the lane's 2 P entries at pair_slot(j0, e), those
// whose bit is set in `alive` (occupied); returns the bits that pass.
// Every conjunct is lean: a count, a sum, or a min or max without a NaN
// count tested against a constant or an IN list (the host's
// `HavingSpec.mode`). Each loads its value row at every live entry at
// once, tests it with `conjunct_test`, and loads the count row (the
// validity) only where the test passed: a slot passes when its column is
// valid and the test true, so the order changes nothing, and a selective
// HAVING (Q18's sum > 300) reads one row, not two. No call and no stack
// array.
template <int P>
__device__ __forceinline__ unsigned having_pairs(const i64* meta,
                                                 const i64* table, i64 cap,
                                                 i64 j0, unsigned alive) {
  const i64* fin = meta + meta[H_OFF_COLS];
  const i64* hv = meta + meta[H_OFF_CHAIN];
  const i64* cj = hv + 1;
  for (int c = 0; c < (int)hv[0] && alive != 0; ++c, cj += kConjWords) {
    const i64* f = fin + kFinWords * cj[1];
    const int kind = (int)f[0];
    const i64* row = table + f[1] * cap + j0;
    i64 x[2 * P];
#pragma unroll
    for (int e = 0; e < 2 * P; ++e) {
      if (alive >> e & 1) x[e] = row[64 * (e >> 1) + (e & 1)];
    }
    const bool f32 = kind == FIN_SUM && f[3] == LANE_SUM_F32;
#pragma unroll
    for (int e = 0; e < 2 * P; ++e) {
      if (!(alive >> e & 1)) continue;
      const i64 v = f32 ? as_i(sum_value(LANE_SUM_F32, x[e])) : x[e];
      if (!conjunct_test(meta, nullptr, cj, v, 0, NoColumns{})) {
        alive &= ~(1u << e);
      }
    }
    if (kind == FIN_COUNT) continue;
    const i64* count = table + f[2] * cap + j0;
#pragma unroll
    for (int e = 0; e < 2 * P; ++e) {
      if ((alive >> e & 1) && count[64 * (e >> 1) + (e & 1)] <= 0) {
        alive &= ~(1u << e);
      }
    }
  }
  return alive;
}

// A 16-byte round's keep bits (2 kLoads entries from slot j0, `alive` the
// occupied ones) after the HAVING of `Mode`
template <int Mode>
__device__ __forceinline__ unsigned keep_pairs(const i64* meta,
                                               const i64* table, i64 cap,
                                               i64 j0, unsigned alive) {
  if constexpr (Mode == HAVING_DIRECT) {
    return having_pairs<kLoads>(meta, table, cap, j0, alive);
  }
  if constexpr (Mode == HAVING_PROGRAM) {
#pragma unroll
    for (int e = 0; e < 2 * kLoads; ++e) {
      if ((alive >> e & 1) &&
          !passes(meta, table, cap, pair_slot(j0, e))) {
        alive &= ~(1u << e);
      }
    }
  }
  return alive;
}

// 16 bits spread to the even bits of a word
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xffffu;
  x = (x | x << 8) & 0x00ff00ffu;
  x = (x | x << 4) & 0x0f0f0f0fu;
  x = (x | x << 2) & 0x33333333u;
  return (x | x << 1) & 0x55555555u;
}

// Launch 1. Vec: the whole table (n = cap), 16-byte aligned, read two
// slots a lane a load; otherwise one entry a lane a load, through `slots`
// when it is not null. A HAVING's warp loops over its loads' rounds
// without unrolling them: its keep test is large.
template <int Mode, bool Vec>
__global__ void __launch_bounds__(kThreads, Mode == HAVING_PROGRAM ? 1
                                   : Mode == HAVING_DIRECT ? kDirectBlocks
                                                           : kMarkBlocks)
compact_mark_kernel(const i64* __restrict__ meta_g, int meta_len,
                    const i64* __restrict__ table, i64 cap,
                    const i64* __restrict__ slots, i64 n,
                    unsigned* __restrict__ keep_words, u64* status,
                    u64* __restrict__ tile_counter, i64 n_tiles,
                    i64* __restrict__ ng) {
  constexpr int kRounds = Vec ? kWarpWords / 2 / kLoads
                              : kWarpWords / (2 * kLoads);
  extern __shared__ i64 smem[];      // the HAVING descriptor
  __shared__ i64 tile_sh;
  __shared__ unsigned warp_count[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_sh = (i64)atomicAdd(tile_counter, 1ull);
  if (Mode != HAVING_NONE) {
    stage_meta(smem, meta_g, meta_len);   // ends in __syncthreads
  } else {
    __syncthreads();
  }
  const i64 tile = tile_sh;
  const i64 base = tile * kTile + (i64)warp * (32 * kWarpWords);
  unsigned word = 0;   // lane w < 16 keeps the warp's keep word w
  if (Vec) {
    // kLoads 16-byte loads at a time: two entries a lane a load
#pragma unroll (Mode == HAVING_NONE ? kRounds : 1)
    for (int r = 0; r < kRounds; ++r) {
      const int h = r * kLoads;
      longlong2 k[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const i64 j = base + 64 * (h + u) + 2 * lane;
        if (j + 1 < n) {
          k[u] = __ldg((const longlong2*)(table + j));
        } else {
          k[u].x = j < n ? table[j] : kEmpty;
          k[u].y = kEmpty;
        }
      }
      // entry 2 u (+ 1) is slot base + 64 (h + u) + 2 lane (+ 1)
      unsigned kept = 0;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        kept |= (unsigned)(k[u].x != kEmpty) << (2 * u) |
                (unsigned)(k[u].y != kEmpty) << (2 * u + 1);
      }
      kept = keep_pairs<Mode>(smem, table, cap, base + 64 * h + 2 * lane,
                              kept);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = h + u;
        const unsigned even = __ballot_sync(0xffffffffu,
                                            kept >> (2 * u) & 1);
        const unsigned odd = __ballot_sync(0xffffffffu,
                                           kept >> (2 * u + 1) & 1);
        // bit l of even (odd) is entry 64 i + 2 l (+ 1): interleaved,
        // words 2 i and 2 i + 1 of the warp in entry order
        const unsigned lo = spread16(even) | spread16(odd) << 1;
        const unsigned hi = spread16(even >> 16) | spread16(odd >> 16) << 1;
        if (lane == 2 * i) word = lo;
        if (lane == 2 * i + 1) word = hi;
      }
    }
  } else {
    // one entry a lane a load, 2 kLoads at a time
#pragma unroll (Mode == HAVING_NONE ? kRounds : 1)
    for (int r = 0; r < kRounds; ++r) {
      const int h = r * 2 * kLoads;
      i64 s[2 * kLoads], k[2 * kLoads];
#pragma unroll
      for (int u = 0; u < 2 * kLoads; ++u) {
        const i64 j = base + 32 * (h + u) + lane;
        s[u] = j >= n ? -1 : slots != nullptr ? slots[j] : j;
      }
#pragma unroll
      for (int u = 0; u < 2 * kLoads; ++u) {
        k[u] = s[u] >= 0 ? table[s[u]] : kEmpty;
      }
#pragma unroll
      for (int u = 0; u < 2 * kLoads; ++u) {
        bool kept = s[u] >= 0 && k[u] != kEmpty;
        if constexpr (Mode != HAVING_NONE) {
          if (kept) {
            kept = passes(smem, table, cap, s[u]);
          }
        }
        const unsigned w = __ballot_sync(0xffffffffu, kept);
        if (lane == h + u) word = w;
      }
    }
  }
  if (lane < kWarpWords) {
    keep_words[tile * kWords + warp * kWarpWords + lane] = word;
  }
  const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)__popc(word));
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  if (warp != 0) return;
  // warp 0: the tile's count, published, then its offset by look-back
  const u64 count = __reduce_add_sync(
      0xffffffffu, lane < kWarps ? warp_count[lane] : 0u);
  i64 excl = 0;
  if (tile > 0) {
    if (lane == 0) {
      store_status(status + tile, status_word(kAggregate, kEpoch, count));
    }
    excl = warp_look_back(status, tile, 1, kEpoch);
  }
  if (lane == 0) {
    store_status(status + tile,
                 status_word(kInclusive, kEpoch, (u64)excl + count));
    if (tile == n_tiles - 1) *ng = excl + (i64)count;
  }
}

// Launch 2: the kept entries of tile blockIdx.x copied to their place,
// kCopyRows rows of U entries a thread in flight at once (U = 1: many
// resident blocks for sparse tables, whose tiles keep few entries; U = 4:
// longer runs of a row a block reads at once for dense ones).
template <int U>
__global__ void __launch_bounds__(kThreads, U == 1 ? 8 : 2)
compact_copy_kernel(const i64* __restrict__ table, i64 cap, int nrows,
                    const i64* __restrict__ slots,
                    const unsigned* __restrict__ keep_words,
                    const u64* __restrict__ status, i64* __restrict__ out,
                    i64 ng) {
  __shared__ unsigned short kept[kTile];   // tile positions, entry order
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 tile = blockIdx.x;
  unsigned word = tid < kWords ? keep_words[tile * kWords + tid] : 0u;
  const u64 end = status[tile];   // inclusive: the tile's run ends here
  // exclusive prefix of the words' counts: within the warp, then across
  const int c = __popc(word);
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int pos = x - c, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  if (total == 0) return;
  while (word) {
    kept[pos++] = (unsigned short)(tid * 32 + __ffs(word) - 1);
    word &= word - 1;
  }
  __syncthreads();
  const i64 base = tile * kTile;
  i64* dst = out + (i64)(end & kCountMask) - total;
  for (int j0 = tid; j0 < total; j0 += U * kThreads) {
    i64 slot[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = j0 + q * kThreads;
      slot[q] = j >= total ? 0 : slots != nullptr ? slots[base + kept[j]]
                                                  : base + kept[j];
    }
    for (int r0 = 0; r0 < nrows; r0 += kCopyRows) {
      i64 v[kCopyRows][U];
#pragma unroll
      for (int r = 0; r < kCopyRows; ++r) {
#pragma unroll
        for (int q = 0; q < U; ++q) {
          if (r0 + r < nrows && j0 + q * kThreads < total) {
            v[r][q] = table[(i64)(r0 + r) * cap + slot[q]];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kCopyRows; ++r) {
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = j0 + q * kThreads;
          if (r0 + r < nrows && j < total) {
            dst[(i64)(r0 + r) * ng + j] = v[r][q];
          }
        }
      }
    }
  }
}

inline i64 tiles(i64 n) {
  const i64 nt = (n + kTile - 1) / kTile;
  return nt > 0 ? nt : 1;
}

}  // namespace

// meta: device int64 descriptor (groupby.py), read only when `having` is
// not 0 (its H_PRED then >= 0); table: device int64 [nrows][cap]; slots:
// device int64 [n] slot list, or null to scan all n = cap slots; words:
// device uint32 scratch of tiles(n) * 128 keep words; state: device
// uint64 [tiles(n) + 2], zeroed by the caller: the status words, the tile
// counter, then ng. Launches the mark pass on `stream`; returns
// cudaGetLastError().
extern "C" int dft_compact_mark(const void* meta, int meta_len, int having,
                                const void* table, long long cap,
                                const void* slots, long long n, void* words,
                                void* state, void* stream) {
  const i64 nt = tiles(n);
  u64* status = (u64*)state;
  const bool vec = slots == nullptr && ((uintptr_t)table & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = having != HAVING_NONE ? (size_t)meta_len * 8 : 0;
  // a slot list takes the HAVING a slot at a time
  const auto kernel =
      having == HAVING_DIRECT && vec
          ? compact_mark_kernel<HAVING_DIRECT, true>
      : having != HAVING_NONE
          ? (vec ? compact_mark_kernel<HAVING_PROGRAM, true>
                 : compact_mark_kernel<HAVING_PROGRAM, false>)
          : (vec ? compact_mark_kernel<HAVING_NONE, true>
                 : compact_mark_kernel<HAVING_NONE, false>);
  kernel<<<(unsigned)nt, kThreads, smem, st>>>(
      (const i64*)meta, meta_len, (const i64*)table, cap, (const i64*)slots,
      n, (unsigned*)words, status, status + nt, nt, (i64*)(status + nt + 1));
  return (int)cudaGetLastError();
}

// The copy pass after dft_compact_mark on the same words and state: out
// is device int64 [nrows][ng], ng the value the mark pass wrote (> 0).
extern "C" int dft_compact_copy(const void* table, long long cap, int nrows,
                                const void* slots, long long n,
                                const void* words, const void* state,
                                void* out, long long ng, void* stream) {
  const i64 nt = tiles(n);
  cudaStream_t st = (cudaStream_t)stream;
  // dense: more kept entries a tile than its threads
  if (ng > nt * kThreads) {
    compact_copy_kernel<4><<<(unsigned)nt, kThreads, 0, st>>>(
        (const i64*)table, cap, nrows, (const i64*)slots,
        (const unsigned*)words, (const u64*)state, (i64*)out, ng);
  } else {
    compact_copy_kernel<1><<<(unsigned)nt, kThreads, 0, st>>>(
        (const i64*)table, cap, nrows, (const i64*)slots,
        (const unsigned*)words, (const u64*)state, (i64*)out, ng);
  }
  return (int)cudaGetLastError();
}
