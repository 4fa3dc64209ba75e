// chain_build: stage one build side of a fanout-1 join chain on the card.
//
// Replaces the JAX package's build staging for DeviceJoinChainAggregateExec
// (datafusion_tpu/physical/plan/device_join_chain.py):
//   - _unfiltered_lut (:177), the direct-address table lut[packed - base] =
//     build row, -1 absent;
//   - the per-query mask LUT `masklut` (:632-652, jit :643), which masks
//     a cached unfiltered table by this query's build predicate
//     (chain_mask_kernel);
//   - the host sorted-key packing (:657-711) and its duplicate check;
//   - _stage_build_device (:1069, jits :1110 min/max and :1144 sort);
//   - _stage_semi_member_lut (:1158, jit :1297), the SEMI/ANTI presence
//     table and, for a filtered SEMI/ANTI (`member_col OP probe_expr`,
//     TPC-H Q21), its min/max variant (:1170-1300): the min and max of the
//     member column over the build rows of each key.
// The reference evaluates an INNER build's predicate in host numpy
// (:618-621) and scans the key columns' min and max on the host; here both
// run on the card.
//
// Two passes over the build rows, each a grid-stride loop that runs the
// build predicate (H_PRED) and the key programs (H_OFF_KEYS) with the
// program.cuh interpreter. A row counts when it passes the predicate and
// every key is valid: NULL keys are never inserted.
//   1. range: the live row count and each key's min and max. Each thread
//      folds its rows in registers, a warp folds its threads with shuffles,
//      and one atomic per warp and word reaches global memory.
//   2. insert, once the host has read the ranges and laid the table out:
//      the keys pack as sum((v_k - lo_k) << shift_k), then
//      - a direct-address int32 table (row or -1) when the packed span is
//        at most 16 x rows and 2^26: one atomicCAS from -1 a key; a CAS
//        that finds another row marks a duplicate key;
//      - otherwise an open-addressing table of (int64 key, int32 row) of 2 x
//        next_pow2(rows) slots, claimed with atomicCAS as the hash group-by
//        does; a key found already present marks a duplicate.
//      A warp takes 32 consecutive rows a step and the rows of one packed
//      key are peers: the lowest inserts for the set, and a set of two or
//      more is a duplicate (chain_build_insert_kernel).
//   An INNER build with a duplicate key has fanout > 1: the exec reads the
//   flag once and runs its host plan. SEMI and ANTI builds need presence
//   only: they keep any one row of a key, stored without a CAS on a direct
//   table, and have no flag.
// A min/max build (the descriptor's one lane: the member column's program)
// also needs the member valid for a row to count, and folds each live
// row's member value into int64 min and max arrays aligned with the table
// (INT64_MAX / INT64_MIN where empty): the peers' values reduce in the warp,
// then one atomicMin and one atomicMax a set. Its table is laid out by the
// same rule as every other build.
//
// TPC-H's lineitem is sorted by l_orderkey with about 4 rows an order, so a
// warp's 32 rows of Q4's and Q21's builds over it meet about 8 keys: the
// row-at-a-time insert made 4 serialised atomics of each kind on each, the
// peers make one.
//
// The mask (chain_mask_kernel). An INNER table staged once without its
// build predicate (unique non-null integer keys of a bounded span, the
// reference's `_unfiltered_lut`) is kept across queries; each use masks it
// by the query's predicate into a new table of the same layout: one thread
// a slot reads the slot's row r and, when r >= 0, tests the predicate at
// build row r through its conjuncts (program.cuh `conjunct_test`, a
// program conjunct through `run`), then writes r or -1. It reads nothing
// back. About 8 bytes a slot plus the predicate's columns at the live
// rows: TPC-H customer at SF10 (2^21 span, 1.5M rows) is about 13.5 MB,
// 4 us at 3.35 TB/s, so at TPC-H's sizes its launch is the cost.
//
// Bounds. TPC-H orders at SF10 (15M rows, the largest build of Q3 and Q5)
// read o_orderkey and the predicate's o_orderdate (12 bytes a row, 180 MB)
// in each pass and write a 240 MB direct table once (60M slots of int32):
// about 0.18 ms of reads and 0.07 ms of writes at the 3.35 TB/s of an
// NVIDIA H100 80GB HBM3 at 700 W. The scattered CAS into a table larger
// than the 50 MB L2 is the likely real cost.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

// The key values of an admitted build row and, for a min/max build, its
// member value to *member; false when a key or the member is NULL.
template <class Columns>
__device__ __forceinline__ bool build_keys(const i64* meta, const i64* aux,
                                           i64 row, const Columns& cols,
                                           i64* v, i64* member) {
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  for (int k = 0; k < n_keys; ++k) {
    if (!run(meta, aux, (int)keys[3 * k], row, cols, &v[k])) return false;
  }
  if (meta[H_NLANES] == 0) return true;
  const i64* lanes = meta + meta[H_OFF_LANES];
  return run(meta, aux, (int)lanes[0], row, cols, member);
}

template <bool Full>
__global__ void __launch_bounds__(kThreads)
chain_build_range_kernel(const i64* __restrict__ meta_g, int meta_len,
                         const i64* __restrict__ aux, i64 n_rows,
                         i64* __restrict__ stats) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_keys = (int)meta[H_NKEYS];
  const PlainRows<Full> rows{meta, aux};
  i64 lo[kMaxHopKeys], hi[kMaxHopKeys];
  long long live = 0;
#pragma unroll
  for (int k = 0; k < kMaxHopKeys; ++k) {
    lo[k] = INT64_MAX;
    hi[k] = INT64_MIN;
  }
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    RowColumns<Full> cols;
    i64 v[kMaxHopKeys], member;
    if (!rows(row, &cols) || !build_keys(meta, aux, row, cols, v, &member)) {
      continue;
    }
    ++live;
    for (int k = 0; k < n_keys; ++k) {
      lo[k] = v[k] < lo[k] ? v[k] : lo[k];
      hi[k] = v[k] > hi[k] ? v[k] : hi[k];
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    live += __shfl_down_sync(0xffffffffu, live, off);
    for (int k = 0; k < n_keys; ++k) {
      const i64 l = __shfl_down_sync(0xffffffffu, lo[k], off);
      const i64 h = __shfl_down_sync(0xffffffffu, hi[k], off);
      lo[k] = l < lo[k] ? l : lo[k];
      hi[k] = h > hi[k] ? h : hi[k];
    }
  }
  if ((threadIdx.x & 31) == 0 && live > 0) {
    atomicAdd((u64*)&stats[0], (u64)live);
    for (int k = 0; k < n_keys; ++k) {
      atomicMin((long long*)&stats[1 + 2 * k], lo[k]);
      atomicMax((long long*)&stats[2 + 2 * k], hi[k]);
    }
  }
}

// The lowest peer's insert for a set of n_peers rows of one packed key
// (lo and hi: the set's extremes of the member; row: the lowest's row).
__device__ __forceinline__ void insert_set(int kind, i64 size, int* table,
                                           i64* keys_tab, i64* mn, i64* mx,
                                           int* dup, i64 row, i64 packed,
                                           int n_peers, i64 lo, i64 hi) {
  if (dup != nullptr && n_peers > 1) *dup = 1;
  i64 slot = packed;
  if (kind == TAB_DIRECT) {
    if (dup == nullptr) {
      table[packed] = (int)row;
    } else if (atomicCAS(table + packed, -1, (int)row) != -1) {
      *dup = 1;
    }
  } else {
    bool fresh = false;
    slot = claim_slot(keys_tab, size, packed, &fresh);
    if (slot < 0) {   // cannot happen: the table has 2 x rows slots
      if (dup != nullptr) *dup = 2;
      return;
    }
    if (fresh) {
      table[slot] = (int)row;
    } else if (dup != nullptr) {
      *dup = 1;
    }
  }
  if (mn != nullptr) {
    atomicMin((long long*)mn + slot, lo);
    atomicMax((long long*)mx + slot, hi);
  }
}

// The insert pass. A warp takes 32 consecutive build rows a step; the rows
// that share a packed key are peers (__match_any_sync on the 64-bit key),
// and the lowest peer inserts for all of them (`insert_set`): one
// atomicCAS on a direct table or one claim of a hashed slot a key and
// step. Two peers already prove a duplicate key (no atomic needed to find
// it); a SEMI/ANTI build (dup null) needs any one row of a key, so on a
// direct table the lowest peer stores its row with no CAS; a min/max build
// reduces the peers' member values over the set (`reduce_peers`) before
// one atomicMin and one atomicMax. Once a block's keys seldom meet in a
// warp (kMatchGiveUp, as hash_fold_warps counts: a unique key, such as
// TPC-H's orders, meets no peer), its warps stop matching and each row
// inserts for itself, as before, with no warp-wide step to wait for.
template <bool Full>
__global__ void __launch_bounds__(kThreads)
chain_build_insert_kernel(const i64* __restrict__ meta_g, int meta_len,
                          const i64* __restrict__ aux, i64 n_rows, int kind,
                          i64 size, int* __restrict__ table,
                          i64* __restrict__ keys_tab, i64* __restrict__ mn,
                          i64* __restrict__ mx, int* __restrict__ dup) {
  extern __shared__ i64 smem[];
  __shared__ int unmatched;   // the block's match debt
  if (threadIdx.x == 0) unmatched = 0;
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];   // (prog, lo, shift) per key
  const PlainRows<Full> rows{meta, aux};
  const int lane = lane_id();
  const i64 per_block = (blockDim.x + 31) >> 5;
  const i64 width = __popc(warp_members());
  const i64 stride = (i64)gridDim.x * per_block * width;
  // solo: the block gave matching up (the same in every lane); each row
  // then inserts for itself, with no warp-wide step to wait for
  bool solo = false;
  for (i64 row = ((i64)blockIdx.x * per_block + (threadIdx.x >> 5)) * width +
                 lane;
       row - lane < n_rows; row += stride) {
    if (!solo) {   // the block's state as lane 0 reads it
      solo = __shfl_sync(kWarp, *(volatile int*)&unmatched, 0) >=
             kMatchGiveUp;
    }
    RowColumns<Full> cols;
    i64 v[kMaxHopKeys], member = 0, packed = -1;
    const bool adm = row < n_rows && rows(row, &cols) &&
                     build_keys(meta, aux, row, cols, v, &member);
    if (adm) {
      packed = 0;
      for (int k = 0; k < n_keys; ++k) {
        packed |= (v[k] - keys[3 * k + 1]) << keys[3 * k + 2];
      }
    }
    if (solo) {
      if (adm) {
        insert_set(kind, size, table, keys_tab, mn, mx, dup, row, packed, 1,
                   member, member);
      }
      continue;
    }
    const unsigned admitted = __ballot_sync(kWarp, adm);
    if (admitted == 0) continue;
    // a row not admitted is a set of its own; with no row in another's
    // set, peers is 0 in every lane and the step reduces nothing
    const unsigned match = __match_any_sync(kWarp, (u64)packed);
    unsigned peers = adm ? match : 1u << lane;
    const int joined =
        __popc(admitted) -
        __popc(__ballot_sync(kWarp, adm && lane == __ffs(peers) - 1));
    if (lane == 0) atomicAdd(&unmatched, 1 - 2 * joined);
    if (joined == 0) peers = 0;
    i64 lo = member, hi = member;
    if (mn != nullptr && peers != 0) {
      lo = reduce_peers(LANE_MIN_I64, peers, member);
      hi = reduce_peers(LANE_MAX_I64, peers, member);
    }
    if (adm && (peers == 0 || lane == __ffs(peers) - 1)) {
      insert_set(kind, size, table, keys_tab, mn, mx, dup, row, packed,
                 peers == 0 ? 1 : __popc(peers), lo, hi);
    }
  }
}

// Whether build row `row` passes the n conjuncts at cj (four words each,
// join_chain.py MaskSpec): every one valid and true, as the Kleene AND of
// them all would leave it.
template <class Columns>
__device__ __forceinline__ bool mask_passes(const i64* meta, const i64* aux,
                                            const i64* cj, int n, i64 row,
                                            const Columns& cols) {
  for (int c = 0; c < n; ++c, cj += kConjWords) {
    i64 x;
    if ((int)cj[0] == CJ_PROG) {
      if (!(run(meta, aux, (int)cj[1], row, cols, &x) && x != 0)) {
        return false;
      }
    } else if (!(cols(cj[1], row, &x) &&
                 conjunct_test(meta, aux, cj, x, row, cols))) {
      return false;
    }
  }
  return true;
}

// The mask: slot s of `out` is rows_in[s] where the predicate holds at
// that build row, else -1 (a grid-stride loop over the slots).
template <bool Full>
__global__ void __launch_bounds__(kThreads)
chain_mask_kernel(const i64* __restrict__ meta_g, int meta_len,
                  const i64* __restrict__ aux, i64 size,
                  const int* __restrict__ rows_in, int* __restrict__ out) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const i64* conj = meta + meta[H_OFF_CHAIN];
  const int n_conj = (int)conj[0];
  const RowColumns<Full> cols{meta + meta[H_OFF_COLS]};
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < size;
       s += stride) {
    const int r = __ldg(rows_in + s);
    out[s] = r >= 0 && mask_passes(meta, aux, conj + 1, n_conj, r, cols)
                 ? r
                 : -1;
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py,
// BuildSpec); aux: device int64 per-batch inputs; stats: device int64
// [1 + 2 * keys], set by the caller to (0, INT64_MAX, INT64_MIN, ...);
// full: the programs need the interpreter's full variant. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dft_chain_build_range(const void* meta, int meta_len,
                                     const void* aux, long long n_rows,
                                     void* stats, int full, void* stream) {
  const auto kernel = full ? chain_build_range_kernel<true>
                           : chain_build_range_kernel<false>;
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (i64*)stats);
  return (int)cudaGetLastError();
}

// kind: TAB_DIRECT (table: int32 [size], -1) or TAB_HASH (table: int32 rows
// [size], keys: int64 [size], EMPTY); mn, mx: int64 [size] at INT64_MAX and
// INT64_MIN for a min/max build, else null; dup: an INNER build's device
// int32 flag, set to 1 when a key has two rows, or null for a SEMI/ANTI
// build, which keeps any one row of a key; full as in
// dft_chain_build_range. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dft_chain_build_insert(const void* meta, int meta_len,
                                      const void* aux, long long n_rows,
                                      int kind, long long size, void* table,
                                      void* keys, void* mn, void* mx,
                                      void* dup, int full, void* stream) {
  const auto kernel = full ? chain_build_insert_kernel<true>
                           : chain_build_insert_kernel<false>;
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, kind, size,
      (int*)table, (i64*)keys, (i64*)mn, (i64*)mx, (int*)dup);
  return (int)cudaGetLastError();
}

// meta: device int64 descriptor of meta_len words (join_chain.py,
// MaskSpec: the build predicate's conjuncts in its last section); aux:
// device int64 per-batch inputs; rows_in: the unfiltered table's int32
// rows of `size` slots (-1 absent), not written; out: int32 [size]; full
// as in dft_chain_build_range. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dft_chain_mask(const void* meta, int meta_len, const void* aux,
                              long long size, const void* rows_in, void* out,
                              int full, void* stream) {
  const auto kernel = full ? chain_mask_kernel<true>
                           : chain_mask_kernel<false>;
  kernel<<<grid_blocks(size, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, size, (const int*)rows_in,
      (int*)out);
  return (int)cudaGetLastError();
}
