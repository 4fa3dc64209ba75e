// chain_build: stage one build side of a fanout-1 join chain on the card.
//
// Replaces the JAX package's build staging for DeviceJoinChainAggregateExec
// (datafusion_tpu/physical/plan/device_join_chain.py):
//   - _unfiltered_lut (:177), the direct-address table lut[packed - base] =
//     build row, -1 absent;
//   - the per-query mask LUT (:638-650), which folds a build predicate in;
//   - the host sorted-key packing (:657-711) and its duplicate check;
//   - _stage_build_device (:1069, jits :1110 min/max and :1144 sort);
//   - _stage_semi_member_lut (:1158, jit :1297), the SEMI/ANTI presence
//     table (not its min/max variant).
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
//        at most 16 x rows and 2^26: one atomicCAS from -1 per row; a CAS
//        that finds another row marks a duplicate key;
//      - otherwise an open-addressing table of (int64 key, int32 row) of 2 x
//        next_pow2(rows) slots, claimed with atomicCAS as the hash group-by
//        does; a key found already present marks a duplicate.
//   An INNER build with a duplicate key has fanout > 1: the exec reads the
//   flag once and runs its host plan. SEMI and ANTI builds need presence
//   only and ignore it.
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

// The key values of an admitted build row, or false when a key is NULL.
__device__ __forceinline__ bool build_keys(const i64* meta, const i64* aux,
                                           i64 row, const RowColumns& cols,
                                           i64* v) {
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  for (int k = 0; k < n_keys; ++k) {
    if (!run(meta, aux, (int)keys[3 * k], row, cols, &v[k])) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
chain_build_range_kernel(const i64* __restrict__ meta_g, int meta_len,
                         const i64* __restrict__ aux, i64 n_rows,
                         i64* __restrict__ stats) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_keys = (int)meta[H_NKEYS];
  const PlainRows rows{meta, aux};
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
    RowColumns cols;
    i64 v[kMaxHopKeys];
    if (!rows(row, &cols) || !build_keys(meta, aux, row, cols, v)) continue;
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

__global__ void __launch_bounds__(kThreads)
chain_build_insert_kernel(const i64* __restrict__ meta_g, int meta_len,
                          const i64* __restrict__ aux, i64 n_rows, int kind,
                          i64 size, int* __restrict__ table,
                          i64* __restrict__ keys_tab, int* __restrict__ dup) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];   // (prog, lo, shift) per key
  const PlainRows rows{meta, aux};
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    RowColumns cols;
    i64 v[kMaxHopKeys];
    if (!rows(row, &cols) || !build_keys(meta, aux, row, cols, v)) continue;
    i64 packed = 0;
    for (int k = 0; k < n_keys; ++k) {
      packed |= (v[k] - keys[3 * k + 1]) << keys[3 * k + 2];
    }
    if (kind == TAB_DIRECT) {
      if (atomicCAS(table + packed, -1, (int)row) != -1) *dup = 1;
      continue;
    }
    bool fresh = false;
    const i64 slot = claim_slot(keys_tab, size, packed, &fresh);
    if (slot < 0) {
      *dup = 2;   // cannot happen: the table has 2 x rows slots
    } else if (fresh) {
      table[slot] = (int)row;
    } else {
      *dup = 1;
    }
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py,
// BuildSpec); aux: device int64 per-batch inputs; stats: device int64
// [1 + 2 * keys], set by the caller to (0, INT64_MAX, INT64_MIN, ...).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_chain_build_range(const void* meta, int meta_len,
                                     const void* aux, long long n_rows,
                                     void* stats, void* stream) {
  chain_build_range_kernel<<<grid_blocks(n_rows, kThreads), kThreads,
                             (size_t)meta_len * 8, (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (i64*)stats);
  return (int)cudaGetLastError();
}

// kind: TAB_DIRECT (table: int32 [size], -1) or TAB_HASH (table: int32 rows
// [size], keys: int64 [size], EMPTY); dup: device int32 flag, set to 1 when
// a key has two rows. Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_chain_build_insert(const void* meta, int meta_len,
                                      const void* aux, long long n_rows,
                                      int kind, long long size, void* table,
                                      void* keys, void* dup, void* stream) {
  chain_build_insert_kernel<<<grid_blocks(n_rows, kThreads), kThreads,
                              (size_t)meta_len * 8, (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, kind, size,
      (int*)table, (i64*)keys, (int*)dup);
  return (int)cudaGetLastError();
}
