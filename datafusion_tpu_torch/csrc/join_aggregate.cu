// join_aggregate: the probe of a fanout-N INNER hash join fused with the
// grouped aggregate; the joined pairs are never materialised.
//
// Replaces the JAX package's probe programs of DeviceJoinAggregateExec
// (datafusion_tpu/physical/plan/device_join_agg.py): count_prog (:573,
// each probe's range by searchsorted over the sorted build hashes and the
// pair total), expand_prog (:615, the pairs expanded into a speculative
// bucketed capacity, the exact key check), the capacity cache _CAP_CACHE
// (:68) with its -3 poison retry (:301-327), dense_prog (:530, the unique
// dense-key route) and pair_tail (:475, the residual, the key packing and
// device_group_aggregate). With no pair array there is no pair count to
// read back, no capacity to guess and nothing to retry.
//
// Design: a warp probes 32 rows together and shares their buckets.
//   1. Each lane takes one probe row (32 consecutive rows a warp step): the
//      probe predicate and key programs over the pair space (their columns
//      are probe columns), the key words and their hash (program.cuh
//      `join_key_word`, `join_hash`, the build's rule), and the row's
//      bucket range in the int32 bucket starts of join_build.cu. The 32
//      rows' loads are in flight together.
//   2. An inclusive warp scan of the bucket lengths lays the warp's
//      entries out end to end. The warp then walks them 32 a step, one a
//      lane: a lane finds the probe row that owns its entry by a binary
//      search of the scan (five shuffles) and reads the owner's key words
//      and bucket offset by shuffles. A bucket's entries are consecutive
//      records, so a step's reads are coalesced, and a hot key's bucket is
//      shared by every lane of the warp instead of walked by one thread.
//   3. An entry whose key words all equal its owner's is a pair. Its
//      record (join_build.cu) holds the build columns the programs read,
//      so the loader `PairColumns` reads them at the record (row handle
//      entry x record words, the columns' descriptors pointing into the
//      records) and probe columns at the owner's row: one or two adjacent
//      sectors a match, instead of a key, a row and one random read a
//      payload column. The residual (H_PRED) runs, then the pair folds with
//      the aggregate kernels' row bodies: `dense_fold_warp` (the step's
//      pairs reduced across the warp before one shared update a slot and
//      lane; G <= 64, merged at the end) or `hash_fold_row` into the global
//      hash table. The output table has their layout, so compact_groups,
//      top-k and the emit run unchanged.
//
// Bounds. TPC-H lineitem x partsupp on the part key at SF10: 59,997,665
// probe rows of 16 bytes (l_partkey, l_quantity), the 8,000,000 build
// entries' 24-byte records (the key, ps_suppkey, ps_supplycost) and their
// 32 MB of bucket starts read once, 239,990,660 pairs folded into
// ps_suppkey's 100,000 identity slots: about 1.2 GB, 0.35 ms at the
// 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W. A probe row's bucket is a
// random read (its records beyond the 50 MB L2), and each pair makes its
// hash fold's global atomics (three for J1) on the slot of its build row.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

// the join section of a descriptor (join_agg.py Join.section)
enum { J_NBUILD, J_PPRED, J_NKEYS, J_BUCKETS, J_START, J_REC, J_WIDTH,
       J_LIVE, J_KEY0 };

// The key words of probe row `row` to w; false when the row fails the
// probe predicate or can match nothing.
template <class Columns>
__device__ __forceinline__ bool probe_words(const i64* meta, const i64* aux,
                                            const i64* js, i64 row,
                                            const Columns& cols, i64* w) {
  i64 x;
  if (js[J_PPRED] >= 0 &&
      !(run(meta, aux, (int)js[J_PPRED], row, cols, &x) && x != 0)) {
    return false;
  }
  const int n_keys = (int)js[J_NKEYS];
  for (int k = 0; k < n_keys; ++k) {
    const bool valid = run(meta, aux, (int)js[J_KEY0 + 2 * k], row, cols, &x);
    if (!join_key_word((int)js[J_KEY0 + 2 * k + 1], valid, x, &w[k])) {
      return false;
    }
  }
  return true;
}

template <bool Full, bool Dense>
__global__ void __launch_bounds__(kThreads)
join_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                      const i64* __restrict__ aux, i64 n_probe, i64 cap,
                      int identity_slots, i64* __restrict__ table,
                      int* __restrict__ overflow) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  u64* tab = (u64*)(smem + meta_len);
  if (Dense) dense_init(meta, tab);
  const i64* js = meta + meta[H_OFF_CHAIN];
  const int n_keys = (int)js[J_NKEYS];
  const i64 nb = js[J_BUCKETS];
  const int* start = (const int*)js[J_START];
  const long long* rec = (const long long*)js[J_REC];
  const i64 words = js[J_WIDTH];
  const int lane = lane_id();
  const i64 width = __popc(warp_members());
  const i64 per_block = (blockDim.x + 31) >> 5;
  const i64 warps = (i64)gridDim.x * per_block;
  for (i64 row0 = ((i64)blockIdx.x * per_block + (threadIdx.x >> 5)) * width;
       row0 < n_probe; row0 += warps * width) {
    // 1. this lane's probe row and its bucket
    PairColumns<Full> cols{meta + meta[H_OFF_COLS], js[J_NBUILD], -1};
    i64 w[kMaxJoinKeys] = {0, 0, 0, 0};
    i64 begin = 0, len = 0;
    if (row0 + lane < n_probe &&
        probe_words(meta, aux, js, row0 + lane, cols, w)) {
      const i64 b = join_hash(w, n_keys) & (nb - 1);
      begin = __ldg(start + b);
      len = __ldg(start + b + 1) - begin;
    }
    // 2. the warp's entries end to end: incl = the entries of lanes <= this
    i64 incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const i64 t = __shfl_up_sync(kWarp, incl, o);
      if (lane >= o) incl += t;
    }
    const i64 total = __shfl_sync(kWarp, incl, (int)width - 1);
    const i64 delta = begin - (incl - len);   // walk index -> entry
    for (i64 s = 0; s < total; s += width) {
      const i64 i = s + lane;
      // the owner: the number of lanes whose entries end at or before i
      int owner = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kWarp, incl, owner + step - 1) <= i) owner += step;
      }
      const i64 e = i + __shfl_sync(kWarp, delta, owner);
      bool pair = i < total;
#pragma unroll
      for (int k = 0; k < kMaxJoinKeys; ++k) {
        if (k < n_keys) {
          const i64 want = __shfl_sync(kWarp, w[k], owner);
          if (pair) pair = __ldg(rec + e * words + k) == want;
        }
      }
      // 3. the pair: build columns at its record, probe columns at the row
      const i64 row = row0 + owner;
      cols.brow = e * words;
      if (pair && meta[H_PRED] >= 0) {
        i64 x;
        pair = run(meta, aux, (int)meta[H_PRED], row, cols, &x) && x != 0;
      }
      if (Dense) {
        dense_fold_warp(meta, aux, pair, row, cols, tab);
      } else if (pair) {
        hash_fold_row(meta, aux, row, cols, cap, identity_slots, table,
                      overflow);
      }
    }
  }
  if (Dense) dense_merge(meta, tab, (u64*)table);
}

}  // namespace

// meta: device int64 descriptor of meta_len words with its join section
// (join_agg.py); aux: device int64 per-batch inputs of the pair space.
// mode 0: the dense table int64 [n_lanes + 1][groups] (cap unused); mode 1
// (the packed key is the slot) and 2 (probed): the hash table int64
// [all lanes + 2][cap] and the int32 overflow flag; full: the programs
// need the interpreter's full variant. n_lanes is this pass's. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dft_join_aggregate(const void* meta, int meta_len,
                                  int n_lanes, int groups, const void* aux,
                                  long long n_probe, long long cap, int mode,
                                  void* table, void* overflow, int full,
                                  void* stream) {
  const unsigned blocks = grid_blocks(n_probe, kThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    const size_t smem = (size_t)(meta_len + (n_lanes + 1) * groups) * 8;
    const auto kernel = full ? join_aggregate_kernel<true, true>
                             : join_aggregate_kernel<false, true>;
    kernel<<<blocks, kThreads, smem, st>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_probe, 0, 0,
        (i64*)table, (int*)overflow);
  } else {
    const auto kernel = full ? join_aggregate_kernel<true, false>
                             : join_aggregate_kernel<false, false>;
    kernel<<<blocks, kThreads, (size_t)meta_len * 8, st>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_probe, cap,
        mode == 1 ? 1 : 0, (i64*)table, (int*)overflow);
  }
  return (int)cudaGetLastError();
}
