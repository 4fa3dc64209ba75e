// join_aggregate: the probe of a fanout-N INNER hash join fused with the
// grouped aggregate, one thread per probe row; the joined pairs are never
// materialised.
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
// Per probe row, a grid-stride loop: the probe predicate and the probe key
// programs over the pair space (their columns are probe columns), the key
// words and their hash (program.cuh `join_key_word`, `join_hash`, the
// build's rule), then the walk of the row's bucket in the CSR of
// join_build.cu: each entry whose key words all equal the row's is a pair.
// For each pair the loader `PairColumns` reads build columns at the
// entry's build row and probe columns at the probe row; the residual
// (H_PRED) runs, and the pair folds with the row bodies of the aggregate
// kernels: `dense_fold_row` into a shared table of G <= 64 slots merged at
// the end, or `hash_fold_row` into the global hash table. The output table
// has their layout, so compact_groups, top-k and the emit run unchanged.
// A hot key's pairs run serially in one thread.
//
// Bounds. TPC-H lineitem x partsupp on the part key at SF10: 59,997,665
// probe rows of 16 bytes (l_partkey, l_quantity), 8,000,000 build rows
// read through their CSR entries (the bucket starts, a row and a key word
// an entry, the payload ps_suppkey and ps_supplycost), 239,990,660 pairs
// folded into ps_suppkey's 100,000 identity slots: about 1.2 GB, 0.35 ms
// at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W. The bucket walk
// and the build payloads are random reads into tables beyond the 50 MB L2,
// and the fold's atomics land on 100,000 slots.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

// the join section of a descriptor (join_agg.py JoinAggSpec)
enum { J_NBUILD, J_PPRED, J_NKEYS, J_BUCKETS, J_START, J_ROWS, J_KEYS,
       J_LIVE, J_KEY0 };

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
  const i64 nb = js[J_BUCKETS], live = js[J_LIVE];
  const i64* start = (const i64*)js[J_START];
  const int* brows = (const int*)js[J_ROWS];
  const i64* bkeys = (const i64*)js[J_KEYS];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_probe;
       row += stride) {
    PairColumns<Full> cols{meta + meta[H_OFF_COLS], js[J_NBUILD], -1};
    i64 x;
    if (js[J_PPRED] >= 0 &&
        !(run(meta, aux, (int)js[J_PPRED], row, cols, &x) && x != 0)) {
      continue;
    }
    i64 w[kMaxJoinKeys];
    bool ok = true;
    for (int k = 0; ok && k < n_keys; ++k) {
      const bool valid = run(meta, aux, (int)js[J_KEY0 + 2 * k], row, cols,
                             &x);
      ok = join_key_word((int)js[J_KEY0 + 2 * k + 1], valid, x, &w[k]);
    }
    if (!ok) continue;
    const i64 b = join_hash(w, n_keys) & (nb - 1);
    const i64 end = __ldg((const long long*)start + b + 1);
    for (i64 e = __ldg((const long long*)start + b); e < end; ++e) {
      bool match = true;
      for (int k = 0; match && k < n_keys; ++k) {
        match = __ldg((const long long*)bkeys + (i64)k * live + e) == w[k];
      }
      if (!match) continue;
      cols.brow = __ldg(brows + e);
      if (meta[H_PRED] >= 0 &&
          !(run(meta, aux, (int)meta[H_PRED], row, cols, &x) && x != 0)) {
        continue;
      }
      if (Dense) {
        dense_fold_row(meta, aux, row, cols, tab);
      } else {
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
