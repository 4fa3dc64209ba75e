// join_build: stage the build side of a fanout-N INNER hash join on the
// card as a multi-map in bucket order (CSR).
//
// Replaces the JAX package's build programs of DeviceJoinAggregateExec
// (datafusion_tpu/physical/plan/device_join_agg.py): build_prog (:267,
// the build hashes argsorted so that a searchsorted finds each probe's
// range), _hash_keys (:404, splitmix64 over integer keys, an FNV LUT over
// dictionary codes) and the unique dense-key LUT lut_prog (:240). Here a
// build key with one row is a bucket of one entry; it needs no second
// design.
//
// Three steps, each a grid-stride loop over the build rows:
//   1. hash: the build predicate (H_PRED) and each key program
//      (H_OFF_KEYS: program, key kind) through the program.cuh
//      interpreter. A row lives when it passes the predicate and every key
//      has a word (`join_key_word`: NULL, a NaN float key and a string code
//      absent from the other side never match). Each row's hash (-1 when
//      dead) and key words go to scratch arrays; each block counts its live
//      rows and adds them to one word. The host reads that word and takes
//      nb = next_pow2(live) buckets.
//   2. count: one atomicAdd a live row into its bucket's count, then the
//      exclusive scan of scan.cuh turns the nb + 1 counts into
//      bucket_start.
//   3. scatter: each live row takes a place in its bucket with an
//      atomicAdd on the bucket's cursor and writes its row id (int32) and
//      key words there. The order within a bucket is the atomics' order,
//      so the plain version is compared bucket by bucket as a multiset.
//
// Bounds. TPC-H partsupp at SF10 (8,000,000 rows, the build of the
// lineitem x partsupp join-aggregates) reads one or two int64 keys (8-16
// bytes a row) and writes the CSR (4 bytes of row and 8 of each key an
// entry, 8 a bucket): about 0.1 ms of traffic at the 3.35 TB/s of an
// NVIDIA H100 80GB HBM3 at 700 W. The scratch hash and key words add one
// write and one read of 16-24 bytes a row; the scattered atomics into 2^23
// buckets (64 MB, beyond the 50 MB L2) are the likely real cost.

#include "program.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Full>
__global__ void __launch_bounds__(kThreads)
join_build_hash_kernel(const i64* __restrict__ meta_g, int meta_len,
                       const i64* __restrict__ aux, i64 n_rows,
                       i64* __restrict__ hashes, i64* __restrict__ words,
                       i64* __restrict__ live) {
  extern __shared__ i64 smem[];
  __shared__ u64 block_live;
  if (threadIdx.x == 0) block_live = 0;
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  const PlainRows<Full> rows{meta, aux};
  u64 mine = 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    typename PlainRows<Full>::Columns cols;
    i64 w[kMaxJoinKeys];
    bool ok = rows(row, &cols);
    for (int k = 0; ok && k < n_keys; ++k) {
      i64 x;
      const bool valid = run(meta, aux, (int)keys[3 * k], row, cols, &x);
      ok = join_key_word((int)keys[3 * k + 1], valid, x, &w[k]);
    }
    if (!ok) {
      hashes[row] = -1;
      continue;
    }
    for (int k = 0; k < n_keys; ++k) words[(i64)k * n_rows + row] = w[k];
    hashes[row] = join_hash(w, n_keys);
    ++mine;
  }
  if (mine) atomicAdd(&block_live, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_live) atomicAdd((u64*)live, block_live);
}

__global__ void __launch_bounds__(kThreads)
join_build_count_kernel(const i64* __restrict__ hashes, i64 n_rows, i64 nb,
                        u64* __restrict__ counts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    const i64 h = hashes[row];
    if (h >= 0) atomicAdd(&counts[h & (nb - 1)], 1ull);
  }
}

__global__ void __launch_bounds__(kThreads)
join_build_scatter_kernel(const i64* __restrict__ hashes,
                          const i64* __restrict__ words, int n_keys,
                          i64 n_rows, i64 nb, const i64* __restrict__ start,
                          u64* __restrict__ cursor, i64 live,
                          int* __restrict__ rows_out,
                          i64* __restrict__ keys_out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    const i64 h = hashes[row];
    if (h < 0) continue;
    const i64 b = h & (nb - 1);
    const i64 at = start[b] + (i64)atomicAdd(&cursor[b], 1ull);
    rows_out[at] = (int)row;
    for (int k = 0; k < n_keys; ++k) {
      keys_out[(i64)k * live + at] = words[(i64)k * n_rows + row];
    }
  }
}

}  // namespace

// Step 1. meta: device int64 descriptor of meta_len words (join_agg.py
// JoinBuildSpec); aux: device int64 per-batch inputs; hashes: device int64
// [n_rows]; words: device int64 [n_keys * n_rows]; live: one device int64,
// zeroed by the caller, gets the live row count; full: the programs need
// the interpreter's full variant. Returns cudaGetLastError().
extern "C" int dft_join_build_hash(const void* meta, int meta_len,
                                   const void* aux, long long n_rows,
                                   void* hashes, void* words, void* live,
                                   int full, void* stream) {
  const auto kernel = full ? join_build_hash_kernel<true>
                           : join_build_hash_kernel<false>;
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (i64*)hashes,
      (i64*)words, (i64*)live);
  return (int)cudaGetLastError();
}

// Step 2. start: device int64 [nb + 1] zeroed by the caller, ends as the
// bucket starts (start[nb] = the live rows); sums: scratch of
// scan_tiles(nb + 1) words. Four launches.
extern "C" int dft_join_build_offsets(const void* hashes, long long n_rows,
                                      long long nb, void* start, void* sums,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  join_build_count_kernel<<<grid_blocks(n_rows, kThreads), kThreads, 0,
                            st>>>((const i64*)hashes, n_rows, nb,
                                  (u64*)start);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)exclusive_scan((i64*)start, nb + 1, (i64*)sums, st);
}

// Step 3. cursor: device int64 [nb] zeroed by the caller; rows: device
// int32 [live]; keys: device int64 [n_keys * live].
extern "C" int dft_join_build_scatter(const void* hashes, const void* words,
                                      int n_keys, long long n_rows,
                                      long long nb, const void* start,
                                      void* cursor, long long live,
                                      void* rows, void* keys, void* stream) {
  join_build_scatter_kernel<<<grid_blocks(n_rows, kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const i64*)hashes, (const i64*)words, n_keys, n_rows, nb,
      (const i64*)start, (u64*)cursor, live, (int*)rows, (i64*)keys);
  return (int)cudaGetLastError();
}
