// fused_dense_aggregate: filter, key packing, value lanes and dense-slot
// group aggregation in one pass over the rows.
//
// Replaces the JAX package's one jitted XLA program for the dense path of
// a grouped aggregate: DeviceGroupAggregateExec._make_step.prepare
// (datafusion_tpu/physical/plan/device_aggregate.py:679) fused with
// _dense_group_aggregate (datafusion_tpu/device/groupby.py:70), and the
// emit packer _fetch_state (device_aggregate.py:1017): the result is one
// [lanes + 1][G] int64 table (float lanes hold float64 bits) that a single
// device-to-host copy brings back.
//
// Design. Every expression (predicate, each group key, each lane argument)
// arrives as a small stack program compiled on the host
// (datafusion_tpu_torch/device/lower.py). The kernel copies the whole
// descriptor (programs, constants, column pointers) into shared memory,
// walks the rows with a grid-stride loop, interprets the programs once per
// row on a stack of (64-bit value, valid bit) entries, and folds each lane
// into a per-block [lanes + 1][G] table in shared memory (G <= 64 slots,
// lanes <= 32: at most 16.9 KB). At the end each block merges its table
// into the global table with atomics, so any number of batches can
// accumulate into one table without a separate merge program.
//
// Bounds. TPC-H Q1 reads 44 bytes a row (four int64 decimals, three int32
// columns); at SF10 (60,012,150 rows) that is about 2.6 GB, roughly 0.8 ms
// at the 3.35 TB/s data-sheet peak of an NVIDIA H100 80GB HBM3 at its
// 700 W limit. The likely real limit is the shared-memory
// atomics: Q1 has only 4 live groups among its 32 slots, so the 12 atomic
// updates of each row land on a few hot addresses and serialize within a
// warp. Warp-level pre-aggregation (__match_any_sync) is the next step.
//
// Exactness. Integer and decimal lanes are exact in any order (64-bit
// two's-complement adds wrap the same way). Float sums are atomics, so
// their order changes from run to run; callers compare them within a
// relative tolerance. The interpreter, the lane folds and the row body
// (`dense_fold`) live in program.cuh, shared with the hash group-by and the
// join-chain kernels.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_dense_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                             const i64* __restrict__ aux, i64 n_rows,
                             u64* __restrict__ table_g) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  dense_fold(smem, aux, n_rows, (u64*)(smem + meta_len), table_g,
             PlainRows{smem, aux});
}

}  // namespace

// meta: device int64 descriptor of meta_len words (see groupby.py);
// aux: device int64 per-batch inputs; table: device int64
// [n_lanes + 1][groups], filled with each lane's identity by the caller.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_fused_dense_aggregate(const void* meta, int meta_len,
                                         int n_lanes, int groups,
                                         const void* aux, long long n_rows,
                                         void* table, void* stream) {
  const size_t smem = (size_t)(meta_len + (n_lanes + 1) * groups) * 8;
  fused_dense_aggregate_kernel<<<grid_blocks(n_rows, kThreads), kThreads,
                                 smem, (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (u64*)table);
  return (int)cudaGetLastError();
}
