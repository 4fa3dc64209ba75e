// fused_dense_aggregate: filter, key packing, value lanes and dense-slot
// group aggregation in one pass over the rows.
//
// Replaces the JAX package's one jitted XLA program for the dense path of
// a grouped aggregate: DeviceGroupAggregateExec._make_step.prepare
// (datafusion_tpu/physical/plan/device_aggregate.py:679) fused with
// _dense_group_aggregate (datafusion_tpu/device/groupby.py:70), and the
// emit packer _fetch_state (device_aggregate.py:1017): the result is one
// [lanes + 1][G] int64 table (float lanes hold float64 bits) that a single
// device-to-host copy brings back. With G = 1 it is also the filtered
// reduction device_filter_reduce (device/groupby.py:443).
//
// Design. Every expression (predicate, each group key, each lane argument)
// arrives as a small stack program compiled on the host
// (datafusion_tpu_torch/device/lower.py). The kernel copies the whole
// descriptor (programs, constants, column pointers) into shared memory and
// keeps a per-block [lanes + 1][G] table there (G <= 64 slots, lanes <= 32:
// at most 16.9 KB), merged into the global table with atomics at the end,
// so any number of batches accumulate into one table. The rows are reduced
// before any atomic (`dense_fold` in program.cuh):
//   - G = 1 (TPC-H Q6, ClickBench Q30): a warp takes tiles of kTile x 32
//     consecutive rows; each lane finds its rows' admitted bits once, then
//     runs each lane program over them into a register, and the warp
//     reduces each lane by shuffles: one shared-memory update a lane a
//     tile, where a row used to make one a lane;
//   - G > 1 (TPC-H Q1): 32 rows a warp step; the rows of one slot find
//     their peers once (__match_any_sync) and each lane reduces over them,
//     so a slot takes one update a lane a warp.
// Float min and max run their CAS loops on the reduced value, once a warp.
//
// Bounds. TPC-H Q1 reads 44 bytes a row (four int64 decimals, three int32
// columns); at SF10 (60,012,150 rows) that is about 2.6 GB, roughly 0.8 ms
// at the 3.35 TB/s data-sheet peak of an NVIDIA H100 80GB HBM3 at its
// 700 W limit. ClickBench Q30 reads 4 bytes a row of 99,997,497 rows but
// runs 180 lane programs a row, in 6 passes of at most 32. With the
// atomics reduced a warp at a time, what is left is the interpreter: a
// switch per instruction on a stack kept in local memory, some tens of
// instructions a lane program a row, far above either bound.
//
// Exactness. Integer and decimal lanes are exact in any order (64-bit
// two's-complement adds wrap the same way). Float sums add in another
// order than the plain version's (and from run to run); callers compare
// them within a relative tolerance. The interpreter, the lane folds and the
// row bodies live in program.cuh, shared with the hash group-by, the
// join-chain and the join-aggregate kernels.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
// rows a lane takes a tile at G = 1
constexpr int kTile = 8;
// Five blocks an SM for the lean interpreter (at most 51 registers), as
// many as it held before the warp reduction raised its registers to 60.
constexpr int kMinBlocks = 5;

template <bool Full>
__global__ void __launch_bounds__(kThreads, Full ? 1 : kMinBlocks)
fused_dense_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                             const i64* __restrict__ aux, i64 n_rows,
                             u64* __restrict__ table_g) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  dense_fold<kTile>(smem, aux, n_rows, (u64*)(smem + meta_len), table_g,
                    PlainRows<Full>{smem, aux});
}

}  // namespace

// meta: device int64 descriptor of meta_len words (see groupby.py);
// aux: device int64 per-batch inputs; table: device int64
// [n_lanes + 1][groups], filled with each lane's identity by the caller;
// full: the programs need the interpreter's full variant. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dft_fused_dense_aggregate(const void* meta, int meta_len,
                                         int n_lanes, int groups,
                                         const void* aux, long long n_rows,
                                         void* table, int full,
                                         void* stream) {
  const size_t smem = (size_t)(meta_len + (n_lanes + 1) * groups) * 8;
  const auto kernel = full ? fused_dense_aggregate_kernel<true>
                           : fused_dense_aggregate_kernel<false>;
  const long long per_thread = groups == 1 ? kTile : 1;
  kernel<<<grid_blocks((n_rows + per_thread - 1) / per_thread, kThreads),
           kThreads, smem, (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (u64*)table);
  return (int)cudaGetLastError();
}
