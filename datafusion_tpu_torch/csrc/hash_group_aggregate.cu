// hash_group_aggregate: filter, key packing, value lanes and grouping into
// a global open-addressing hash table, in one pass over the rows.
//
// Replaces the JAX package's grouped aggregation beyond 64 slots, which
// it runs as several jitted XLA programs (datafusion_tpu/):
//   - device/groupby.py:159 device_group_aggregate (argsort intern,
//     segment sums, two-key-sort min/max) and :117 _sorted_group_aggregate
//     (pre-sorted keys), behind DeviceGroupAggregateExec._make_step
//     (physical/plan/device_aggregate.py:774);
//   - device_aggregate.py:786 _execute_rowspace_plain with
//     device/groupby.py:292 rowspace_group_state (the row-space path);
//   - device_aggregate.py:973 _merge (re-aggregating two partial tables):
//     every batch folds into the same table here, so nothing merges;
//   - device_aggregate.py:97 _overflow_poison: an overflow flag instead;
//   - device/groupby.py:393 device_group_aggregate_big with
//     device_aggregate.py:1181 _execute_big (unbounded cardinality): the
//     caller sizes the table from the input, at least twice the number of
//     groups there can be, so it cannot fill.
//
// Layout. One int64 table of [L + 2][cap]: row 0 holds the packed keys
// (EMPTY = -1; packed keys have at most 62 bits, so they are >= 0), row 1
// counts the rows of each group, rows 2.. are the L lanes (float lanes hold
// float64 bits; SUM_F32 lanes a float32 in the low word).
//
// Design. Per row, a grid-stride loop (`hash_fold` in program.cuh, shared
// with the join-chain kernel) runs the predicate, key and lane programs, as
// fused_dense_aggregate does, then finds the group's slot:
//   - identity mode (key space <= cap): the packed key is the slot, with
//     no probe and no CAS;
//   - hash mode: splitmix64 of the key masked to cap - 1, linear probing,
//     atomicCAS to claim an EMPTY slot. A probe that wraps the whole table
//     sets *overflow and drops the row; the caller raises.
// Lanes fold with global atomics: 64-bit adds for counts and sums, 64-bit
// atomicMin/atomicMax for int64 min/max, CAS loops for float64 min/max, a
// 32-bit float add for SUM_F32.
//
// Bounds. TPC-H Q18's subquery at SF10 reads 16 bytes a row (l_orderkey,
// l_quantity: 60.0M rows, 0.96 GB) plus the table traffic: a key read and
// three 8-byte atomics a row into a 2^26-slot identity table of 4 rows
// (2.1 GB, far beyond the 50 MB L2). The keys are sorted, so a warp's
// accesses fall on a few neighbouring slots. At 3.35 TB/s (NVIDIA H100
// 80GB HBM3, 700 W data sheet) the streaming part alone is 0.3 ms. Skewed
// keys (ClickBench UserID is zipf(1.3): one user carries about a quarter of
// the rows) serialise their atomics on one address; warp pre-aggregation
// (__match_any_sync) is the known cure and is not done here.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Full>
__global__ void __launch_bounds__(kThreads)
hash_group_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                            const i64* __restrict__ aux, i64 n_rows, i64 cap,
                            int identity_slots, i64* __restrict__ table,
                            int* __restrict__ overflow) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  hash_fold(smem, aux, n_rows, cap, identity_slots, table, overflow,
            PlainRows<Full>{smem, aux});
}

}  // namespace

// meta: device int64 descriptor of meta_len words (see groupby.py); aux:
// device int64 per-batch inputs; table: device int64 [n_lanes + 2][cap],
// cap a power of two, row 0 EMPTY (-1), row 1 zero, each lane its identity;
// overflow: device int32 flag, set to 1 when a row found no slot; full:
// the programs need the interpreter's full variant. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int dft_hash_group_aggregate(const void* meta, int meta_len,
                                        const void* aux, long long n_rows,
                                        long long cap, int identity_slots,
                                        void* table, void* overflow,
                                        int full, void* stream) {
  const size_t smem = (size_t)meta_len * 8;
  const auto kernel = full ? hash_group_aggregate_kernel<true>
                           : hash_group_aggregate_kernel<false>;
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, smem,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, cap,
      identity_slots, (i64*)table, (int*)overflow);
  return (int)cudaGetLastError();
}
