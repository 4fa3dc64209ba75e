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
// Design. Per row, a grid-stride loop runs the predicate, key and lane
// programs (program.cuh, as fused_dense_aggregate does), then finds the
// group's slot:
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
constexpr i64 kEmpty = -1;

__device__ __forceinline__ u64 splitmix64(u64 x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The slot of `key`, claimed if new; -1 when the table is full.
__device__ __forceinline__ i64 find_slot(i64* keys, i64 cap, i64 key) {
  const i64 mask = cap - 1;
  i64 h = (i64)(splitmix64((u64)key) & (u64)mask);
  for (i64 probes = 0; probes < cap; ++probes) {
    // a slot's key never changes once written, so a stale read can only
    // be EMPTY, and the CAS below settles that case
    const i64 seen = *(volatile i64*)&keys[h];
    if (seen == key) return h;
    if (seen == kEmpty) {
      const i64 old = (i64)atomicCAS((u64*)&keys[h], (u64)kEmpty, (u64)key);
      if (old == kEmpty || old == key) return h;
    }
    h = (h + 1) & mask;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
hash_group_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                            const i64* __restrict__ aux, i64 n_rows, i64 cap,
                            int identity_slots, i64* __restrict__ table,
                            int* __restrict__ overflow) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const int n_lanes = (int)meta[H_NLANES];
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  const i64* lanes = meta + meta[H_OFF_LANES];
  const RowColumns cols{meta + meta[H_OFF_COLS]};
  u64* rows = (u64*)(table + cap);   // row 1 of the table, then the lanes

  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    if (meta[H_PRED] >= 0) {
      i64 x;
      const bool valid = run(meta, aux, (int)meta[H_PRED], row, cols, &x);
      if (!(valid && x != 0)) continue;
    }
    const i64 packed = pack_key(meta, aux, keys, n_keys, row, cols);
    i64 slot;
    if (identity_slots) {
      slot = packed >= 0 && packed < cap ? packed : -1;
      if (slot >= 0 && table[slot] != packed) table[slot] = packed;
    } else {
      slot = packed >= 0 ? find_slot(table, cap, packed) : -1;
    }
    if (slot < 0) {
      *overflow = 1;
      continue;
    }
    atomicAdd(&rows[slot], 1ull);
    fold_lanes(meta, aux, lanes, n_lanes, row, cols,
               [&](int l) { return &rows[(i64)(l + 1) * cap + slot]; });
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (see groupby.py); aux:
// device int64 per-batch inputs; table: device int64 [n_lanes + 2][cap],
// cap a power of two, row 0 EMPTY (-1), row 1 zero, each lane its identity;
// overflow: device int32 flag, set to 1 when a row found no slot.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_hash_group_aggregate(const void* meta, int meta_len,
                                        const void* aux, long long n_rows,
                                        long long cap, int identity_slots,
                                        void* table, void* overflow,
                                        void* stream) {
  const size_t smem = (size_t)meta_len * 8;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_rows + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  hash_group_aggregate_kernel<<<(unsigned)blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, cap,
      identity_slots, (i64*)table, (int*)overflow);
  return (int)cudaGetLastError();
}
