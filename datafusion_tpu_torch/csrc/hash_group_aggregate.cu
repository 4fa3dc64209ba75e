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
// Design. The aggregate kernel's own fold (`hash_fold_warps` in
// program.cuh; the join-chain walks keep the row-at-a-time `hash_fold`, the
// fanout-N join's probe `hash_fold_row`) runs the predicate, key and lane
// programs as fused_dense_aggregate does, and reduces before any global
// atomic, in two levels:
//   - warp peers: a warp takes 32 consecutive rows a step (coalesced column
//     loads); each row's admitted bit and packed key are found once, and
//     the rows of one key are its peers (__match_any_sync on the 64-bit
//     key). Counts reduce by a popcount or a ballot, the other lanes over
//     the peers by shuffles (`reduce_peers`), and the lowest peer finds the
//     group once and makes one atomic a lane: TPC-H Q18's sorted
//     l_orderkey folds about 4 rows an order at once, a warp of ClickBench
//     rows its hottest user's 8 or so. A block whose rows seldom meet a
//     peer stops matching (kMatchGiveUp);
//   - a block cache of hot keys: persistent blocks (as many an SM as the
//     registers allow) each keep an open-addressing table of the same
//     layout in dynamic shared memory, its entries the power of two that
//     fits the block's share of five eighths of the SM's shared memory
//     (kCacheShare; the rest stays L1) for the pass's lanes. The lowest peer probes it (kCacheProbes entries, a shared CAS
//     to claim one) and folds a hit with shared atomics; a miss goes to the
//     table. At the block's end every occupied entry is merged into the
//     table. A block whose keys seldom repeat stops probing (kCacheGiveUp);
//     a pass with a count(DISTINCT x) lane runs without a cache, its set
//     inserts one row at a time.
// The table itself: identity mode (key space <= cap) takes the packed key
// as the slot, with no probe and no CAS, and writes a group's key word
// once, where its count update finds the count 0 (the first pass), so no
// row reads the key row; hash mode claims a slot by splitmix64 of the key
// masked to cap - 1, linear probing and atomicCAS on an EMPTY key word.
// A group that finds no slot (a probe that wraps the whole table, or a key
// outside an identity table) sets *overflow and is dropped, from the cache
// merge too; the caller raises. Lanes fold with atomics: 64-bit adds for
// counts and sums, 64-bit atomicMin/atomicMax for int64 min/max, CAS loops
// for float64 min/max, a 32-bit float add for SUM_F32 (a cache cell keeps
// it in float32 as the table does).
//
// count(DISTINCT x) (device/groupby.py:214-228, the `distinct` kind, and
// its row-space lane :338-350, :381-383) is a lane too: each admitted row
// with a valid argument inserts (slot, lane, value) into a global
// open-addressing distinct set (program.cuh `distinct_insert`), and the
// insert that creates a pair adds 1 to the group's lane. The reference
// sorts (key, value) pairs and so takes one chunk of at most 2^21 rows;
// the set persists across launches like the table, so any number of
// batches fold into one count.
//
// More than 32 lanes (ClickBench Q30: 180) run as passes of this kernel
// over the same rows, each with the descriptor of up to 32 lanes and their
// first lane row (H_LANE0); the first pass counts the rows and claims the
// slots (a cached key at its block's merge), and the later ones find the
// same slots.
//
// Bounds. ClickBench Q16 reads 8 bytes a row (UserID, 99,997,497 rows:
// 0.8 GB) and writes its 1.9M groups' slots of a 2^24-slot identity table:
// 0.25 ms at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W data sheet).
// What the fold pays beyond that is one random sector a lane for each key
// a warp step that misses its block's cache; UserID is zipf(1.3) (one user
// carries a quarter of the rows, the 1,000 hottest about 89%), so the cache
// takes most rows. TPC-H Q18's subquery reads 16 bytes a row (60.0M rows)
// into a 2^26-slot table of 4 rows (2.1 GB, far beyond the 50 MB L2): its
// keys are sorted, so a warp folds a few groups and its cache misses.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
// A smaller cache saves too few rows: the pass runs without one.
constexpr int kMinEntries = 64;
// Eighths of the SM's shared memory the blocks' caches may take: the rest
// stays L1 cache, which the interpreter's stack in local memory needs (a
// carveout of all of it cost CB Q10's distinct fold 9% and Q15's
// subquery 6% on an NVIDIA H100).
constexpr int kCacheShare = 5;

template <bool Full>
__global__ void __launch_bounds__(kThreads)
hash_group_aggregate_kernel(const i64* __restrict__ meta_g, int meta_len,
                            const i64* __restrict__ aux, i64 n_rows, i64 cap,
                            int identity_slots, i64* __restrict__ table,
                            int* __restrict__ overflow, int entries) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  hash_fold_warps(smem, aux, n_rows, cap, identity_slots, table, overflow,
                  smem + meta_len, entries, PlainRows<Full>{smem, aux});
}

}  // namespace

// meta: device int64 descriptor of meta_len words (see groupby.py) for a
// pass of n_lanes lanes; cache: whether the pass may use a block cache (0
// for a pass with a distinct lane); aux: device int64 per-batch inputs;
// table: device int64 [all lanes + 2][cap], cap a power of two, row 0
// EMPTY (-1), row 1 zero, each lane its identity; overflow: device int32
// flag, set to 1 when a group found no slot; full: the programs need the
// interpreter's full variant. Launches persistent blocks on `stream`, each
// with the largest cache its share of the SM's shared memory holds, and
// returns the first CUDA error.
extern "C" int dft_hash_group_aggregate(const void* meta, int meta_len,
                                        int n_lanes, int cache,
                                        const void* aux, long long n_rows,
                                        long long cap, int identity_slots,
                                        void* table, void* overflow,
                                        int full, void* stream) {
  const auto kernel = full ? hash_group_aggregate_kernel<true>
                           : hash_group_aggregate_kernel<false>;
  const long long meta_bytes = (long long)meta_len * 8;
  int dev = 0, sms = 0, sm_smem = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads,
                                                      (size_t)meta_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  // the shared memory a block takes besides its cache: the 1 KB the
  // runtime reserves, its static variables and the descriptor
  const long long fixed = 1024 + (long long)attr.sharedSizeBytes + meta_bytes;
  int entries = 0;
  if (cache) {
    // the block's share of kCacheShare of the SM's shared memory
    long long budget = (long long)sm_smem * kCacheShare / 8 / per_sm;
    if (budget > optin) budget = optin;
    budget -= fixed;
    const long long per_entry = (long long)(n_lanes + 2) * 8;
    long long e = kMinEntries;
    while (2 * e * per_entry <= budget) e *= 2;
    entries = e * per_entry <= budget ? (int)e : 0;
  }
  const long long smem = meta_bytes + (long long)entries * (n_lanes + 2) * 8;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as little shared memory as the blocks need, the rest of the SM's 256 KB
  // left to the L1 cache (the interpreter's stack and the columns)
  const long long need = per_sm * (fixed + smem - meta_bytes);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)((need * 100 + sm_smem - 1) / sm_smem));
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_rows + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 132) * per_sm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, cap,
      identity_slots, (i64*)table, (int*)overflow, entries);
  return (int)cudaGetLastError();
}
