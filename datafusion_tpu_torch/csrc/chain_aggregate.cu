// chain_aggregate: the probe walk of a fanout-1 join chain fused with the
// group-aggregate, one thread per spine row.
//
// Replaces the JAX package's chain programs
// (datafusion_tpu/physical/plan/device_join_chain.py): _chain_walk (:1597),
// _chain_core (:1783), _make_chain_step (:1920, jit :505) and the row-space
// programs (:1946, :1994; jits :2066, :2091, :2116). The reference also
// folds snowflake hops into their parent's payload matrix at staging time
// (_compose_staged_hops :786, _make_compose_prog :926, _fold_lut_pmat :719)
// and packs payloads into int32 lane matrices (_stage_payload_matrix
// :1007) to save gathers on the TPU; here each hop resolves its build row
// as the walk reaches it and each payload is read through that row.
//
// Per spine row (`ChainRows` in program.cuh): the probe predicate; for each
// hop in chain order its probe-key programs over the pair space so far
// (spine columns, then payloads of earlier hops, read at the build row
// each hop found: `ChainColumns`), the range check, the packed key and one
// lookup in the build's direct or hashed table, the row kept only when an
// INNER or SEMI hop found a row and an ANTI hop found none; then the
// residual predicate; then the packed group key and the lane folds of the
// grouped aggregate. No joined column is ever materialised. The fold is the
// one of the aggregate kernels (`dense_fold_rows`: <= 64 slots in shared
// memory, one atomic a lane a row, as fused_dense_aggregate did before it
// reduced across the warp, which costs the walks registers and buys them
// nothing, since their hops admit few rows; `hash_fold`: the global table of
// hash_group_aggregate), so the output table has their layout and
// compact_groups and the host emit run unchanged. The fold's lanes include
// count(DISTINCT x) through the global distinct set of program.cuh, in
// place of the reference's distinct slot (`_chain_slots` :1459-1460,
// row-space :2020), which takes one spine chunk of at most 2^21 rows
// (:445-449); lanes past 32 run as further passes of the walk.
//
// Bounds. TPC-H Q5 at SF10 reads lineitem's l_suppkey, l_orderkey,
// l_extendedprice and l_discount (32 bytes a row, 60.0M rows, 1.92 GB),
// then per surviving row one table read and the payloads per hop: about
// 0.6 ms of streaming at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W.
// The gathers into tables far larger than the 50 MB L2 (orders: 60M
// slots) are random 4-byte reads that cost a 32-byte sector each.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
// Four blocks an SM, so at most 64 registers a thread. The lean walks fit
// that anyway; the full ones would take 80-104 and fit only two or three.
// Measured on an H100 (PERF.md): Q9's and Q12's walks run faster
// capped, Q21's (two min/max hops) 12% slower.
constexpr int kMinBlocks = 4;

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_dense_kernel(const i64* __restrict__ meta_g, int meta_len,
                   const i64* __restrict__ aux, i64 n_rows,
                   u64* __restrict__ table_g) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  dense_fold_rows(smem, aux, n_rows, (u64*)(smem + meta_len), table_g,
                  ChainRows<Full, Staged>{smem, aux});
}

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_hash_kernel(const i64* __restrict__ meta_g, int meta_len,
                  const i64* __restrict__ aux, i64 n_rows, i64 cap,
                  int identity_slots, i64* __restrict__ table,
                  int* __restrict__ overflow) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  hash_fold(smem, aux, n_rows, cap, identity_slots, table, overflow,
            ChainRows<Full, Staged>{smem, aux});
}

}  // namespace

// meta: device int64 descriptor of meta_len words with its chain section
// (join_chain.py); aux: device int64 per-batch inputs. mode 0: the dense
// table int64 [n_lanes + 1][groups]; mode 1 (the packed key is the slot)
// and 2 (probed): the hash table int64 [n_lanes + 2][cap] and the int32
// overflow flag, as dft_hash_group_aggregate takes them; variant: bit 0
// the programs or a min/max hop need the interpreter's full variant, bit 1
// the chain has composed or folded hops. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dft_chain_aggregate(const void* meta, int meta_len,
                                   int n_lanes, int groups, const void* aux,
                                   long long n_rows, long long cap, int mode,
                                   void* table, void* overflow, int variant,
                                   void* stream) {
  const unsigned blocks = grid_blocks(n_rows, kThreads);
  if (mode == 0) {
    const size_t smem = (size_t)(meta_len + (n_lanes + 1) * groups) * 8;
    const auto kernel = DFT_WALK_VARIANT(chain_dense_kernel, variant);
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_rows, (u64*)table);
  } else {
    const auto kernel = DFT_WALK_VARIANT(chain_hash_kernel, variant);
    kernel<<<blocks, kThreads, (size_t)meta_len * 8,
             (cudaStream_t)stream>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_rows, cap,
        mode == 1 ? 1 : 0, (i64*)table, (int*)overflow);
  }
  return (int)cudaGetLastError();
}
