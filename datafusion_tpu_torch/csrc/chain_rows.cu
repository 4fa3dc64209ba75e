// chain_rows: the row-returning walk of a fanout-1 join chain. The rows of
// the spine that survive the chain come out as typed output columns, in
// spine order.
//
// Replaces the two programs of the JAX package's DeviceJoinChainRowsExec
// (datafusion_tpu/physical/plan/device_join_chain.py): mask_prog (:2312,
// jit :2339), which walks the chain over the padded spine batch and sums
// the surviving rows, and emit_prog (:2352, jit :2377), which compacts the
// survivors by cumsum + searchsorted, walks the chain again over them and
// evaluates the output expressions.
//
// Design. Two entry points on the caller's stream:
//   1. dft_chain_rows_mark: one thread per spine row runs `ChainRows`
//      (program.cuh: the probe predicate, each hop's lookup in chain order,
//      the residual) and writes its keep flag into pos[row] (int64), with
//      pos[n] = 0; then the three-launch exclusive scan of scan.cuh turns
//      pos[0..n] into each kept row's output slot, and pos[n] into the
//      number of kept rows. The caller reads pos[n] to size the outputs.
//   2. dft_chain_rows_emit: one thread per spine row again; a row is kept
//      where pos[row + 1] != pos[row]. A kept row walks the chain once more
//      to find each hop's build row (nothing is kept between the passes),
//      then runs every output program over the pair space and writes its
//      value, at the output column's width, and its valid bit at slot
//      pos[row]. Data under a NULL is 0.
// Outputs are at slots given by the scan, so they are in spine order and
// the same from run to run.
//
// Bounds. TPC-H Q2 at SF10 reads partsupp's ps_partkey, ps_suppkey and
// ps_supplycost (24 bytes a row, 8.0M rows, 192 MB) and writes a few
// thousand rows: about 0.06 ms at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 at 700 W. This simple version moves more: the keep flags and the
// scan write and read pos (8 bytes a row, about 4 passes), and pass 2
// reads pos twice a row, about 40 bytes a row beyond the spine's own; the
// hop lookups are random reads of 32-byte sectors.

#include "program.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads)
rows_mark_kernel(const i64* __restrict__ meta_g, int meta_len,
                 const i64* __restrict__ aux, i64 n_rows,
                 i64* __restrict__ pos) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const ChainRows<Full, Staged> rows{smem, aux};
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    ChainColumns<Full> cols;
    pos[row] = rows(row, &cols) ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) pos[n_rows] = 0;
}

// one output value at the output column's width
__device__ __forceinline__ void store(void* data, int dtype, i64 slot,
                                      i64 x) {
  switch (dtype) {
    case DT_BOOL: ((unsigned char*)data)[slot] = x != 0; break;
    case DT_I32: ((int*)data)[slot] = (int)x; break;
    case DT_F32: ((float*)data)[slot] = __double2float_rn(as_f(x)); break;
    default: ((i64*)data)[slot] = x; break;  // DT_I64, DT_F64 bits
  }
}

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads)
rows_emit_kernel(const i64* __restrict__ meta_g, int meta_len,
                 const i64* __restrict__ aux, i64 n_rows,
                 const i64* __restrict__ pos, const i64* __restrict__ outs) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const ChainRows<Full, Staged> rows{smem, aux};
  const int n_out = (int)smem[H_NLANES];
  const i64* progs = smem + smem[H_OFF_LANES];   // (program, dtype code)
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    const i64 slot = pos[row];
    if (pos[row + 1] == slot) continue;
    ChainColumns<Full> cols;
    rows(row, &cols);  // true: the walk of pass 1, for the build rows
    for (int o = 0; o < n_out; ++o) {
      i64 x;
      const bool valid = run(smem, aux, (int)progs[2 * o], row, cols, &x);
      store((void*)outs[2 * o], (int)progs[2 * o + 1], slot, valid ? x : 0);
      ((unsigned char*)outs[2 * o + 1])[slot] = valid;
    }
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py
// ChainRowsSpec); aux: device int64 per-batch inputs; pos: device int64
// [n_rows + 1]; sums: device int64 scratch of ceil((n_rows + 1) / 8192)
// words; variant: bit 0 the programs or a min/max hop need the
// interpreter's full variant, bit 1 the chain has composed or folded hops.
// Four launches on `stream` (the mark, then exclusive_scan's three);
// returns the first cudaError_t.
extern "C" int dft_chain_rows_mark(const void* meta, int meta_len,
                                   const void* aux, long long n_rows,
                                   void* pos, void* sums, int variant,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const auto kernel = DFT_WALK_VARIANT(rows_mark_kernel, variant);
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           st>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (i64*)pos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)exclusive_scan((i64*)pos, n_rows + 1, (i64*)sums, st);
}

// pos: the scanned slots of dft_chain_rows_mark; outs: device int64
// [2 * outputs], each output's (data pointer, validity pointer), data at
// the width of its dtype code in the descriptor; variant as in the mark.
extern "C" int dft_chain_rows_emit(const void* meta, int meta_len,
                                   const void* aux, long long n_rows,
                                   const void* pos, const void* outs,
                                   int variant, void* stream) {
  const auto kernel = DFT_WALK_VARIANT(rows_emit_kernel, variant);
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, (const i64*)pos,
      (const i64*)outs);
  return (int)cudaGetLastError();
}
