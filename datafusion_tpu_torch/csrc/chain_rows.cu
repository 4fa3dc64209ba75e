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
// Design. Two launches on the caller's stream, after a zero fill of the
// walk's state words (ticket, total, a status word a tile):
//   1. dft_chain_rows_walk: the aggregate walk's tile walk (tile_walk.cuh).
//      A block takes a tile of kWarps x `cap` spine rows at a time, in spine
//      order, from a ticket, and each of its warps walks `cap` rows of it on
//      its own: it
//      admits them to its list in shared memory (the probe predicate's
//      conjuncts), walks the list through the hops (each hop over the
//      compacted survivors, handles in shared memory; staged hops read
//      composed words and folded records), then runs the residual over
//      what is left and compacts once more. The tile's survivor count goes
//      out at once through the decoupled look-back of lookback.cuh, taken
//      by one warp (a status word a tile; every earlier tile's block has
//      started, as tickets are taken in order), which gives the tile's
//      first output slot; each survivor then writes its spine row and its
//      handle at every hop to the survivor scratch at its slot (hop-major).
//      The last tile writes
//      the total. Nothing of the spine is written: the keep flags, the scan
//      and its three launches of the old design are gone. A block's tile,
//      not a warp's: with a warp's, thousands of tiles are in flight, and
//      a look-back walks past the aggregates of all that have not yet
//      found their first slot (PERF.md).
//   2. dft_chain_rows_emit: one thread a survivor, grid-stride over the
//      total: the output programs run over the pair space through the
//      stored handles (`TileColumns` over the scratch, no chain walk), and
//      each value is written at the output column's width with its valid
//      bit. Data under a NULL is 0.
// The caller reads the total back once (one synchronisation a call) and
// sizes the outputs. The scratch is the upper bound, an entry a spine row
// ((1 + hops) x 4 bytes a row, not filled: 192 MB for TPC-H Q2's 8M-row,
// 5-hop spine at SF10, 1.9 GB for an 80M-row spine of 5 hops, of the card's
// 80 GB), so no survivor count can overflow it and the walk runs once.
// Outputs are at slots given by the tiles' order, so they are in spine
// order and the same from run to run.
//
// Bounds. TPC-H Q2 at SF10 reads partsupp's ps_partkey, ps_suppkey and
// ps_supplycost (24 bytes a row, 8.0M rows, 192 MB) and writes a few
// thousand rows: about 0.06 ms at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 at 700 W. The walk reads the spine's predicate and key columns once
// and the hop tables at the rows that reach each hop (random 32-byte
// sectors); beyond that it writes 8 bytes a tile of status and
// (1 + hops) x 4 bytes a survivor, and the emit reads them back.

#include <cstring>

#include "program.cuh"
#include "lookback.cuh"
#include "tile_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // join_chain.py ROWS_WARPS
// As the aggregate walk: four blocks an SM, at most 64 registers a thread.
constexpr int kMinBlocks = 4;
constexpr u64 kEpoch = 1;      // the status words are zeroed every call
constexpr int kMaxOutputs = 32;   // join_chain.py MAX_LANES

// Each output's (data pointer, validity pointer), passed by value so the
// emit needs no upload.
struct Outputs {
  i64 ptr[2 * kMaxOutputs];
};

// state: [ticket, total, status of each tile]; rows_out [n_rows] and
// handles_out [hops][n_rows] the survivor scratch. A tile is a block's:
// each warp walks `cap` rows of it.
template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_walk_kernel(const i64* __restrict__ meta_g, int meta_len,
                 const i64* __restrict__ aux, i64 n_rows, int cap,
                 u64* __restrict__ state, int* __restrict__ rows_out,
                 int* __restrict__ handles_out) {
  extern __shared__ i64 smem[];
  __shared__ i64 tile_s;
  __shared__ i64 first_s;                  // the tile's first output slot
  __shared__ i64 before_s[kWarps];   // a warp's first within the tile
  __shared__ int count_s[kWarps];    // a warp's survivors
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const int n_hops = (int)ch[C_NHOPS];
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int* rows = (int*)(smem + meta_len) + warp * (2 + n_hops) * cap;
  int* list = rows + cap;
  int* handles = rows + 2 * cap;
  TileColumns<Full, Staged> cols{meta, handles, cap, 0};
  const int width = __popc(warp_members());
  const int lane = lane_id();
  const i64 step = (i64)width * kRowsPerStep;
  const i64 tile_rows = (i64)nw * cap;
  const i64 n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  u64* status = state + 2;
  for (;;) {
    if (threadIdx.x == 0) tile_s = (i64)atomicAdd(state, 1ull);
    __syncthreads();
    const i64 t = tile_s;
    if (t >= n_tiles) break;
    const i64 base = t * tile_rows + (i64)warp * cap;
    const i64 end = base + cap < n_rows ? base + cap : n_rows;
    int n = 0;
    for (i64 at = base; at < end; at += step) {
      i64 row[kRowsPerStep];
      bool keep[kRowsPerStep];
#pragma unroll
      for (int r = 0; r < kRowsPerStep; ++r) {
        row[r] = at + r * width + lane;
        keep[r] = row[r] < end;
      }
      admit_rows(meta, aux, ch, row, keep, cols);
#pragma unroll
      for (int r = 0; r < kRowsPerStep; ++r) {
        n = warp_append(keep[r], (int)row[r], rows, n);
      }
    }
    __syncwarp();
    bool dense;
    const int m = walk_hops(meta, aux, rows, n, list, handles, cols, &dense);
    int k = m;
    if (meta[H_PRED] >= 0) {   // the residual, compacted in place
      k = 0;
      for (int i0 = 0; i0 < m; i0 += width) {
        const int i = i0 + lane;
        const int e = i < m ? (dense ? i : list[i]) : 0;
        bool keep = false;
        if (i < m) {
          cols.e = e;
          i64 x;
          keep = run(meta, aux, (int)meta[H_PRED], (i64)rows[e], cols, &x) &&
                 x != 0;
        }
        __syncwarp();
        k = warp_append(keep, e, list, k);
      }
      __syncwarp();
      dense = false;
    }
    if (lane == 0) count_s[warp] = k;
    __syncthreads();
    // the tile's count out at once, then its first slot by look-back
    if (warp == 0) {
      i64 total = 0;
      if (lane == 0) {
        for (int w = 0; w < nw; ++w) {
          before_s[w] = total;
          total += count_s[w];
        }
        store_status(status + t, status_word(
            t == 0 ? kInclusive : kAggregate, kEpoch, (u64)total));
      }
      const i64 first = t > 0 ? warp_look_back(status, t, 1, kEpoch) : 0;
      if (lane == 0) {
        if (t > 0) {
          store_status(status + t,
                       status_word(kInclusive, kEpoch, (u64)(first + total)));
        }
        if (t == n_tiles - 1) state[1] = (u64)(first + total);
        first_s = first;
      }
    }
    __syncthreads();
    const i64 first = first_s + before_s[warp];
    for (int i0 = 0; i0 < k; i0 += width) {
      const int i = i0 + lane;
      const i64 slot = first + i;
      if (i < k) {
        const int e = dense ? i : list[i];
        rows_out[slot] = rows[e];
        for (int h = 0; h < n_hops; ++h) {
          handles_out[h * n_rows + slot] = handles[h * cap + e];
        }
      }
    }
    __syncthreads();   // the lists and shared words are free again
  }
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
                 const i64* __restrict__ aux, i64 total,
                 const int* __restrict__ rows_in,
                 const int* __restrict__ handles_in, i64 hop_stride,
                 const Outputs outs) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const int n_out = (int)smem[H_NLANES];
  const i64* progs = smem + smem[H_OFF_LANES];   // (program, dtype code)
  TileColumns<Full, Staged> cols{smem, handles_in, (int)hop_stride, 0};
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < total;
       s += stride) {
    cols.e = (int)s;
    const i64 row = __ldg(rows_in + s);
    for (int o = 0; o < n_out; ++o) {
      i64 x;
      const bool valid = run(smem, aux, (int)progs[2 * o], row, cols, &x);
      store((void*)outs.ptr[2 * o], (int)progs[2 * o + 1], s,
            valid ? x : 0);
      ((unsigned char*)outs.ptr[2 * o + 1])[s] = valid;
    }
  }
}

// The blocks of the walk: as many as the card holds at once (tiles are
// taken by ticket), at most one a tile.
template <class Kernel>
unsigned walk_blocks(Kernel kernel, size_t smem, long long n_tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm < 1) {
    per_sm = 1;
  }
  long long blocks = (long long)(sms > 0 ? sms : 132) * per_sm;
  if (blocks > n_tiles) blocks = n_tiles;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py
// ChainRowsSpec); aux: device int64 per-batch inputs; cap: the spine rows
// a warp walks of a tile, the entries of its lists (a tile is a block's
// kWarps warps' rows); state: device int64 [2 + ceil(n_rows / (kWarps x
// cap))], zeroed (the ticket, the total, a status word a tile);
// rows_out: int32 [n_rows], handles_out: int32 [n_hops][n_rows];
// variant: bit 0 the programs or a min/max hop need the interpreter's full
// variant, bit 1 the chain has composed or folded hops. One launch on
// `stream`; returns cudaGetLastError() (or the shared-memory attribute's
// error). The total lands in state[1].
extern "C" int dft_chain_rows_walk(const void* meta, int meta_len,
                                   const void* aux, long long n_rows,
                                   int n_hops, int cap, void* state,
                                   void* rows_out, void* handles_out,
                                   int variant, void* stream) {
  const long long tile_rows = (long long)kWarps * cap;
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const size_t smem = (size_t)meta_len * 8 +
                      (size_t)kWarps * (2 + n_hops) * cap * 4;
  const auto kernel = DFT_WALK_VARIANT(rows_walk_kernel, variant);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<walk_blocks(kernel, smem, n_tiles), kThreads, smem,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, cap,
      (u64*)state, (int*)rows_out, (int*)handles_out);
  return (int)cudaGetLastError();
}

// rows_in, handles_in: the walk's survivor scratch, `hop_stride` entries
// a hop (the spine rows), its first `total` filled; outs: host int64
// [2 * n_out], each output's device (data pointer, validity pointer), data
// at the width of its dtype code in the descriptor; variant as in the
// walk. One launch on `stream`; returns cudaGetLastError().
extern "C" int dft_chain_rows_emit(const void* meta, int meta_len,
                                   const void* aux, long long total,
                                   const void* rows_in,
                                   const void* handles_in,
                                   long long hop_stride,
                                   const void* outs, int n_out, int variant,
                                   void* stream) {
  if (n_out > kMaxOutputs) return (int)cudaErrorInvalidValue;
  Outputs o;
  memcpy(o.ptr, outs, sizeof(i64) * 2 * n_out);
  const auto kernel = DFT_WALK_VARIANT(rows_emit_kernel, variant);
  kernel<<<grid_blocks(total, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, total,
      (const int*)rows_in, (const int*)handles_in, hop_stride, o);
  return (int)cudaGetLastError();
}
