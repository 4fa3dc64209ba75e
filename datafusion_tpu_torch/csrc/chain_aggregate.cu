// chain_aggregate: the probe walk of a fanout-1 join chain fused with the
// group-aggregate, each warp walking tiles of spine rows in stages.
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
// What it computes, per spine row: the probe predicate; for each hop in
// chain order its probe keys over the pair space so far (spine columns,
// then payloads of earlier hops, read at the row handle each hop found),
// the range check, the packed key and one lookup in the build's direct or
// hashed table (a composed hop reads its owner's words, a folded hop's
// handle is its record), the row kept only when an INNER or SEMI hop found
// a row (and a filtered hop's min/max test holds) and an ANTI hop found
// none; then the residual predicate; then the packed group key and the
// lane folds of the grouped aggregate. No joined column is materialised.
//
// Design: a tile walk, a warp's. Each warp runs over its share of the
// spine, kRowsPerStep x 32 rows a step (grid-strided by warp). A step
// tests the probe predicate on every row (the host's conjuncts: a
// one-column test is read straight from its column, only other conjuncts
// go through the interpreter; each conjunct's loads for the lane's rows
// issued together) and appends the admitted rows to the warp's list in
// shared memory in spine order (a ballot and a popcount). Whenever the
// list (a tile of `cap` entries) might not take the next step's rows, the
// warp walks it first:
//   - for each hop in order, the lanes take the list's entries densely, so
//     every hop's lookups are issued by full warps however few rows
//     survive; each entry's row handle goes to handles[hop][entry] in
//     shared memory (int32: a build row, or a folded hop's slot), and the
//     survivors are compacted, in order, in place;
//   - the residual, the group key and the lanes run over the last list, 32
//     entries at a time, through the aggregate kernels' warp folds:
//     `dense_fold_warp` (<= 64 slots in shared memory, a warp's rows of one
//     slot reduced before one shared atomic) or `hash_fold_step` (the
//     global table of hash_group_aggregate; the rows of one key are peers
//     and fold with one atomic a lane).
// No warp waits for another: the lists are the warp's own, and only
// __syncwarp orders them. The payload loads of the later hops, the
// residual, the keys and the lanes read each hop's handle from shared
// memory (`TileColumns`), so no thread holds a row handle a hop in
// registers. The output table has the aggregate kernels' layout, so
// compact_groups and the host emit run unchanged. The fold's lanes include
// count(DISTINCT x) through the global distinct set of program.cuh, in
// place of the reference's distinct slot (`_chain_slots` :1459-1460,
// row-space :2020), which takes one spine chunk of at most 2^21 rows
// (:445-449); lanes past 32 run as further passes of the walk, one launch
// a pass. Measured on an NVIDIA H100 (PERF.md): a block-wide tile
// (a __syncthreads a round of lookups) lost to the row walk on chains that
// every row crosses (Q5, Q8, Q18), and two lookups or four rows a lane at
// once spilled (416-1120 B of stack) and lost everywhere.
//
// Bounds. TPC-H Q5 at SF10 reads lineitem's l_suppkey, l_orderkey,
// l_extendedprice and l_discount (32 bytes a row, 60.0M rows, 1.92 GB),
// then per surviving row one table read and the payloads per hop: about
// 0.6 ms of streaming at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W.
// The gathers into tables far larger than the 50 MB L2 (orders: 60M
// slots) are random 4-byte reads that cost a 32-byte sector each; a
// predicate that keeps 1-2% of the rows (Q12, Q14) leaves the walk bound
// by the predicate's columns.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
// Four blocks an SM, so at most 64 registers a thread, as the row walks
// had (the full interpreter variant would take 80-104).
constexpr int kMinBlocks = 4;
// Spine rows a lane tests a step.
constexpr int kRowsPerStep = 2;

// Appends v where keep to the warp's `list`, whose first n entries are
// taken, after the lanes below; returns the new count, the same in every
// lane. Every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool keep, int v, int* list,
                                           int n) {
  const unsigned b = __ballot_sync(kWarp, keep);
  if (keep) list[n + __popc(b & ((1u << lane_id()) - 1u))] = v;
  return n + __popc(b);
}

// Column loads of the tile walk's pair space for list entry `e`: a spine
// column (hop_of < 0) at the row given, a payload column of hop h at the
// handle the walk stored for the entry (handles[h * cap + e]: its build
// row, or for a folded hop its slot times HOP_FOLD, the index of the
// record's first int64 word, the column's descriptor then pointing at the
// column's word of record 0 as an int64 column); a hop that found nothing
// reads as NULL.
template <bool Full, bool Staged>
struct TileColumns {
  static constexpr bool kFull = Full;
  const i64* meta;      // the descriptor in shared memory
  const int* handles;   // [hops][cap], the warp's
  int cap;
  int e;

  __device__ __forceinline__ i64 handle(int h) const {
    const int b = handles[h * cap + e];
    if (b < 0) return -1;
    if constexpr (Staged) {
      const i64* ch = meta + meta[H_OFF_CHAIN];
      const i64 f = ch[C_HOPS + h * kHopWords + HOP_FOLD];
      if (f) return (i64)b * f;
    }
    return b;
  }

  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    const i64* ch = meta + meta[H_OFF_CHAIN];
    const int h = (int)ch[ch[C_OFF_HOPOF] + idx];
    if (h >= 0) {
      row = handle(h);
      if (row < 0) {
        *v = 0;
        return false;
      }
    }
    return load_valid(meta + meta[H_OFF_COLS] + 3 * idx, row, v);
  }
};

// The folds of the walk's last stage: a row a lane, every lane of the warp
// calling.
struct DenseFold {
  const i64* meta;
  const i64* aux;
  u64* tab;
  template <class Columns>
  __device__ __forceinline__ void operator()(bool adm, i64 row,
                                             const Columns& cols) const {
    dense_fold_warp(meta, aux, adm, row, cols, tab);
  }
};

struct HashFold {
  const i64* meta;
  const i64* aux;
  i64 cap;
  int identity_slots;
  i64* table;
  int* overflow;
  HashFoldState* st;
  template <class Columns>
  __device__ __forceinline__ void operator()(bool adm, i64 row,
                                             const Columns& cols) const {
    hash_fold_step(meta, aux, adm, row, cols, cap, identity_slots, table,
                   overflow, nullptr, 0, st);
  }
};

// Which of the lane's R rows (row[r], those with alive[r]) pass the probe
// predicate, conjunct by conjunct: a direct conjunct loads its column for
// every row still alive at once, then tests them.
template <int R, class Columns>
__device__ __forceinline__ void admit_rows(const i64* meta, const i64* aux,
                                           const i64* ch, const i64 (&row)[R],
                                           bool (&alive)[R],
                                           const Columns& cols) {
  const i64* cj = ch + ch[C_OFF_CONJ];
  const int n = (int)ch[C_NCONJ];
  for (int c = 0; c < n; ++c, cj += kConjWords) {
    if ((int)cj[0] == CJ_PROG) {
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        i64 x;
        if (alive[r]) {
          alive[r] = run(meta, aux, (int)cj[1], row[r], cols, &x) && x != 0;
        }
      }
      continue;
    }
    i64 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (alive[r]) alive[r] = cols(cj[1], row[r], &x[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (alive[r]) alive[r] = conjunct_test(meta, aux, cj, x[r], row[r],
                                             cols);
    }
  }
}

// Walks the first n entries of the warp's `rows` (admitted spine rows)
// through the hops, then folds the survivors (see the top). `list` holds
// `cols.cap` entries, compacted in place hop after hop (a round reads its
// entries before it writes, and writes no further than it read), `handles`
// [hops][cap]; every lane of the warp calls it.
template <bool Full, bool Staged, class Fold>
__device__ __forceinline__ void walk_tile(const i64* meta, const i64* aux,
                                          const int* rows, int n, int* list,
                                          int* handles,
                                          TileColumns<Full, Staged>& cols,
                                          const Fold& fold) {
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const int n_hops = (int)ch[C_NHOPS];
  const int cap = cols.cap;
  const int width = __popc(warp_members());
  const int lane = lane_id();
  bool dense = true;   // the list is still rows[0..n) in order
  int m = n;
  for (int h = 0; h < n_hops && m > 0; ++h) {
    const i64* hop = ch + C_HOPS + h * kHopWords;
    int kept = 0;
    for (int i0 = 0; i0 < m; i0 += width) {
      const int i = i0 + lane;
      const int e = i < m ? (dense ? i : list[i]) : 0;
      bool keep = false;
      if (i < m) {
        cols.e = e;
        const i64 row = rows[e];
        i64 slot = 0;
        i64 b;
        if constexpr (Staged) {
          b = hop[HOP_KIND] == TAB_COMPOSED
                  ? composed_row(hop, cols.handle((int)hop[HOP_OWNER]), &slot)
                  : hop_lookup<true>(meta, aux, hop, row, cols, &slot);
        } else {
          b = hop_lookup<false>(meta, aux, hop, row, cols, &slot);
        }
        if constexpr (Full) {
          if (b >= 0 && hop[HOP_MOP] >= 0 &&
              !mmx_exists(meta, aux, hop, row, cols, slot)) {
            b = -1;
          }
        }
        keep = (int)hop[HOP_JTYPE] == JT_ANTI ? b < 0 : b >= 0;
        if constexpr (Staged) {
          if (hop[HOP_FOLD] && b >= 0) b = slot;
        }
        handles[h * cap + e] = b < 0 ? -1 : (int)b;
      }
      __syncwarp();
      kept = warp_append(keep, e, list, kept);
    }
    __syncwarp();
    dense = false;
    m = kept;
  }
  for (int i0 = 0; i0 < m; i0 += width) {
    const int i = i0 + lane;
    bool adm = false;
    i64 row = 0;
    if (i < m) {
      cols.e = dense ? i : list[i];
      row = rows[cols.e];
      i64 x;
      adm = meta[H_PRED] < 0 ||
            (run(meta, aux, (int)meta[H_PRED], row, cols, &x) && x != 0);
    }
    fold(adm, row, cols);
  }
  __syncwarp();
}

// The warp's share of the walk: steps of kRowsPerStep x 32 spine rows,
// grid-strided by warp, their admitted rows appended to the warp's lists
// (2 + hops lists of `cap` int32 from lists + warp x (2 + hops) x cap: the
// rows, the compacted list, the handles), the list walked (`walk_tile`)
// before a step that might not fit and at the end.
template <bool Full, bool Staged, class Fold>
__device__ __forceinline__ void tile_walk(const i64* meta, const i64* aux,
                                          i64 n_rows, int cap, int* lists,
                                          const Fold& fold) {
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const int n_hops = (int)ch[C_NHOPS];
  int* rows = lists + (threadIdx.x >> 5) * (2 + n_hops) * cap;
  int* list = rows + cap;
  int* handles = rows + 2 * cap;
  TileColumns<Full, Staged> cols{meta, handles, cap, 0};
  const int width = __popc(warp_members());
  const i64 per_block = (blockDim.x + 31) >> 5;
  const i64 warp = (i64)blockIdx.x * per_block + (threadIdx.x >> 5);
  const i64 step = (i64)width * kRowsPerStep;
  int n = 0;
  for (i64 base = warp * step; base < n_rows;
       base += (i64)gridDim.x * per_block * step) {
    // nothing of the step lives across a walk
    if (n > cap - step) {
      __syncwarp();
      walk_tile(meta, aux, rows, n, list, handles, cols, fold);
      n = 0;
    }
    i64 row[kRowsPerStep];
    bool keep[kRowsPerStep];
#pragma unroll
    for (int r = 0; r < kRowsPerStep; ++r) {
      row[r] = base + r * width + lane_id();
      keep[r] = row[r] < n_rows;
    }
    admit_rows(meta, aux, ch, row, keep, cols);
#pragma unroll
    for (int r = 0; r < kRowsPerStep; ++r) {
      n = warp_append(keep[r], (int)row[r], rows, n);
    }
  }
  if (n > 0) {
    __syncwarp();
    walk_tile(meta, aux, rows, n, list, handles, cols, fold);
  }
}

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_dense_kernel(const i64* __restrict__ meta_g, int meta_len,
                   const i64* __restrict__ aux, i64 n_rows, int list_cap,
                   u64* __restrict__ table_g) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  u64* tab = (u64*)(smem + meta_len);
  dense_init(smem, tab);
  const int words = ((int)smem[H_NLANES] + 1) * (int)smem[H_G];
  tile_walk<Full, Staged>(smem, aux, n_rows, list_cap, (int*)(tab + words),
                          DenseFold{smem, aux, tab});
  dense_merge(smem, tab, table_g);
}

template <bool Full, bool Staged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_hash_kernel(const i64* __restrict__ meta_g, int meta_len,
                  const i64* __restrict__ aux, i64 n_rows, int list_cap,
                  i64 cap, int identity_slots, i64* __restrict__ table,
                  int* __restrict__ overflow) {
  extern __shared__ i64 smem[];
  __shared__ HashFoldState st;
  stage_meta(smem, meta_g, meta_len);
  hash_fold_begin(&st, 0);
  tile_walk<Full, Staged>(smem, aux, n_rows, list_cap,
                          (int*)(smem + meta_len),
                          HashFold{smem, aux, cap, identity_slots, table,
                                   overflow, &st});
}

// The blocks of a walk: as many as the card holds at once (the walk is
// grid-strided), at most one a step of the block's warps.
template <class Kernel>
unsigned walk_blocks(Kernel kernel, size_t smem, long long n_rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem) != cudaSuccess || per_sm < 1) {
    per_sm = 1;
  }
  long long blocks = (long long)(sms > 0 ? sms : 132) * per_sm;
  const long long steps = (n_rows + kThreads * kRowsPerStep - 1) /
                          (kThreads * kRowsPerStep);
  if (blocks > steps) blocks = steps;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// meta: device int64 descriptor of meta_len words with its chain section
// (join_chain.py); aux: device int64 per-batch inputs. mode 0: the dense
// table int64 [n_lanes + 1][groups]; mode 1 (the packed key is the slot)
// and 2 (probed): the hash table int64 [n_lanes + 2][cap] and the int32
// overflow flag, as dft_hash_group_aggregate takes them; variant: bit 0
// the programs or a min/max hop need the interpreter's full variant, bit 1
// the chain has composed or folded hops; n_hops: the chain's hops;
// list_cap: the entries of a warp's lists, at least a step's rows
// (kRowsPerStep x 32). One launch on `stream`; returns cudaGetLastError()
// (or the error of the shared-memory attribute).
extern "C" int dft_chain_aggregate(const void* meta, int meta_len,
                                   int n_lanes, int groups, const void* aux,
                                   long long n_rows, long long cap, int mode,
                                   void* table, void* overflow, int variant,
                                   int n_hops, int list_cap, void* stream) {
  const size_t lists =
      (size_t)(kThreads / 32) * (2 + n_hops) * list_cap * sizeof(int);
  if (mode == 0) {
    const size_t smem =
        (size_t)(meta_len + (n_lanes + 1) * groups) * 8 + lists;
    const auto kernel = DFT_WALK_VARIANT(chain_dense_kernel, variant);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<walk_blocks(kernel, smem, n_rows), kThreads, smem,
             (cudaStream_t)stream>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_rows, list_cap,
        (u64*)table);
  } else {
    const size_t smem = (size_t)meta_len * 8 + lists;
    const auto kernel = DFT_WALK_VARIANT(chain_hash_kernel, variant);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<walk_blocks(kernel, smem, n_rows), kThreads, smem,
             (cudaStream_t)stream>>>(
        (const i64*)meta, meta_len, (const i64*)aux, n_rows, list_cap, cap,
        mode == 1 ? 1 : 0, (i64*)table, (int*)overflow);
  }
  return (int)cudaGetLastError();
}
