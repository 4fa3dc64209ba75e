// exchange: the two kernels of the mesh (datafusion_tpu_torch/parallel/).
//
// K1 partition_rows: the rows one shard sends to every shard in a round of
// an all_to_all, bucketed by destination into one send buffer. Replaces
// the JAX package's owner hash (parallel/exchange.py:73 `_owner` over
// distributed.py:56 `_splitmix64_jnp`) and the row bucketing of
// `_all_to_all_rows` (:96-139) and of `_all_to_all_chained`'s `round_ship`
// (:158-198): a stable argsort on the destination, searchsorted starts and
// gathers into fixed [n_shards, cap] blocks, shipped whole. Here the sizes
// are exact, three steps over the shard's rows in tiles:
//   1. hist: each pending row's owner, splitmix64(key) mod n_dest taken as
//      unsigned 64-bit values (salted: of key * 0x100000001B3 + s, in
//      wraparound, before the finalizer), counted per (destination, tile)
//      in shared memory, one shared atomic per destination a warp
//      (__match_any_sync); each destination's total goes to `totals`.
//   2. the exclusive scan of scan.cuh over the (destination, tile) counts,
//      destination-major: where each tile's rows of a destination start.
//   3. scatter: each tile's pending rows ranked within their destination
//      in row order (a warp ranks with __match_any_sync, the block's warps
//      through a shared table, blockDim rows at a time). A row whose rank
//      is below `cap` goes to its destination's block of the send buffer,
//      which starts at the sum of min(total, cap) of the destinations
//      before it; every lane is copied at its width (1, 2, 4 or 8 bytes),
//      the key too (salted: as key * salt + s, the key the receiver joins
//      on), and the row's pending flag is cleared. Rows past the cap stay
//      pending for the next round, so a skewed destination costs rounds,
//      never a larger buffer.
// Order: stable. A destination's rows leave in row order, the first `cap`
// of them this round; so the plain version, a stable sort, gives the same
// send buffer.
//
// K2 merge_partials: (key, count, lane...) entries folded into an owner's
// group table in the hash layout of hash_group_aggregate.cu ([rows, cap]
// int64: row 0 the keys, EMPTY = -1; row 1 the counts; then the lanes).
// Replaces the JAX package's owner fold: the ownership filter and final
// `device_group_aggregate` of distributed.py's three steps (:99-114,
// :183-189, :267-276) and exchange.py's `_merge_fold` (:218-233), which
// re-sorts the whole table with every round's arrivals. Each entry with a
// key (and, with n_owner > 0, whose owner splitmix64(key) mod n_owner is
// `my`: the all_gather route's inline ownership test) claims its slot with
// program.cuh's `claim_slot` and folds its count and every lane with the
// lane's own merge (`fold`: counts and sums add, min and max take the
// least and greatest). A slot claimed fresh adds one to `groups`; past
// `limit` distinct keys (the caller's final_groups_per_shard) the
// overflow flag is set, as it is when the table is full.
//
// Bounds. K1 reads each pending row's key (and flag) twice and its lanes
// once and writes each lane once: TPC-H SF10's lineitem probe of the
// partitioned join (60M rows, a packed key and one int64 lane) moves about
// 1.9 GB, 0.57 ms at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W
// data sheet). K2 reads each entry once and writes each owned group's
// cells once.

#include <stdint.h>

#include "program.cuh"
#include "scan.cuh"

namespace {

constexpr int kXThreads = 256;
constexpr int kXWarps = kXThreads / 32;
constexpr int kMaxDest = 256;          // shards of a mesh
constexpr int kMaxXLanes = 32;         // lanes one scatter pass moves
constexpr u64 kSaltMul = 0x100000001B3ull;

struct XLanes {
  const void* src[kMaxXLanes];
  void* dst[kMaxXLanes];
  int width[kMaxXLanes];
  int n_lanes;
};

// The destination of `key` at local row `row`, and the key it travels as.
// salt_mode 1: s = row % salt (a probe row); 2: s = salt_r (a replica of
// the build side).
__device__ __forceinline__ int owner_of(i64 key, i64 row, int n_dest,
                                        int salt, int salt_mode, i64 salt_r,
                                        i64* out_key) {
  if (salt <= 1) {
    *out_key = key;
    return (int)(splitmix64((u64)key) % (u64)n_dest);
  }
  const u64 s = salt_mode == 1 ? (u64)(row % salt) : (u64)salt_r;
  *out_key = (i64)((u64)key * (u64)salt + s);
  return (int)(splitmix64((u64)key * kSaltMul + s) % (u64)n_dest);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// counts[d * n_tiles + t] = the pending rows of tile t owned by d; totals[d]
// += the same over the tile
__global__ void __launch_bounds__(kXThreads)
partition_hist_kernel(const i64* __restrict__ keys,
                      const uint8_t* __restrict__ pending, i64 n, int n_dest,
                      int salt, int salt_mode, i64 salt_r, i64 tile,
                      i64 n_tiles, i64* __restrict__ counts,
                      u64* __restrict__ totals) {
  __shared__ unsigned h[kMaxDest];
  for (i64 t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int d = threadIdx.x; d < n_dest; d += blockDim.x) h[d] = 0;
    __syncthreads();
    const i64 lo = t * tile, hi = lo + tile < n ? lo + tile : n;
    for (i64 base = lo; base < hi; base += blockDim.x) {
      const i64 i = base + threadIdx.x;
      int d = n_dest;                     // no row: a group of its own
      if (i < hi && pending[i]) {
        i64 k;
        d = owner_of(keys[i], i, n_dest, salt, salt_mode, salt_r, &k);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < n_dest && (peers & lanes_below()) == 0) {
        atomicAdd(&h[d], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
      counts[(i64)d * n_tiles + t] = h[d];
      if (h[d]) atomicAdd(&totals[d], (u64)h[d]);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void move(const XLanes& x, int l, i64 to,
                                     i64 from) {
  ((T*)x.dst[l])[to] = ((const T*)x.src[l])[from];
}

// Step 3 (see the top): offsets are the scanned counts, totals the
// destinations' totals. The flags are cleared only when `clear` (the last
// pass of a partition whose lanes take several).
__global__ void __launch_bounds__(kXThreads)
partition_scatter_kernel(const i64* __restrict__ keys,
                         uint8_t* __restrict__ pending, i64 n, int n_dest,
                         int salt, int salt_mode, i64 salt_r, i64 tile,
                         i64 n_tiles, const i64* __restrict__ offsets,
                         const u64* __restrict__ totals, i64 cap,
                         const XLanes x, i64* __restrict__ key_out,
                         int clear) {
  __shared__ unsigned warp_count[kXWarps][kMaxDest];
  __shared__ i64 running[kMaxDest];
  __shared__ i64 send_off[kMaxDest];
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (threadIdx.x == 0) {
    i64 s = 0;
    for (int d = 0; d < n_dest; ++d) {
      send_off[d] = s;
      s += (i64)totals[d] < cap ? (i64)totals[d] : cap;
    }
  }
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
    for (int w = 0; w < n_warps; ++w) warp_count[w][d] = 0;
  }
  __syncthreads();
  for (i64 t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
      running[d] = offsets[(i64)d * n_tiles + t] -
                   offsets[(i64)d * n_tiles];
    }
    __syncthreads();
    const i64 lo = t * tile, hi = lo + tile < n ? lo + tile : n;
    for (i64 base = lo; base < hi; base += blockDim.x) {
      const i64 i = base + threadIdx.x;
      const bool ok = i < hi && pending[i];
      int d = n_dest;
      i64 k = 0;
      if (ok) d = owner_of(keys[i], i, n_dest, salt, salt_mode, salt_r, &k);
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const unsigned rank = __popc(peers & lanes_below());
      if (ok && rank == 0) warp_count[warp][d] = __popc(peers);
      __syncthreads();
      if (ok) {
        i64 r = running[d] + rank;
        for (int w = 0; w < warp; ++w) r += warp_count[w][d];
        if (r < cap) {
          const i64 pos = send_off[d] + r;
          for (int l = 0; l < x.n_lanes; ++l) {
            switch (x.width[l]) {
              case 1: move<uint8_t>(x, l, pos, i); break;
              case 2: move<uint16_t>(x, l, pos, i); break;
              case 4: move<uint32_t>(x, l, pos, i); break;
              default: move<u64>(x, l, pos, i); break;
            }
          }
          if (key_out != nullptr) key_out[pos] = k;
          if (clear) pending[i] = 0;
        }
      }
      __syncthreads();
      for (int dd = threadIdx.x; dd < n_dest; dd += blockDim.x) {
        i64 s = 0;
        for (int w = 0; w < n_warps; ++w) {
          s += warp_count[w][dd];
          warp_count[w][dd] = 0;
        }
        running[dd] += s;
      }
      __syncthreads();
    }
  }
}

// K2: entries [rows, m] (row 0 keys, row 1 counts, then rows - 2 lanes of
// the kinds `kinds`) folded into table [rows, cap]
__global__ void __launch_bounds__(kXThreads)
merge_partials_kernel(const i64* __restrict__ entries, i64 m, int rows,
                      const i64* __restrict__ kinds, int my, int n_owner,
                      i64* __restrict__ table, i64 cap,
                      u64* __restrict__ groups, i64 limit,
                      int* __restrict__ overflow) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += stride) {
    const i64 key = entries[j];
    if (key == kEmpty) continue;
    if (n_owner > 0 && (int)(splitmix64((u64)key) % (u64)n_owner) != my) {
      continue;
    }
    bool fresh;
    const i64 slot = claim_slot(table, cap, key, &fresh);
    if (slot < 0) {
      *overflow = 1;
      continue;
    }
    if (fresh && atomicAdd(groups, 1ull) >= (u64)limit) *overflow = 1;
    fold(LANE_ROWS, (u64*)&table[cap + slot], entries[m + j]);
    for (int l = 0; l < rows - 2; ++l) {
      fold((int)kinds[l], (u64*)&table[(i64)(2 + l) * cap + slot],
           entries[(i64)(2 + l) * m + j]);
    }
  }
}

inline i64 n_tiles_of(i64 n, i64 tile) {
  const i64 t = (n + tile - 1) / tile;
  return t > 0 ? t : 1;
}

}  // namespace

// Step 1 of K1 over n rows in tiles of `tile` rows. counts: device int64
// [n_dest * n_tiles]; totals: device int64 [n_dest] zeroed by the caller.
// One launch; returns cudaGetLastError().
extern "C" int dft_partition_hist(const void* keys, const void* pending,
                                  long long n, int n_dest, int salt,
                                  int salt_mode, long long salt_r,
                                  long long tile, void* counts,
                                  void* totals, void* stream) {
  const i64 nt = n_tiles_of(n, tile);
  partition_hist_kernel<<<grid_for(nt * tile, kXThreads) < nt
                              ? grid_for(nt * tile, kXThreads)
                              : (unsigned)nt,
                          kXThreads, 0, (cudaStream_t)stream>>>(
      (const i64*)keys, (const uint8_t*)pending, n, n_dest, salt, salt_mode,
      salt_r, tile, nt, (i64*)counts, (u64*)totals);
  return (int)cudaGetLastError();
}

// Steps 2 and 3 of K1: the scan of counts (sums: scratch of
// scan_tiles(n_dest * n_tiles) words), then one scatter launch a pass of
// at most 32 lanes (src, dst: device pointers; width: bytes a row);
// key_out: device int64, or null. The last pass clears the sent rows'
// flags. Returns the first error.
extern "C" int dft_partition_scatter(const void* keys, void* pending,
                                     long long n, int n_dest, int salt,
                                     int salt_mode, long long salt_r,
                                     long long tile, void* counts,
                                     void* sums, const void* totals,
                                     long long cap, int n_lanes,
                                     const void* const* src,
                                     void* const* dst, const int* width,
                                     void* key_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const i64 nt = n_tiles_of(n, tile);
  cudaError_t err = exclusive_scan((i64*)counts, (i64)n_dest * nt,
                                   (i64*)sums, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = grid_for(nt * tile, kXThreads) < nt
                            ? grid_for(nt * tile, kXThreads)
                            : (unsigned)nt;
  int at = 0;
  do {
    XLanes x;
    x.n_lanes = n_lanes - at < kMaxXLanes ? n_lanes - at : kMaxXLanes;
    for (int l = 0; l < x.n_lanes; ++l) {
      x.src[l] = src[at + l];
      x.dst[l] = dst[at + l];
      x.width[l] = width[at + l];
    }
    const bool last = at + x.n_lanes >= n_lanes;
    partition_scatter_kernel<<<grid, kXThreads, 0, st>>>(
        (const i64*)keys, (uint8_t*)pending, n, n_dest, salt, salt_mode,
        salt_r, tile, nt, (const i64*)counts, (const u64*)totals, cap, x,
        at == 0 ? (i64*)key_out : nullptr, last ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    at += x.n_lanes;
  } while (at < n_lanes);
  return 0;
}

// K2: entries device int64 [rows, m]; kinds device int64 [rows - 2];
// table device int64 [rows, cap] (cap a power of two; keys EMPTY or
// claimed); groups device int64 [1]; overflow device int32 [1]. One
// launch.
extern "C" int dft_merge_partials(const void* entries, long long m, int rows,
                                  const void* kinds, int my, int n_owner,
                                  void* table, long long cap, void* groups,
                                  long long limit, void* overflow,
                                  void* stream) {
  merge_partials_kernel<<<grid_blocks(m, kXThreads), kXThreads, 0,
                          (cudaStream_t)stream>>>(
      (const i64*)entries, m, rows, (const i64*)kinds, my, n_owner,
      (i64*)table, cap, (u64*)groups, limit, (int*)overflow);
  return (int)cudaGetLastError();
}
