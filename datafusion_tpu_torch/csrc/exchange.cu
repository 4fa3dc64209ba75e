// exchange: the two kernels of the mesh (datafusion_tpu_torch/parallel/).
//
// K1 partition_rows: the rows one shard sends to every shard in a round of
// an all_to_all, bucketed by destination into one send buffer. Replaces
// the JAX package's owner hash (parallel/exchange.py:73 `_owner` over
// distributed.py:56 `_splitmix64_jnp`) and the row bucketing of
// `_all_to_all_rows` (:96-139) and of `_all_to_all_chained`'s `round_ship`
// (:158-198): a stable argsort on the destination, searchsorted starts and
// gathers into fixed [n_shards, cap] blocks, shipped whole. Here the sizes
// are exact, in two launches over the shard's rows:
//   1. count: each pending row's owner, splitmix64(key) mod n_dest taken
//      as unsigned 64-bit values (salted: of key * 0x100000001B3 + s, in
//      wraparound, before the finalizer), counted per destination in
//      shared memory, one shared atomic per destination a warp (its rows'
//      peers), then one global atomic per destination a block, into
//      `totals`. The caller reads the totals back to size the buffer.
//   2. sweep: one pass in tiles of kXTile rows, taken in order by a ticket
//      so that every earlier tile's block has started. A tile computes each
//      row's owner once and ranks its rows within their destination in row
//      order: each warp takes a contiguous run of the tile, 32 rows a step,
//      and finds a row's peers by ballots on the owner's bits where n_dest
//      is a power of two of at most 32 (by __match_any_sync otherwise),
//      its running count a destination in shared memory. The warps' counts
//      give the tile's count a destination, published at once as an
//      aggregate; a decoupled look-back over the tiles before
//      (lookback.cuh, one status word a tile and destination) gives where
//      the tile's rows of each destination start among all of them. The
//      tile then stages its rows in shared memory in destination order, so
//      that each destination's run leaves as contiguous lines. A row whose
//      rank is below `cap` goes to its destination's block of the send
//      buffer, which starts at the sum of min(total, cap) of the
//      destinations before it; every lane is copied at its width (1, 2, 4
//      or 8 bytes), the key too (salted: as key * salt + s, the key the
//      receiver joins on), and the row's pending flag is cleared. Rows past
//      the cap stay pending for the next round, so a skewed destination
//      costs rounds, never a larger buffer. More than 32 lanes take a sweep
//      a pass of 32, each with its own ticket and epoch.
// Order: stable. A destination's rows leave in row order, the first `cap`
// of them this round; so the plain version, a stable sort, gives the same
// send buffer.
//
// K2 merge_partials: (key, count, lane...) entries folded into the local
// shards' group tables, in the hash layout of hash_group_aggregate.cu
// ([rows, cap] int64 a table: row 0 the keys, EMPTY = -1; row 1 the
// counts; then the lanes; the tables of one call back to back). Replaces
// the JAX package's owner fold: the ownership filter and final
// `device_group_aggregate` of distributed.py's three steps (:99-114,
// :183-189, :267-276) and exchange.py's `_merge_fold` (:218-233), which
// re-sorts the whole table with every round's arrivals. One launch serves
// every local shard (a LocalMesh holds 4): on the all_gather route it
// reads the gathered entries once and sends each to the table of its
// owner, splitmix64(key) mod n_owner (a mask when n_owner is a power of
// two), skipping an entry whose owner is not local; on the shuffle route
// the block's y index picks the shard, whose arrivals fold into its own
// table. Each entry with a key claims its slot with program.cuh's
// `claim_slot` and folds its count and every lane with the lane's own
// merge (`fold`: counts and sums add, min and max take the least and
// greatest); the lane kinds travel in the launch's parameters and sit in
// shared memory. A warp counts its fresh claims a table by ballot and
// adds them to the table's `groups` with one atomic; past `limit`
// distinct keys (the caller's final_groups_per_shard) the table's
// overflow flag is set, as it is when the table is full.
//
// Bounds. K1 must read each row's key, flag and lanes once and write each
// sent row's key, lanes and flag once: TPC-H SF10's lineitem probe of the
// partitioned join on 4 shards (a shard of 14,999,417 rows, a packed key
// and one int64 lane) moves about 0.51 GB, 0.15 ms at the 3.35 TB/s of an
// NVIDIA H100 80GB HBM3 (700 W data sheet); the count reads the keys and
// flags a second time (0.14 GB). K2 reads each entry once and writes each
// owned group's cells once: MQ15 SF10's shuffle round on 4 shards, about
// 0.4M entries of 4 words into 0.1M groups, moves about 16 MB, 0.005 ms.

#include <stdint.h>

#include "lookback.cuh"
#include "program.cuh"

namespace {

constexpr int kXThreads = 256;
constexpr int kXWarps = kXThreads / 32;
constexpr int kXTile = 2048;           // rows a tile of the sweep
constexpr int kMaxDest = 256;          // shards of a mesh
constexpr int kMaxXLanes = 32;         // lanes one sweep moves
constexpr u64 kSaltMul = 0x100000001B3ull;
constexpr unsigned kNoRow = 0xffffffffu;
constexpr int kUnroll = 4;             // rows a thread has in flight
constexpr int kSweepBlocks = 6;        // blocks an SM: 40 registers at most

struct XLanes {
  const void* src[kMaxXLanes];
  void* dst[kMaxXLanes];
  int width[kMaxXLanes];
  int n_lanes;
};

// The key row `row` travels as: salt_mode 1: s = row % salt (a probe
// row); 2: s = salt_r (a replica of the build side).
__device__ __forceinline__ i64 travel_key(i64 key, i64 row, int salt,
                                          int salt_mode, i64 salt_r) {
  if (salt <= 1) return key;
  const u64 s = salt_mode == 1 ? (u64)(row % salt) : (u64)salt_r;
  return (i64)((u64)key * (u64)salt + s);
}

// The destination of `key` at local row `row` (a power of two of
// destinations by a mask, the same remainder).
__device__ __forceinline__ int owner_of(i64 key, i64 row, int n_dest,
                                        int salt, int salt_mode, i64 salt_r) {
  u64 h;
  if (salt <= 1) {
    h = splitmix64((u64)key);
  } else {
    const u64 s = salt_mode == 1 ? (u64)(row % salt) : (u64)salt_r;
    h = splitmix64((u64)key * kSaltMul + s);
  }
  return (int)((n_dest & (n_dest - 1)) == 0 ? h & (u64)(n_dest - 1)
                                            : h % (u64)n_dest);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The lanes of the calling warp whose rows go where this lane's row goes
// (0 for a lane without a row): ballots on the destination's bits where
// n_dest is a power of two of at most 32, __match_any_sync otherwise.
// Every lane of the warp calls it.
__device__ __forceinline__ unsigned dest_peers(int d, bool ok, int n_dest) {
  unsigned peers;
  if (n_dest <= 32 && (n_dest & (n_dest - 1)) == 0) {
    peers = __ballot_sync(kWarp, ok);
    for (int b = 1; b < n_dest; b <<= 1) {
      const unsigned set = __ballot_sync(kWarp, (d & b) != 0);
      peers &= (d & b) ? set : ~set;
    }
  } else {
    peers = __match_any_sync(kWarp, ok ? d : -1);
  }
  return ok ? peers : 0u;
}

// Step 1 (see the top): totals[d] += the pending rows owned by d.
__global__ void __launch_bounds__(kXThreads)
partition_count_kernel(const i64* __restrict__ keys,
                       const uint8_t* __restrict__ pending, i64 n,
                       int n_dest, int salt, int salt_mode, i64 salt_r,
                       u64* __restrict__ totals) {
  __shared__ unsigned h[kMaxDest];
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) h[d] = 0;
  __syncthreads();
  // kUnroll rows a thread a round, their loads out together
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i0 = (i64)blockIdx.x * blockDim.x + threadIdx.x;
       i0 - (threadIdx.x & 31) < n; i0 += stride * kUnroll) {
    i64 k[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 i = i0 + u * stride;
      ok[u] = i < n && pending[i];
      k[u] = ok[u] ? keys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const i64 i = i0 + u * stride;
      const int d = ok[u] ? owner_of(k[u], i, n_dest, salt, salt_mode, salt_r)
                          : 0;
      const unsigned peers = dest_peers(d, ok[u], n_dest);
      if (ok[u] && (peers & lanes_below()) == 0) {
        atomicAdd(&h[d], (unsigned)__popc(peers));
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
    if (h[d]) atomicAdd(&totals[d], (u64)h[d]);
  }
}

template <typename T>
__device__ __forceinline__ void move(const XLanes& x, int l, i64 to,
                                     i64 from) {
  ((T*)x.dst[l])[to] = ((const T*)x.src[l])[from];
}

// Step 2 (see the top): totals from step 1; status: n_tiles * n_dest words
// and *ticket, zeroed before the first pass, `epoch` the pass's (1, 2,
// ...). The flags are cleared only when `clear` (the last pass of a
// partition whose lanes take several).
__global__ void __launch_bounds__(kXThreads, kSweepBlocks)
partition_sweep_kernel(const i64* __restrict__ keys,
                       uint8_t* __restrict__ pending, i64 n, int n_dest,
                       int salt, int salt_mode, i64 salt_r,
                       const u64* __restrict__ totals, i64 cap,
                       const XLanes x, i64* __restrict__ key_out, int clear,
                       u64* __restrict__ status, u64* __restrict__ ticket,
                       u64 epoch) {
  // per tile row: its destination << 16 | its rank in its warp's run, then
  // in destination order: destination << 16 | the tile row
  __shared__ unsigned info[kXTile];
  __shared__ unsigned stage[kXTile];
  // per warp and destination: the warp's rows, then those of the warps
  // before it in the tile
  __shared__ unsigned short wcount[kXWarps][kMaxDest];
  __shared__ unsigned count[kMaxDest];
  __shared__ unsigned start[kMaxDest + 1];   // a destination's stage run
  __shared__ i64 prefix[kMaxDest];           // its rows in earlier tiles
  __shared__ i64 send_off[kMaxDest];
  __shared__ i64 tile_s;
  if (threadIdx.x == 0) {
    i64 s = 0;
    for (int d = 0; d < n_dest; ++d) {
      send_off[d] = s;
      s += (i64)totals[d] < cap ? (i64)totals[d] : cap;
    }
  }
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int per_warp = kXTile / nw;
  const int width = __popc(warp_members());
  const i64 n_tiles = (n + kXTile - 1) / kXTile;
  for (;;) {
    if (threadIdx.x == 0) tile_s = (i64)atomicAdd(ticket, 1ull);
    __syncthreads();
    const i64 t = tile_s;
    if (t >= n_tiles) break;
    const i64 base = t * kXTile;
    for (int k = threadIdx.x; k < nw * n_dest; k += blockDim.x) {
      wcount[k / n_dest][k % n_dest] = 0;
    }
    __syncthreads();
    // each row's owner once, kUnroll steps' loads out together
    for (int s0 = 0; s0 < per_warp; s0 += width * kUnroll) {
      i64 k[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const i64 i = base + warp * per_warp + s0 + u * width + lane_id();
        ok[u] = i < n && pending[i];
        k[u] = ok[u] ? keys[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = warp * per_warp + s0 + u * width + lane_id();
        info[r] = ok[u] ? (unsigned)owner_of(k[u], base + r, n_dest, salt,
                                             salt_mode, salt_r)
                        : kNoRow;
      }
    }
    __syncwarp();
    // each row's rank in its warp's run of its destination
    for (int s = 0; s < per_warp; s += width) {
      const int r = warp * per_warp + s + lane_id();
      const unsigned v = info[r];
      const bool ok = v != kNoRow;
      const int d = ok ? (int)v : 0;
      const unsigned peers = dest_peers(d, ok, n_dest);
      const unsigned below = peers & lanes_below();
      const unsigned rank = ok ? wcount[warp][d] + __popc(below) : 0;
      __syncwarp();
      if (ok && below == 0) wcount[warp][d] += __popc(peers);
      __syncwarp();
      if (ok) info[r] = (unsigned)d << 16 | rank;
    }
    __syncthreads();
    // each destination's count in the tile, published at once, and the
    // warps' offsets within it
    for (int d = threadIdx.x; d < n_dest; d += blockDim.x) {
      unsigned c = 0;
      for (int w = 0; w < nw; ++w) {
        const unsigned k = wcount[w][d];
        wcount[w][d] = (unsigned short)c;
        c += k;
      }
      store_status(status + t * n_dest + d,
                   status_word(t == 0 ? kInclusive : kAggregate, epoch, c));
      count[d] = c;
      prefix[d] = 0;
    }
    __syncthreads();
    // where the tile's rows of each destination start: a warp's look-back
    // a destination
    if (t > 0) {
      for (int d = warp; d < n_dest; d += nw) {
        const i64 before = warp_look_back(status + d, t, n_dest, epoch);
        if (lane_id() == 0) {
          prefix[d] = before;
          store_status(status + t * n_dest + d,
                       status_word(kInclusive, epoch, (u64)before + count[d]));
        }
      }
    }
    if (threadIdx.x == 0) {
      unsigned s = 0;
      for (int d = 0; d < n_dest; ++d) {
        start[d] = s;
        s += count[d];
      }
      start[n_dest] = s;
    }
    __syncthreads();
    // rows in destination order; a sent row's flag cleared in row order
    for (int r = threadIdx.x; r < kXTile; r += blockDim.x) {
      const unsigned v = info[r];
      if (v == kNoRow) continue;
      const int d = (int)(v >> 16);
      const unsigned at = wcount[r / per_warp][d] + (v & 0xffffu);
      stage[start[d] + at] = (unsigned)d << 16 | (unsigned)r;
      if (clear && prefix[d] + at < cap) pending[base + r] = 0;
    }
    __syncthreads();
    const int total = (int)start[n_dest];
    for (int p0 = 0; p0 < total; p0 += blockDim.x * kUnroll) {
      // kUnroll rows a thread, their reads out together
      i64 i[kUnroll], pos[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * blockDim.x + threadIdx.x;
        pos[u] = -1;
        if (p < total) {
          const unsigned v = stage[p];
          const int d = (int)(v >> 16);
          const i64 g = prefix[d] + (p - (int)start[d]);
          i[u] = base + (v & 0xffffu);
          if (g < cap) pos[u] = send_off[d] + g;
        }
      }
      for (int l = 0; l < x.n_lanes; ++l) {
        const int w = x.width[l];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (pos[u] < 0) continue;
          switch (w) {
            case 1: move<uint8_t>(x, l, pos[u], i[u]); break;
            case 2: move<uint16_t>(x, l, pos[u], i[u]); break;
            case 4: move<uint32_t>(x, l, pos[u], i[u]); break;
            default: move<u64>(x, l, pos[u], i[u]); break;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (pos[u] < 0) continue;
        if (key_out != nullptr) {
          key_out[pos[u]] = travel_key(keys[i[u]], i[u], salt, salt_mode,
                                       salt_r);
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kMaxMergeTables = 16;     // local tables a launch
constexpr int kMaxMergeLanes = 4096;    // groupby.py MAX_ALL_LANES

// A K2 launch's sources and lane kinds (device/exchange.py `_MergeArgs`)
struct MergeArgs {
  const i64* entries[kMaxMergeTables];  // a source's [rows, m] entries
  i64 m[kMaxMergeTables];
  int n_tables;
  int n_owner;   // > 0: one source, each entry to table owner - first
  int first;
  int rows;
  unsigned char kinds[kMaxMergeLanes / 2];   // lane l: nibble l & 1 of l / 2
};

// K2: source blockIdx.y's entries folded into `tables` ([n_tables][rows]
// [cap]); groups and overflow: a word a table
__global__ void __launch_bounds__(kXThreads)
merge_partials_kernel(const MergeArgs a, i64* __restrict__ tables, i64 cap,
                      u64* __restrict__ groups, i64 limit,
                      u64* __restrict__ overflow) {
  __shared__ unsigned char kind[kMaxMergeLanes];
  const int lanes = a.rows - 2;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    kind[l] = (a.kinds[l >> 1] >> (4 * (l & 1))) & 15;
  }
  __syncthreads();
  const int y = blockIdx.y;
  const i64* e = a.entries[y];
  const i64 m = a.m[y];
  const int lane = threadIdx.x & 31;
  const bool pow2 = (a.n_owner & (a.n_owner - 1)) == 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  // a warp's lanes take consecutive entries and leave the loop together
  for (i64 j0 = (i64)blockIdx.x * blockDim.x + (threadIdx.x & ~31); j0 < m;
       j0 += stride) {
    const i64 j = j0 + lane;
    const i64 key = j < m ? e[j] : kEmpty;
    int t = key == kEmpty ? -1 : y;
    if (t >= 0 && a.n_owner > 0) {
      const u64 h = splitmix64((u64)key);
      const int own = (int)(pow2 ? h & (u64)(a.n_owner - 1)
                                 : h % (u64)a.n_owner);
      t = own >= a.first && own < a.first + a.n_tables ? own - a.first : -1;
    }
    bool fresh = false;
    if (t >= 0) {
      i64* table = tables + (i64)t * a.rows * cap;
      const i64 slot = claim_slot(table, cap, key, &fresh);
      if (slot < 0) {
        overflow[t] = 1;
      } else {
        fold(LANE_ROWS, (u64*)&table[cap + slot], e[m + j]);
        for (int l = 0; l < lanes; ++l) {
          fold(kind[l], (u64*)&table[(i64)(2 + l) * cap + slot],
               e[(i64)(2 + l) * m + j]);
        }
      }
    }
    if (!__any_sync(0xffffffffu, fresh)) continue;
    // the warp's fresh claims, one atomic a table
    const int lo = a.n_owner > 0 ? 0 : y;
    const int hi = a.n_owner > 0 ? a.n_tables : y + 1;
    for (int u = lo; u < hi; ++u) {
      const unsigned b = __ballot_sync(0xffffffffu, fresh && t == u);
      if (b != 0 && lane == 0) {
        const u64 c = (u64)__popc(b);
        if (atomicAdd(&groups[u], c) + c > (u64)limit) overflow[u] = 1;
      }
    }
  }
}

}  // namespace

// Step 1 of K1: totals device int64 [n_dest], zeroed by the caller. One
// launch; returns cudaGetLastError().
extern "C" int dft_partition_count(const void* keys, const void* pending,
                                   long long n, int n_dest, int salt,
                                   int salt_mode, long long salt_r,
                                   void* totals, void* stream) {
  partition_count_kernel<<<grid_blocks(n, kXThreads), kXThreads, 0,
                           (cudaStream_t)stream>>>(
      (const i64*)keys, (const uint8_t*)pending, n, n_dest, salt, salt_mode,
      salt_r, (u64*)totals);
  return (int)cudaGetLastError();
}

// Step 2 of K1: one sweep launch a pass of at most 32 lanes (src, dst:
// device pointers; width: bytes a row); totals: step 1's; key_out: device
// int64, or null; status: device int64 [ceil(n / kXTile) * n_dest] and
// tickets: device int64 [passes], both zeroed by the caller. The last pass
// clears the sent rows' flags. Returns the first error.
extern "C" int dft_partition_sweep(const void* keys, void* pending,
                                   long long n, int n_dest, int salt,
                                   int salt_mode, long long salt_r,
                                   const void* totals, long long cap,
                                   int n_lanes, const void* const* src,
                                   void* const* dst, const int* width,
                                   void* key_out, void* status,
                                   void* tickets, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, partition_sweep_kernel, kXThreads, 0);
  const i64 n_tiles = (n + kXTile - 1) / kXTile;
  i64 grid = (i64)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) grid = 1;
  int at = 0, pass = 0;
  do {
    XLanes x;
    x.n_lanes = n_lanes - at < kMaxXLanes ? n_lanes - at : kMaxXLanes;
    for (int l = 0; l < x.n_lanes; ++l) {
      x.src[l] = src[at + l];
      x.dst[l] = dst[at + l];
      x.width[l] = width[at + l];
    }
    const bool last = at + x.n_lanes >= n_lanes;
    partition_sweep_kernel<<<(unsigned)grid, kXThreads, 0, st>>>(
        (const i64*)keys, (uint8_t*)pending, n, n_dest, salt, salt_mode,
        salt_r, (const u64*)totals, cap, x,
        at == 0 ? (i64*)key_out : nullptr, last ? 1 : 0, (u64*)status,
        (u64*)tickets + pass, (u64)(pass + 1));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    at += x.n_lanes;
    ++pass;
  } while (at < n_lanes);
  return 0;
}

// K2: args a host MergeArgs (its sources' entries device int64 [rows,
// m]); tables device int64 [n_tables][rows][cap] (cap a power of two;
// keys EMPTY or claimed); groups and overflow device int64 [n_tables].
// One launch: a block row a source (n_owner > 0: the one source), blocks
// for the longest. Returns cudaGetLastError().
extern "C" int dft_merge_partials(const void* args, void* tables,
                                  long long cap, void* groups,
                                  long long limit, void* overflow,
                                  void* stream) {
  const MergeArgs& a = *(const MergeArgs*)args;
  const int n_src = a.n_owner > 0 ? 1 : a.n_tables;
  i64 most = 0;
  for (int y = 0; y < n_src; ++y) most = a.m[y] > most ? a.m[y] : most;
  const dim3 grid(grid_blocks(most, kXThreads), (unsigned)n_src);
  merge_partials_kernel<<<grid, kXThreads, 0, (cudaStream_t)stream>>>(
      a, (i64*)tables, cap, (u64*)groups, limit, (u64*)overflow);
  return (int)cudaGetLastError();
}
