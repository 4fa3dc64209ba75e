// radix_sort: the stable permutation that orders rows by a list of order
// words, most significant word first: np.lexsort over the reversed words.
//
// Replaces the JAX package's device_lexsort
// (datafusion_tpu/physical/plan/device_sort.py:54, jit :90), one stable
// multi-operand lax.sort over a pad flag, the words and an int64 iota.
// Sizes are exact here, so there is no pad word and no bucketed capacity.
//
// Words are uint8 (null ranks) or uint64 (order keys: sort.py's
// encode_order_key, the whole unsigned range). Design: a least-significant-
// digit radix sort with 8-bit digits, run word by word from the least
// significant word, one kernel launch a byte pass (the "one-sweep" sort of
// Adinets and Merrill, 2022). Each later word is read through the
// permutation built so far (one gather), so rows tied on it keep their
// order, as np.lexsort's do.
//   1. word_hist, one launch a word, all before the first pass: the digit
//      counts of every byte of the word (the counts do not depend on the
//      row order). The caller reads them all back at once, its one
//      synchronisation, and skips every byte whose rows all share one
//      digit, and the whole word when all its bytes do: an all-zero null
//      rank, the high bytes of dates, timestamps and dictionary codes;
//   2. gather: keys[i] = word[perm[i]] (not for the first word sorted,
//      whose permutation is the identity);
//   3. onesweep, one launch a remaining byte. Tiles of kTile rows are
//      taken in order from an atomic counter (not from blockIdx), so every
//      earlier tile's block has started. A block loads its tile's keys
//      coalesced into registers, ranks each row stably within its digit
//      (across a warp with one ballot a digit bit, item by item, then
//      across the block's warps in warp order) and publishes its 256 digit
//      counts. It places its keys in digit order in shared memory and
//      issues its rows' loads, then takes each digit's exclusive prefix
//      over the earlier tiles by decoupled look-back (one thread a digit,
//      four earlier tiles a round trip), which hides the loads' latency.
//      A status word holds a flag, the pass's epoch and the count in one
//      64-bit store. Tile 0 publishes the digit's global base (an
//      exclusive scan of the word_hist counts) plus its count, so every
//      prefix is a global position. The block then writes each digit's
//      run of keys and of rows at its global position, through shared
//      memory: consecutive threads store consecutive addresses.
//      One status array serves every pass of a sort: it is zeroed once,
//      and a word counts for a pass only when it carries that pass's
//      epoch.
//
// Bounds. A sort must read every word once and write the permutation
// once: ClickBench Q25 at 99,997,497 hits rows sorts about 40M rows of one
// uint8 and one uint64 word, 9 B a row in and 8 B out, 0.68 GB: 0.2 ms at
// the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W data sheet). A byte
// pass moves 32 B a row (key and row in, key and row out), the first pass
// of the first word 24 (no row in), a word's last pass 24 (no key out),
// and the histograms read each word once: Q25's three passes move about
// 3.6 GB, 1.06 ms at that rate. The skips and the one-launch pass are what
// the design does about the bound; the histograms are the sort's only
// synchronisation.

#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;           // = the number of digits
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;              // rows a thread
constexpr int kWarpRows = 32 * kItems;
constexpr int kTile = kThreads * kItems;   // rows a tile (device_sort.py)
constexpr int kDigits = 256;
constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 4;          // rows a thread loads at a time
constexpr int kSweepBlocks = 2;         // resident sweep blocks an SM
constexpr int kLookBack = 4;            // status words a look-back step reads

// status word of (tile, digit): flag << 62 | epoch << 40 | count
constexpr int kCountBits = 40;          // device_sort.py MAX_ROWS
constexpr u64 kCountMask = (1ull << kCountBits) - 1;
constexpr u64 kEpochMask = (1ull << 22) - 1;
constexpr u64 kAggregate = 1;           // the tile's own count
constexpr u64 kInclusive = 2;           // the global end of the tile's run

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of `valid` whose digit equals this lane's: one ballot a bit
__device__ __forceinline__ unsigned digit_peers(unsigned d, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

// One 64-bit store carries the flag, the epoch and the count, and a
// reader takes nothing else from the writer within the pass (the keys and
// rows it wrote are read by the next launch), so no fence orders it.
__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

// hist[b * 256 + d] += rows whose byte b is d, for every byte of the word
// (K: uint8_t or u64). A warp whose rows share a byte's digit (the high
// bytes of most keys) adds them with one shared atomic; otherwise each row
// adds its own.
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
word_hist_kernel(const K* __restrict__ word, i64 n, u64* __restrict__ hist) {
  constexpr int kBytes = (int)sizeof(K);
  __shared__ unsigned h[kBytes * kDigits];
  for (int i = threadIdx.x; i < kBytes * kDigits; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 base = (i64)blockIdx.x * blockDim.x; base < n;
       base += stride * kHistUnroll) {
    K k[kHistUnroll];
#pragma unroll
    for (int r = 0; r < kHistUnroll; ++r) {
      const i64 i = base + r * stride + threadIdx.x;
      k[r] = i < n ? word[i] : (K)0;
    }
#pragma unroll
    for (int r = 0; r < kHistUnroll; ++r) {
      const bool ok = base + r * stride + threadIdx.x < n;
      const unsigned valid = __ballot_sync(0xffffffffu, ok);
#pragma unroll
      for (int b = 0; b < kBytes; ++b) {
        const unsigned d = (unsigned)((u64)k[r] >> (8 * b)) & 255u;
        const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
        if (__all_sync(0xffffffffu, d == d0 || !ok)) {
          if ((threadIdx.x & 31) == 0 && valid) {
            atomicAdd(&h[b * kDigits + d], (unsigned)__popc(valid));
          }
        } else if (ok) {
          atomicAdd(&h[b * kDigits + d], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBytes * kDigits; i += blockDim.x) {
    if (h[i]) atomicAdd(&hist[i], (u64)h[i]);
  }
}

// out[i] = word[perm[i]] (K: uint8_t or u64), kHistUnroll rows a thread
// at a time, so that many random reads are in flight
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
gather_kernel(const K* __restrict__ word, const i64* __restrict__ perm,
              i64 n, K* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 base = (i64)blockIdx.x * blockDim.x + threadIdx.x; base < n;
       base += stride * kHistUnroll) {
    i64 p[kHistUnroll];
#pragma unroll
    for (int r = 0; r < kHistUnroll; ++r) {
      const i64 i = base + r * stride;
      p[r] = i < n ? perm[i] : -1;
    }
    K v[kHistUnroll];
#pragma unroll
    for (int r = 0; r < kHistUnroll; ++r) v[r] = p[r] >= 0 ? word[p[r]] : 0;
#pragma unroll
    for (int r = 0; r < kHistUnroll; ++r) {
      if (p[r] >= 0) out[base + r * stride] = v[r];
    }
  }
}

// One stable pass over the byte at bit `shift` of the keys (K: uint8_t or
// u64). Row i of the tile is item j of lane l of warp w, with
// i = w * kWarpRows + 32 j + l, so loads are coalesced and (w, j, l) is
// row order. perm_in null: the rows are 0..n-1. keys_out null: the keys
// are not needed after this pass.
template <typename K>
__global__ void __launch_bounds__(kThreads, kSweepBlocks)
onesweep_kernel(const K* __restrict__ keys_in,
                const i64* __restrict__ perm_in, i64 n, int shift,
                const u64* __restrict__ digit_hist, u64* status,
                u64 epoch, u64* __restrict__ tile_counter,
                K* __restrict__ keys_out, i64* __restrict__ perm_out) {
  __shared__ u64 buf[kTile];                        // keys, then rows
  __shared__ uint8_t digit_at[kTile];               // digit of position p
  __shared__ unsigned short warp_hist[kWarps][kDigits];
  __shared__ unsigned short start_at[kDigits];   // a digit's tile start
  __shared__ i64 move[kDigits];   // global minus tile position of a digit
  __shared__ i64 tile_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_sh = (i64)atomicAdd(tile_counter, 1ull);
  for (int w = 0; w < kWarps; ++w) warp_hist[w][tid] = 0;
  __syncthreads();
  const i64 tile = tile_sh;
  const i64 row0 = tile * kTile + (i64)warp * kWarpRows + lane;
  // this lane's items j < items are rows below n
  const i64 ahead = n - row0;
  const int items = ahead <= 0 ? 0 : ahead >= 32 * (kItems - 1) + 1
      ? kItems : (int)((ahead + 31) / 32);

  K key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    key[j] = j < items ? keys_in[row0 + 32 * j] : (K)0;
  }

  // stable rank within the warp: rows of one digit before it, item by item
  unsigned short rank[kItems];
  const unsigned below = lanemask_lt();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool ok = j < items;
    const unsigned d = (unsigned)((u64)key[j] >> shift) & 255u;
    const unsigned peers = digit_peers(d, __ballot_sync(0xffffffffu, ok));
    const unsigned r = ok ? warp_hist[warp][d] : 0u;
    rank[j] = (unsigned short)(r + __popc(peers & below));
    __syncwarp();
    if (ok && (peers & below) == 0) {
      warp_hist[warp][d] = (unsigned short)(r + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();

  // thread d: the tile's count of digit d; warp_hist becomes each warp's
  // exclusive offset within the digit
  const int d = tid;
  unsigned cnt = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_hist[w][d];
    warp_hist[w][d] = (unsigned short)cnt;
    cnt += c;
  }
  const u64 tag = epoch << kCountBits;
  u64* mine = status + tile * kDigits + d;
  if (tile > 0) store_status(mine, kAggregate << 62 | tag | cnt);
  i64 total;
  const i64 start = block_exclusive_sum<kThreads>((i64)cnt, &total);
  start_at[d] = (unsigned short)start;
  __syncthreads();

  // before the look-back: tile positions (the digit's start in the tile,
  // the warp's offset, the rank), digits and keys into shared memory in
  // digit order, and the rows' loads issued
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < items) {
      const unsigned dj = (unsigned)((u64)key[j] >> shift) & 255u;
      const unsigned p = start_at[dj] + warp_hist[warp][dj] + rank[j];
      rank[j] = (unsigned short)p;
      digit_at[p] = (uint8_t)dj;
      if (keys_out != nullptr) buf[p] = (u64)key[j];
    }
  }
  i64 row[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const i64 i = row0 + 32 * j;
    row[j] = j >= items ? 0 : perm_in != nullptr ? perm_in[i] : i;
  }

  i64 excl = 0;
  if (tile == 0) {
    excl = block_exclusive_sum<kThreads>((i64)digit_hist[d], &total);
  } else {
    // decoupled look-back, kLookBack earlier tiles a round trip: their
    // counts while they are aggregates, up to the first inclusive one
    bool done = false;
    for (i64 t = tile - 1; !done;) {
      u64 st[kLookBack];
#pragma unroll
      for (int q = 0; q < kLookBack; ++q) {
        st[q] = t - q >= 0 ? load_status(status + (t - q) * kDigits + d) : 0;
      }
      int q = 0;
#pragma unroll
      for (int r = 0; r < kLookBack; ++r) {
        if (done || q < r) continue;
        if ((st[r] >> kCountBits & kEpochMask) != epoch) continue;  // not yet
        excl += (i64)(st[r] & kCountMask);
        done = st[r] >> 62 == kInclusive;
        q = r + 1;
      }
      t -= q;
    }
  }
  store_status(mine, kInclusive << 62 | tag | (u64)(excl + cnt));
  move[d] = excl - start;
  __syncthreads();

  const i64 left = n - tile * kTile;
  const int rows = left < kTile ? (int)left : kTile;
  if (keys_out != nullptr) {
    for (int p = tid; p < rows; p += kThreads) {
      keys_out[move[digit_at[p]] + p] = (K)buf[p];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < items) buf[rank[j]] = (u64)row[j];
  }
  __syncthreads();
  for (int p = tid; p < rows; p += kThreads) {
    perm_out[move[digit_at[p]] + p] = (i64)buf[p];
  }
}

inline i64 tiles(i64 n) { return (n + kTile - 1) / kTile; }

}  // namespace

// The digit counts of every byte of `word` (device, `width` 1 or 8 bytes a
// row, n rows) added into hist: device uint64 [width][256], zeroed by the
// caller. One launch; returns cudaGetLastError().
extern "C" int dft_radix_word_hist(const void* word, int width, long long n,
                                   void* hist, void* stream) {
  const unsigned blocks = grid_for(n, kHistThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 8) {
    word_hist_kernel<u64><<<blocks, kHistThreads, 0, st>>>(
        (const u64*)word, n, (u64*)hist);
  } else {
    word_hist_kernel<uint8_t><<<blocks, kHistThreads, 0, st>>>(
        (const uint8_t*)word, n, (u64*)hist);
  }
  return (int)cudaGetLastError();
}

// out[i] = word[perm[i]] for i < n (keys of `width` bytes). One launch.
extern "C" int dft_radix_gather(const void* word, int width, const void* perm,
                                long long n, void* out, void* stream) {
  const unsigned blocks = grid_for(n, kHistThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 8) {
    gather_kernel<u64><<<blocks, kHistThreads, 0, st>>>(
        (const u64*)word, (const i64*)perm, n, (u64*)out);
  } else {
    gather_kernel<uint8_t><<<blocks, kHistThreads, 0, st>>>(
        (const uint8_t*)word, (const i64*)perm, n, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// One stable pass on the byte at bit `shift` of the keys (device, `width`
// bytes a row, n < 2^40): rows (perm_in[i], or i when perm_in is null) and
// keys move to perm_out and keys_out (null: the keys are not needed after
// this pass). digit_hist: the byte's 256 digit counts (word_hist);
// status: device uint64 [ceil(n / 4096) * 256], zeroed once a sort and
// shared by its passes; epoch: this pass's number in the sort, from 1;
// counter: this pass's tile counter, a zeroed uint64. One launch on
// `stream`; returns cudaGetLastError().
extern "C" int dft_radix_pass(const void* keys_in, int width,
                              const void* perm_in, long long n, int shift,
                              const void* digit_hist, void* status,
                              long long epoch, void* counter, void* keys_out,
                              void* perm_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = (unsigned)tiles(n);
  if (width == 8) {
    onesweep_kernel<u64><<<nb, kThreads, 0, st>>>(
        (const u64*)keys_in, (const i64*)perm_in, n, shift,
        (const u64*)digit_hist, (u64*)status, (u64)epoch, (u64*)counter,
        (u64*)keys_out, (i64*)perm_out);
  } else {
    onesweep_kernel<uint8_t><<<nb, kThreads, 0, st>>>(
        (const uint8_t*)keys_in, (const i64*)perm_in, n, shift,
        (const u64*)digit_hist, (u64*)status, (u64)epoch, (u64*)counter,
        (uint8_t*)keys_out, (i64*)perm_out);
  }
  return (int)cudaGetLastError();
}
