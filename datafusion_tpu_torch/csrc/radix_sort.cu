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
// significant word. Each word is read through the permutation built so far
// (one gather), so rows tied on it keep their order, as np.lexsort's do.
// Per word:
//   1. word_hist: the digit counts of every byte of the word, read in row
//      order (the counts do not depend on the order). The caller reads
//      them back and skips every byte whose rows all share one digit, and
//      the whole word when all its bytes do: an all-zero null rank, the
//      high bytes of dates, timestamps and dictionary codes;
//   2. gather: keys[i] = word[perm[i]] (not for the first word sorted,
//      whose permutation is the identity);
//   3. one pass per remaining byte, five launches: a per-block digit
//      histogram in shared memory, the three launches of an exclusive scan
//      over (digit, block) (scan.cuh), and a stable scatter of (key, row)
//      to its digit's offset. The scatter ranks rows within a warp with
//      __match_any_sync and across the block's warps through a shared
//      table, one round of 256 rows at a time, so each block writes its
//      rows of one digit in row order.
//
// Bounds. A sort must read every word once and write the permutation
// once: ClickBench Q25 at 99,997,497 hits rows sorts about 40M rows of one
// uint8 and one uint64 word, 9 B a row in and 8 B out, 0.68 GB: 0.2 ms at
// the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W data sheet). Each byte
// pass moves 40 B a row (key and row in, key and row out) and the skipped
// bytes cost one read of the word, so a word of k varying bytes moves
// about 40k B a row: the skips are what the design does about the bound.

#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;           // = the number of digits
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;   // rows a block (device_sort.py)
constexpr int kDigits = 256;
constexpr int kHistThreads = 256;

__device__ __forceinline__ u64 load_key(const void* p, int width, i64 i) {
  return width == 8 ? ((const u64*)p)[i] : (u64)((const uint8_t*)p)[i];
}

__device__ __forceinline__ void store_key(void* p, int width, i64 i, u64 k) {
  if (width == 8) {
    ((u64*)p)[i] = k;
  } else {
    ((uint8_t*)p)[i] = (uint8_t)k;
  }
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// hist[b * 256 + d] += rows whose byte b is d, for every byte of the word
__global__ void __launch_bounds__(kHistThreads)
word_hist_kernel(const void* __restrict__ word, int width, i64 n,
                 u64* __restrict__ hist) {
  __shared__ unsigned h[8 * kDigits];
  for (int i = threadIdx.x; i < width * kDigits; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 base = (i64)blockIdx.x * blockDim.x; base < n; base += stride) {
    const i64 i = base + threadIdx.x;
    const bool ok = i < n;
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const u64 k = load_key(word, width, i);
      for (int b = 0; b < width; ++b) {
        const unsigned d = (unsigned)(k >> (8 * b)) & 255u;
        // one shared atomic per distinct digit of the warp
        const unsigned peers = __match_any_sync(active, d);
        if ((__ffs(peers) - 1) == lane) {
          atomicAdd(&h[b * kDigits + d], (unsigned)__popc(peers));
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width * kDigits; i += blockDim.x) {
    if (h[i]) atomicAdd(&hist[i], (u64)h[i]);
  }
}

// out[i] = word[perm[i]]
__global__ void __launch_bounds__(kHistThreads)
gather_kernel(const void* __restrict__ word, int width,
              const i64* __restrict__ perm, i64 n, void* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    store_key(out, width, i, load_key(word, width, perm[i]));
  }
}

// counts[d * nb + b] = the rows of block b's tile whose digit is d
__global__ void __launch_bounds__(kThreads)
block_hist_kernel(const void* __restrict__ keys, int width, i64 n, int shift,
                  i64 nb, i64* __restrict__ counts) {
  __shared__ unsigned h[kDigits];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const i64 base = (i64)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const i64 i = base + (i64)r * kThreads + threadIdx.x;
    const bool ok = i < n;
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const unsigned d = (unsigned)(load_key(keys, width, i) >> shift) & 255u;
      const unsigned peers = __match_any_sync(active, d);
      if ((__ffs(peers) - 1) == lane) atomicAdd(&h[d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  counts[(i64)threadIdx.x * nb + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter of block b's tile: row i with digit d goes to
// offsets[d * nb + b] + (rows of digit d before it in the tile).
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const void* __restrict__ keys_in, int width,
               const i64* __restrict__ perm_in, i64 n, int shift, i64 nb,
               const i64* __restrict__ offsets, void* __restrict__ keys_out,
               i64* __restrict__ perm_out) {
  __shared__ unsigned warp_count[kWarps][kDigits];
  __shared__ i64 running[kDigits];
  const int warp = threadIdx.x >> 5;
  running[threadIdx.x] = offsets[(i64)threadIdx.x * nb + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_count[w][threadIdx.x] = 0;
  __syncthreads();
  const unsigned below = lanemask_lt();
  const i64 base = (i64)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const i64 i = base + (i64)r * kThreads + threadIdx.x;
    const bool ok = i < n;
    u64 k = 0;
    unsigned d = kDigits;   // rows past n form a group of their own
    if (ok) {
      k = load_key(keys_in, width, i);
      d = (unsigned)(k >> shift) & 255u;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & below);
    if (ok && rank == 0) warp_count[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      i64 pos = running[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_count[w][d];
      perm_out[pos] = perm_in != nullptr ? perm_in[i] : i;
      if (keys_out != nullptr) store_key(keys_out, width, pos, k);
    }
    __syncthreads();
    i64 s = 0;
    for (int w = 0; w < kWarps; ++w) {
      s += warp_count[w][threadIdx.x];
      warp_count[w][threadIdx.x] = 0;
    }
    running[threadIdx.x] += s;
    __syncthreads();
  }
}

inline i64 tiles(i64 n) { return (n + kTile - 1) / kTile; }

}  // namespace

// The digit counts of every byte of `word` (device, `width` 1 or 8 bytes a
// row, n rows) added into hist: device uint64 [width][256], zeroed by the
// caller. One launch; returns cudaGetLastError().
extern "C" int dft_radix_word_hist(const void* word, int width, long long n,
                                   void* hist, void* stream) {
  word_hist_kernel<<<grid_for(n, kHistThreads), kHistThreads, 0,
                     (cudaStream_t)stream>>>(word, width, n, (u64*)hist);
  return (int)cudaGetLastError();
}

// out[i] = word[perm[i]] for i < n (keys of `width` bytes). One launch.
extern "C" int dft_radix_gather(const void* word, int width, const void* perm,
                                long long n, void* out, void* stream) {
  gather_kernel<<<grid_for(n, kHistThreads), kHistThreads, 0,
                  (cudaStream_t)stream>>>(word, width, (const i64*)perm, n,
                                          out);
  return (int)cudaGetLastError();
}

// One stable pass on the byte at bit `shift` of the keys (device, `width`
// bytes a row): rows (perm_in[i], or i when perm_in is null) and keys move
// to perm_out and keys_out (null: the keys are not needed after this
// pass). counts: device int64 scratch of 256 * ceil(n / 4096) words;
// sums: device int64 scratch of ceil(that / 8192) words. Five launches on
// `stream`; returns the first error.
extern "C" int dft_radix_pass(const void* keys_in, int width,
                              const void* perm_in, long long n, int shift,
                              void* counts, void* sums, void* keys_out,
                              void* perm_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const i64 nb = tiles(n);
  block_hist_kernel<<<(unsigned)nb, kThreads, 0, st>>>(
      keys_in, width, n, shift, nb, (i64*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = exclusive_scan((i64*)counts, nb * kDigits, (i64*)sums, st);
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<(unsigned)nb, kThreads, 0, st>>>(
      keys_in, width, (const i64*)perm_in, n, shift, nb,
      (const i64*)counts, keys_out, (i64*)perm_out);
  return (int)cudaGetLastError();
}
