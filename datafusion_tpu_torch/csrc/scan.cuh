// scan.cuh: block-wide and device-wide exclusive prefix sums of int64,
// shared by radix_sort.cu (the (digit, block) offsets of a radix pass).
//
// Blocks on the card run in no order, so a scan across blocks is three
// launches on one stream: each block sums its tile, one block scans the
// tile sums, and each block scans its tile again from its tile's offset.
#pragma once

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;                         // words per thread
constexpr int kScanTile = kScanThreads * kScanPer;  // words per block

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
template <int NT>
__device__ i64 block_exclusive_sum(i64 v, i64* total) {
  __shared__ i64 warp_sums[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  i64 x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < NT / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const i64 excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();   // warp_sums is reused by the next call
  return excl;
}

// sums[b] = the sum of tile b of x[0..m)
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums(const i64* __restrict__ x, i64 m, i64* __restrict__ sums) {
  const i64 base = (i64)blockIdx.x * kScanTile;
  i64 s = 0;
  for (int k = 0; k < kScanPer; ++k) {
    const i64 i = base + (i64)k * kScanThreads + threadIdx.x;
    if (i < m) s += x[i];
  }
  i64 total;
  block_exclusive_sum<kScanThreads>(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// sums[0..nt) -> exclusive offsets in place (one block)
__global__ void __launch_bounds__(kScanThreads)
scan_tile_offsets(i64* __restrict__ sums, i64 nt) {
  const i64 per = (nt + kScanThreads - 1) / kScanThreads;
  const i64 lo = (i64)threadIdx.x * per;
  const i64 hi = lo + per < nt ? lo + per : nt;
  i64 s = 0;
  for (i64 i = lo; i < hi; ++i) s += sums[i];
  i64 total;
  i64 run = block_exclusive_sum<kScanThreads>(s, &total);
  for (i64 i = lo; i < hi; ++i) {
    const i64 c = sums[i];
    sums[i] = run;
    run += c;
  }
}

// x[0..m) -> its exclusive prefix sums in place; each thread takes
// kScanPer consecutive words of its block's tile
__global__ void __launch_bounds__(kScanThreads)
scan_apply(i64* __restrict__ x, i64 m, const i64* __restrict__ offsets) {
  const i64 base = (i64)blockIdx.x * kScanTile + (i64)threadIdx.x * kScanPer;
  i64 v[kScanPer];
  i64 s = 0;
  for (int k = 0; k < kScanPer; ++k) {
    v[k] = base + k < m ? x[base + k] : 0;
    s += v[k];
  }
  i64 total;
  i64 run = offsets[blockIdx.x] + block_exclusive_sum<kScanThreads>(s, &total);
  for (int k = 0; k < kScanPer; ++k) {
    if (base + k < m) x[base + k] = run;
    run += v[k];
  }
}

// Blocks for a grid-stride loop over n rows: enough to fill the card,
// at most 8 a multiprocessor.
inline unsigned grid_for(i64 n, int threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  i64 blocks = (n + threads - 1) / threads;
  const i64 most = (i64)(sms > 0 ? sms : 132) * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

inline i64 scan_tiles(i64 m) {
  const i64 nt = (m + kScanTile - 1) / kScanTile;
  return nt > 0 ? nt : 1;
}

// Exclusive prefix sums of x[0..m) in place, with scratch `sums` of
// scan_tiles(m) words. Three launches on `st`; returns the first error.
inline cudaError_t exclusive_scan(i64* x, i64 m, i64* sums, cudaStream_t st) {
  const i64 nt = scan_tiles(m);
  scan_tile_sums<<<(unsigned)nt, kScanThreads, 0, st>>>(x, m, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tile_offsets<<<1, kScanThreads, 0, st>>>(sums, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply<<<(unsigned)nt, kScanThreads, 0, st>>>(x, m, sums);
  return cudaGetLastError();
}

}  // namespace
