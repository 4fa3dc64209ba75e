// lookback.cuh: the decoupled look-back of a single-pass scan across tiles
// (Merrill and Garland, 2016), shared by radix_sort.cu (one count a digit
// and tile), compact_groups.cu and chain_rows.cu (one count a tile).
//
// Tiles are taken in order from an atomic counter, so every earlier tile's
// block has started and the walk back always ends. A tile publishes its own
// count as an aggregate as soon as it has it, and its inclusive prefix
// (the sum of its count and every earlier tile's) once it has walked back
// to an inclusive word. Tile 0's word is inclusive from the start.
//
// A status word holds a flag, an epoch and a count in one 64-bit store:
// flag << 62 | epoch << 40 | count. A word counts for a pass only when it
// carries that pass's epoch, so one status array zeroed once can serve
// many passes. A reader takes nothing else from the writer within the
// launch (what the tiles write is read by the next launch), so no fence
// orders the store.
#pragma once

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kCountBits = 40;          // counts and prefixes below 2^40
constexpr u64 kCountMask = (1ull << kCountBits) - 1;
constexpr u64 kEpochMask = (1ull << 22) - 1;
constexpr u64 kAggregate = 1;           // the tile's own count
constexpr u64 kInclusive = 2;           // the tile's count and all before

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

__device__ __forceinline__ u64 status_word(u64 flag, u64 epoch, u64 count) {
  return flag << 62 | epoch << kCountBits | count;
}

// The sum of the counts of tiles 0..tile-1 (tile > 0) whose status words
// are at[t * stride]: their counts while they are aggregates, up to the
// first inclusive one, kAhead words a round trip (one thread).
template <int kAhead>
__device__ __forceinline__ i64 look_back(const u64* at, i64 tile, i64 stride,
                                         u64 epoch) {
  i64 excl = 0;
  bool done = false;
  for (i64 t = tile - 1; !done;) {
    u64 st[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      st[q] = t - q >= 0 ? load_status(at + (t - q) * stride) : 0;
    }
    int q = 0;
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      if (done || q < r) continue;
      if ((st[r] >> kCountBits & kEpochMask) != epoch) continue;  // not yet
      excl += (i64)(st[r] & kCountMask);
      done = st[r] >> 62 == kInclusive;
      q = r + 1;
    }
    t -= q;
  }
  return excl;
}

// The same sum, taken by a whole warp (every lane calls it and gets it):
// lane l reads the status word of tile t - l, a warp's width of tiles a
// round trip (32 on the card; one where the sources run as one thread),
// and the walk stops at the nearest inclusive word once every word before
// it is published. A tile that does nothing else while it waits spends
// one warp on the walk, not one thread.
__device__ __forceinline__ i64 warp_look_back(const u64* at, i64 tile,
                                              i64 stride, u64 epoch) {
  const unsigned members = __ballot_sync(0xffffffffu, 1);
  const int width = __popc(members);
  const int lane = threadIdx.x & 31;
  i64 excl = 0;
  for (i64 t = tile - 1;; t -= width) {
    const i64 mine = t - lane;
    u64 st;
    unsigned ready, incl;
    for (;;) {
      // past tile 0 (whose word is inclusive) a lane reads nothing
      st = mine >= 0 ? load_status(at + mine * stride)
                     : status_word(kInclusive, epoch, 0);
      const bool ok = (st >> kCountBits & kEpochMask) == epoch;
      ready = __ballot_sync(members, ok);
      incl = __ballot_sync(members, ok && st >> 62 == kInclusive);
      // the lanes up to the nearest inclusive word (all without one)
      const unsigned need = incl ? (incl & (0u - incl)) * 2u - 1u : members;
      if ((ready & need) == need) break;
    }
    const int stop = incl ? __ffs(incl) - 1 : width - 1;
    i64 c = lane <= stop ? (i64)(st & kCountMask) : 0;
    for (int o = 1; o < width; o <<= 1) c += __shfl_xor_sync(members, c, o);
    excl += c;
    if (incl) return excl;
  }
}

}  // namespace
