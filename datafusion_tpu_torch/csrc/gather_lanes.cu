// gather_lanes: many row-aligned lanes permuted by one int64 permutation,
// dst_l[i] = src_l[perm[i]], in one launch.
//
// Replaces the JAX package's reorder_rows_packed
// (datafusion_tpu/device/groupby.py:237), which packs the lanes into int32
// matrices (int64 split into two int32 halves) so that XLA on the TPU
// gathers them with one take. Here a lane is moved at its own width (1, 2,
// 4 or 8 bytes: bool, uint8, int32, int64, float64), with no packing.
//
// Design. A grid-stride loop, one row a thread: the index is read once,
// and every lane of a row is read at it and written at i, so each lane's
// writes are coalesced and only the reads follow the permutation. The
// lanes arrive as a table of (source, destination, width) passed by value
// in the launch's parameters, as program.cuh's loaders read their columns
// through a descriptor.
//
// Bounds. The permutation is read once and every lane read and written
// once: the rank of query W1 at TPC-H SF10 moves 60M rows of two uint8
// and two uint64 order words, 18 B a row each way plus 8 B of index,
// 2.6 GB: 0.79 ms at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 (700 W data
// sheet). Under a random permutation each read fetches a whole 32-byte
// sector, 4 to 32 times the bytes it uses; the kernel does nothing about
// that yet, so it is no faster than one index_select a lane (PERF.md).

#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;

struct LaneTable {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  int width[kMaxLanes];
  int n_lanes;
};

template <typename T>
__device__ __forceinline__ void move_lane(const LaneTable& t, int l, i64 i,
                                          i64 j) {
  ((T*)t.dst[l])[i] = ((const T*)t.src[l])[j];
}

__global__ void __launch_bounds__(kThreads)
gather_lanes_kernel(const i64* __restrict__ perm, i64 n, const LaneTable t) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const i64 j = perm[i];
    for (int l = 0; l < t.n_lanes; ++l) {
      switch (t.width[l]) {
        case 1: move_lane<uint8_t>(t, l, i, j); break;
        case 2: move_lane<uint16_t>(t, l, i, j); break;
        case 4: move_lane<uint32_t>(t, l, i, j); break;
        default: move_lane<u64>(t, l, i, j); break;
      }
    }
  }
}

}  // namespace

// perm: device int64 [n]; srcs, dsts: host arrays of n_lanes device
// pointers (each lane [n] rows of widths[l] bytes, 1, 2, 4 or 8); widths:
// host int array. One launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for more than 32 lanes or another width.
extern "C" int dft_gather_lanes(const void* perm, long long n, int n_lanes,
                                const void* const* srcs, void* const* dsts,
                                const int* widths, void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  LaneTable t;
  t.n_lanes = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    const int w = widths[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    t.src[l] = srcs[l];
    t.dst[l] = dsts[l];
    t.width[l] = w;
  }
  if (n == 0 || n_lanes == 0) return (int)cudaSuccess;
  gather_lanes_kernel<<<grid_for(n, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>((const i64*)perm, n, t);
  return (int)cudaGetLastError();
}
