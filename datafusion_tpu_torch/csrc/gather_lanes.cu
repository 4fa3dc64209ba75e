// gather_lanes: many row-aligned lanes read through one int64 index list,
// dst_l[i] = src_l[order[i]].
//
// Replaces the JAX package's reorder_rows_packed
// (datafusion_tpu/device/groupby.py:237), which packs the lanes into one
// int32 row matrix so that XLA on the TPU gathers whole rows with one
// take. On the H100 the packing is the right design too, for another
// reason: a random read fetches a whole 32-byte sector, so a row whose
// lanes are read one by one costs a sector a lane (four sectors, 128 B, to
// move the 18 B of a window's rank words).
//
// Design. The wrapper (groupby.py `gather_plan`) lays the lanes out widest
// first (8, 4, 2, 1 B), so each field is naturally aligned, and cuts them
// into groups of at most 128 B a row. A group's record is padded to a
// power of two up to 32 B, past that to a multiple of 32 B, so that a
// record of at most 32 B lies in one sector. Each group is moved in one of
// two modes, chosen by shape:
//   - packed, two launches: (1) pack_kernel reads every lane coalesced and
//     writes row-major records of width W into a scratch of n * W bytes,
//     with 16-byte vector stores (W >= 16); (2) gather_records_kernel, one
//     thread an output row and kRowBytes / W rows a thread (4 for W <= 32)
//     so that several records are in flight, reads the index coalesced,
//     then each whole record with 16-byte ld.global.nc loads (one random
//     sector for W <= 32), and writes each lane at i, coalesced across the
//     warp;
//   - direct, one launch (direct_kernel): four rows a thread, each lane
//     read at the rows' indices with its loads issued before its stores.
//     The wrapper takes it when the index list is short against the lanes
//     (m * 32 * (lanes - sectors(W)) <= n * (w + W), w the row's bytes),
//     where the pack would cost more than it saves, and for one lane.
// The field widths are template parameters (a loop a width class), not a
// switch; a field is taken from or put into the record's 64-bit words
// under a mask a word, so the record stays in registers.
//
// Bounds. The index is read once and each lane read and written once:
// W1's rank at TPC-H SF10 moves 59,997,665 rows of 18 B each way plus 8 B
// of index, 2.6 GB, 0.79 ms at the 3.35 TB/s of an NVIDIA H100 80GB HBM3
// (700 W data sheet). That bound counts no random sectors; the packed
// mode moves 18 + 32 B a row coalesced in the pack, then 8 B of index, one
// random 32-byte sector and 18 B of writes a row.

#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRecord = 128;  // bytes a record (groupby.py)
constexpr int kMaxLanes = kMaxRecord;   // of 1 B at least
constexpr int kRowBytes = 128;   // record bytes a gather thread holds

// A group's lanes, widest first: lanes [end[c - 1], end[c]) have width
// 8 >> c bytes (end[-1] = 0), and off[l] is lane l's byte in the record.
struct LaneTable {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  unsigned char off[kMaxLanes];
  int end[4];
};

// All ones if `hit`, else 0, through a move the compiler cannot see
// through: a select on a runtime word index would otherwise be folded into
// an indexed access, which puts the record in local memory.
__device__ __forceinline__ u64 word_mask(bool hit) {
  u64 m;
  asm("mov.b64 %0, %1;" : "=l"(m) : "l"(0ull - (u64)hit));
  return m;
}

// A record in registers as 64-bit words; a field is read or written with
// every word touched under a mask, so no word is indexed at run time.
template <int W>
struct Record {
  static constexpr int kWords = W < 8 ? 1 : W / 8;
  u64 w[kWords];

  // the field of T at byte o
  template <typename T>
  __device__ __forceinline__ T get(int o) const {
    u64 x = 0;
#pragma unroll
    for (int q = 0; q < kWords; ++q) x |= w[q] & word_mask(q == o >> 3);
    return (T)(x >> ((o & 7) * 8));
  }

  template <typename T>
  __device__ __forceinline__ void put(int o, T v) {
    const u64 x = (u64)v << ((o & 7) * 8);
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] |= x & word_mask(q == o >> 3);
  }

  __device__ __forceinline__ void load(const uint8_t* __restrict__ recs,
                                       i64 j) {
    if constexpr (W >= 16) {
      const uint4* p = (const uint4*)(recs + j * W);
#pragma unroll
      for (int c = 0; c < W / 16; ++c) {
        const uint4 v = __ldg(p + c);
        w[2 * c] = (u64)v.x | (u64)v.y << 32;
        w[2 * c + 1] = (u64)v.z | (u64)v.w << 32;
      }
    } else if constexpr (W == 8) {
      w[0] = __ldg((const u64*)recs + j);
    } else if constexpr (W == 4) {
      w[0] = __ldg((const unsigned*)recs + j);
    } else {
      w[0] = __ldg((const unsigned short*)recs + j);
    }
  }

  __device__ __forceinline__ void store(uint8_t* __restrict__ recs,
                                        i64 i) const {
    if constexpr (W >= 16) {
      uint4* p = (uint4*)(recs + i * W);
#pragma unroll
      for (int c = 0; c < W / 16; ++c) {
        p[c] = make_uint4((unsigned)w[2 * c], (unsigned)(w[2 * c] >> 32),
                          (unsigned)w[2 * c + 1],
                          (unsigned)(w[2 * c + 1] >> 32));
      }
    } else if constexpr (W == 8) {
      ((u64*)recs)[i] = w[0];
    } else if constexpr (W == 4) {
      ((unsigned*)recs)[i] = (unsigned)w[0];
    } else {
      ((unsigned short*)recs)[i] = (unsigned short)w[0];
    }
  }
};

template <typename T, int W>
__device__ __forceinline__ void pack_class(const LaneTable& t, int lo,
                                           int hi, i64 i, Record<W>& r) {
  for (int l = lo; l < hi; ++l) {
    r.put(t.off[l], __ldg((const T*)t.src[l] + i));
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const LaneTable t, i64 n, uint8_t* __restrict__ recs) {
  const i64 stride = (i64)gridDim.x * kThreads;
  for (i64 i = (i64)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    Record<W> r;
#pragma unroll
    for (int q = 0; q < Record<W>::kWords; ++q) r.w[q] = 0;
    pack_class<u64>(t, 0, t.end[0], i, r);
    pack_class<unsigned>(t, t.end[0], t.end[1], i, r);
    pack_class<unsigned short>(t, t.end[1], t.end[2], i, r);
    pack_class<uint8_t>(t, t.end[2], t.end[3], i, r);
    r.store(recs, i);
  }
}

template <int W>
__host__ __device__ constexpr int rows_a_thread() {
  return W <= 32 ? 4 : kRowBytes / W > 0 ? kRowBytes / W : 1;
}

template <typename T, int U, int W>
__device__ __forceinline__ void unpack_class(const LaneTable& t, int lo,
                                             int hi, const i64* i,
                                             const bool* ok,
                                             const Record<W>* r) {
  for (int l = lo; l < hi; ++l) {
    T* __restrict__ dst = (T*)t.dst[l];
    const int o = t.off[l];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (ok[k]) dst[i[k]] = r[k].template get<T>(o);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
gather_records_kernel(const i64* __restrict__ order, i64 m,
                      const uint8_t* __restrict__ recs, const LaneTable t) {
  constexpr int U = rows_a_thread<W>();
  const i64 stride = (i64)gridDim.x * kThreads * U;
  for (i64 base = (i64)blockIdx.x * kThreads * U + threadIdx.x; base < m;
       base += stride) {
    i64 i[U], j[U];
    bool ok[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      i[k] = base + (i64)k * kThreads;
      ok[k] = i[k] < m;
      j[k] = ok[k] ? __ldg(order + i[k]) : 0;
    }
    Record<W> r[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (ok[k]) r[k].load(recs, j[k]);
    }
    unpack_class<u64, U>(t, 0, t.end[0], i, ok, r);
    unpack_class<unsigned, U>(t, t.end[0], t.end[1], i, ok, r);
    unpack_class<unsigned short, U>(t, t.end[1], t.end[2], i, ok, r);
    unpack_class<uint8_t, U>(t, t.end[2], t.end[3], i, ok, r);
  }
}

constexpr int kDirectRows = 4;

template <typename T>
__device__ __forceinline__ void direct_class(const LaneTable& t, int lo,
                                             int hi, const i64* i,
                                             const i64* j, const bool* ok) {
  for (int l = lo; l < hi; ++l) {
    const T* __restrict__ src = (const T*)t.src[l];
    T* __restrict__ dst = (T*)t.dst[l];
    T v[kDirectRows];
#pragma unroll
    for (int k = 0; k < kDirectRows; ++k) {
      v[k] = ok[k] ? __ldg(src + j[k]) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kDirectRows; ++k) {
      if (ok[k]) dst[i[k]] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
direct_kernel(const i64* __restrict__ order, i64 m, const LaneTable t) {
  constexpr int U = kDirectRows;
  const i64 stride = (i64)gridDim.x * kThreads * U;
  for (i64 base = (i64)blockIdx.x * kThreads * U + threadIdx.x; base < m;
       base += stride) {
    i64 i[U], j[U];
    bool ok[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      i[k] = base + (i64)k * kThreads;
      ok[k] = i[k] < m;
      j[k] = ok[k] ? __ldg(order + i[k]) : 0;
    }
    direct_class<u64>(t, 0, t.end[0], i, j, ok);
    direct_class<unsigned>(t, t.end[0], t.end[1], i, j, ok);
    direct_class<unsigned short>(t, t.end[1], t.end[2], i, j, ok);
    direct_class<uint8_t>(t, t.end[2], t.end[3], i, j, ok);
  }
}

// The table of n_lanes lanes of widths[l] bytes, widest first, at byte
// offsets offs[l]; false if the widths are not 8, 4, 2, 1 in that order
// or a field lies outside kMaxRecord bytes or off its alignment.
bool lane_table(int n_lanes, const void* const* srcs, void* const* dsts,
                const int* widths, const int* offs, LaneTable* t) {
  if (n_lanes < 1 || n_lanes > kMaxLanes) return false;
  int c = 0;
  for (int l = 0; l < n_lanes; ++l) {
    while (c < 4 && widths[l] != 8 >> c) t->end[c++] = l;
    if (c == 4 || offs[l] < 0 || offs[l] + widths[l] > kMaxRecord ||
        offs[l] % widths[l] != 0) {
      return false;
    }
    t->src[l] = srcs != nullptr ? srcs[l] : nullptr;
    t->dst[l] = dsts != nullptr ? dsts[l] : nullptr;
    t->off[l] = (unsigned char)offs[l];
  }
  while (c < 4) t->end[c++] = n_lanes;
  return true;
}

inline unsigned blocks_for(i64 rows, int per_thread) {
  return grid_for((rows + per_thread - 1) / per_thread, kThreads);
}

template <int W>
cudaError_t launch_pack(const LaneTable& t, i64 n, uint8_t* recs,
                        cudaStream_t st) {
  pack_kernel<W><<<blocks_for(n, 1), kThreads, 0, st>>>(t, n, recs);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_gather(const i64* order, i64 m, const uint8_t* recs,
                          const LaneTable& t, cudaStream_t st) {
  gather_records_kernel<W>
      <<<blocks_for(m, rows_a_thread<W>()), kThreads, 0, st>>>(order, m,
                                                               recs, t);
  return cudaGetLastError();
}

}  // namespace

// Launch 1 of the packed mode: the n rows of n_lanes lanes (srcs: a host
// array of device pointers; widths 8, 4, 2, 1 in that order; offs their
// bytes in the record) packed into records of `width` bytes (2, 4, 8, 16,
// 32, 64, 96 or 128) at `recs`, device scratch of n * width bytes rounded
// up to 16. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another width or layout.
extern "C" int dft_gather_pack(long long n, int n_lanes,
                               const void* const* srcs, const int* widths,
                               const int* offs, int width, void* recs,
                               void* stream) {
  LaneTable t;
  if (!lane_table(n_lanes, srcs, nullptr, widths, offs, &t)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* r = (uint8_t*)recs;
  switch (width) {
    case 2: return (int)launch_pack<2>(t, n, r, st);
    case 4: return (int)launch_pack<4>(t, n, r, st);
    case 8: return (int)launch_pack<8>(t, n, r, st);
    case 16: return (int)launch_pack<16>(t, n, r, st);
    case 32: return (int)launch_pack<32>(t, n, r, st);
    case 64: return (int)launch_pack<64>(t, n, r, st);
    case 96: return (int)launch_pack<96>(t, n, r, st);
    case 128: return (int)launch_pack<128>(t, n, r, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch 2 of the packed mode: the records at order[0..m) (device int64)
// unpacked into the lanes' outputs (dsts: a host array of device pointers
// of m rows each), the same layout as the pack.
extern "C" int dft_gather_records(const void* order, long long m,
                                  const void* recs, int width, int n_lanes,
                                  void* const* dsts, const int* widths,
                                  const int* offs, void* stream) {
  LaneTable t;
  if (!lane_table(n_lanes, nullptr, dsts, widths, offs, &t)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const i64* o = (const i64*)order;
  const uint8_t* r = (const uint8_t*)recs;
  switch (width) {
    case 2: return (int)launch_gather<2>(o, m, r, t, st);
    case 4: return (int)launch_gather<4>(o, m, r, t, st);
    case 8: return (int)launch_gather<8>(o, m, r, t, st);
    case 16: return (int)launch_gather<16>(o, m, r, t, st);
    case 32: return (int)launch_gather<32>(o, m, r, t, st);
    case 64: return (int)launch_gather<64>(o, m, r, t, st);
    case 96: return (int)launch_gather<96>(o, m, r, t, st);
    case 128: return (int)launch_gather<128>(o, m, r, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The direct mode: each lane read at order[0..m) and written at i, one
// launch for up to 128 lanes (widths 8, 4, 2, 1 in that order; offs as
// for the packed mode, only checked).
extern "C" int dft_gather_direct(const void* order, long long m, int n_lanes,
                                 const void* const* srcs, void* const* dsts,
                                 const int* widths, const int* offs,
                                 void* stream) {
  LaneTable t;
  if (!lane_table(n_lanes, srcs, dsts, widths, offs, &t)) {
    return (int)cudaErrorInvalidValue;
  }
  direct_kernel<<<blocks_for(m, kDirectRows), kThreads, 0,
                  (cudaStream_t)stream>>>((const i64*)order, m, t);
  return (int)cudaGetLastError();
}
