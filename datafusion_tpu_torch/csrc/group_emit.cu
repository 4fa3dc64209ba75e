// group_emit: the live groups of a compacted group table, written as typed
// device columns that stay on the card (a group key unpacked from the
// packed key word, a count, a non-float sum with its validity).
//
// Replaces the JAX package's _emit_device_resident
// (datafusion_tpu/physical/plan/device_aggregate.py:899, jit :942), which
// unpacks the keys and finalises the aggregates of a group table of at
// least 2^18 groups so that the table's consumer (TPC-H Q20: a join build)
// reads it from the device and the host never sees it. Per group, as
// :915-941 computes it:
//   key:   raw = (packed >> shift) & ((1 << bits) - 1), valid raw != 0;
//          a dictionary key gives code max(raw - 1, 0) (int32), any other
//          raw - 1 + offset at the key's width;
//   count: the count lane, int64, no validity;
//   sum:   the sum lane, valid where the count lane is above 0.
//
// Design. One elementwise launch: a thread per group reads the group's
// packed key and the lanes its fields name, each once a field, and writes
// each field's data and validity. Reads and writes of neighbouring threads
// are neighbouring words (the table is [rows][ng], row-major).
//
// Bounds. TPC-H Q20 at SF10 has about 5.6M groups of (l_partkey,
// l_suppkey, sum(l_quantity)): it reads the key, count and sum words (24
// bytes a group) and writes two int64 keys, one int64 sum and three
// validity bytes (27 bytes), about 0.29 GB: 0.09 ms at the 3.35 TB/s of
// an NVIDIA H100 80GB HBM3 at 700 W.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 64;

// field kinds and words: datafusion_tpu_torch/device/groupby.py EmitField
enum { EMIT_KEY = 0, EMIT_DICT = 1, EMIT_COUNT = 2, EMIT_SUM = 3 };
enum { F_KIND, F_ROW, F_SHIFT, F_BITS, F_OFFSET, F_DTYPE, F_DATA, F_VALID,
       kFieldWords };

__global__ void __launch_bounds__(kThreads)
group_emit_kernel(const i64* __restrict__ groups, i64 ng, int n_fields,
                  const i64* __restrict__ fields_g) {
  __shared__ i64 fields[kMaxFields * kFieldWords];
  for (int i = threadIdx.x; i < n_fields * kFieldWords; i += blockDim.x) {
    fields[i] = fields_g[i];
  }
  __syncthreads();
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < ng;
       g += stride) {
    for (int k = 0; k < n_fields; ++k) {
      const i64* f = fields + k * kFieldWords;
      const i64 word = __ldg((const long long*)groups + f[F_ROW] * ng + g);
      i64 x;
      bool valid = true;
      switch ((int)f[F_KIND]) {
        case EMIT_KEY: case EMIT_DICT: {
          const i64 raw = (i64)(((u64)word >> f[F_SHIFT]) &
                                ((1ull << f[F_BITS]) - 1));
          valid = raw != 0;
          x = (int)f[F_KIND] == EMIT_DICT ? (raw > 0 ? raw - 1 : 0)
                                          : wadd(raw - 1, f[F_OFFSET]);
          break;
        }
        case EMIT_SUM:
          x = word;
          valid = __ldg((const long long*)groups + f[F_SHIFT] * ng + g) > 0;
          break;
        default: x = word; break;  // EMIT_COUNT
      }
      void* data = (void*)f[F_DATA];
      if ((int)f[F_DTYPE] == DT_I32) {
        ((int*)data)[g] = (int)x;
      } else {
        ((i64*)data)[g] = x;
      }
      if (f[F_VALID] != 0) ((unsigned char*)f[F_VALID])[g] = valid;
    }
  }
}

}  // namespace

// groups: device int64 [rows][ng] (compact_groups' output); fields: device
// int64 [n_fields][8] as groupby.py EmitField lays them out, n_fields <=
// 64. Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_group_emit(const void* groups, long long ng, int n_fields,
                              const void* fields, void* stream) {
  if (n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
  group_emit_kernel<<<grid_blocks(ng, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const i64*)groups, ng, n_fields, (const i64*)fields);
  return (int)cudaGetLastError();
}
