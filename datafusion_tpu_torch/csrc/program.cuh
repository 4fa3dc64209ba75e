// program.cuh: the expression-program interpreter and the lane folds that
// the port's row kernels share.
//
// Every expression (predicate, each group key, each lane argument, a
// HAVING predicate) arrives as a small stack program compiled on the host
// (datafusion_tpu_torch/device/lower.py). `run` interprets one program for
// one row on a stack of (64-bit value, valid bit) entries. Its column loads
// go through a loader object, so the same interpreter reads table rows
// (`RowColumns`, the aggregate kernels) or finalised group-table columns
// (the HAVING loader of compact_groups.cu).
//
// Exactness. Integer arithmetic wraps in 64 bits (signed overflow is
// undefined in C++, so it goes through unsigned). There is no signed 64-bit
// atomicAdd: the value is added through unsigned long long, which wraps
// identically. There are no float64 atomic min and max: a compare-and-swap
// loop does them; NaN never reaches them (it is masked out and counted in a
// NANCNT lane).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

// opcodes: datafusion_tpu_torch/device/lower.py
enum {
  OP_COL = 1, OP_ICONST = 2, OP_FCONST = 3, OP_NULL = 4,
  OP_ADD_I = 10, OP_SUB_I = 11, OP_MUL_I = 12,
  OP_ADD_F = 13, OP_SUB_F = 14, OP_MUL_F = 15,
  OP_NEG_I = 16, OP_NEG_F = 17,
  OP_MULC_I = 20, OP_DIVC_F = 22, OP_I2F = 23, OP_F32 = 24,
  OP_WRAP32 = 25,
  OP_CMP_I = 30, OP_CMP_F = 31, OP_STRCMP = 32, OP_DECCMP = 33, OP_LUT = 34,
  OP_IN_I = 35, OP_IN_F = 36,
  OP_AND = 40, OP_OR = 41, OP_NOT = 42, OP_ISNULL = 43, OP_ISNOTNULL = 44,
};
enum { CMP_EQ, CMP_NE, CMP_LT, CMP_LE, CMP_GT, CMP_GE };

// lane kinds: datafusion_tpu_torch/device/groupby.py
enum {
  LANE_ROWS = 0, LANE_CNT = 1, LANE_SUM_I64 = 2, LANE_SUM_F64 = 3,
  LANE_MIN_I64 = 4, LANE_MAX_I64 = 5, LANE_MIN_F64 = 6, LANE_MAX_F64 = 7,
  LANE_NANCNT = 8, LANE_SUM_F32 = 9,
};

// column dtype codes: datafusion_tpu_torch/device/groupby.py
enum { DT_BOOL, DT_I32, DT_I64, DT_F32, DT_F64 };

// descriptor header words
enum { H_NCOLS, H_NLANES, H_G, H_NKEYS, H_PRED, H_OFF_COLS, H_OFF_PROGS,
       H_OFF_CODE, H_OFF_ICONST, H_OFF_FCONST, H_OFF_KEYS, H_OFF_LANES };

constexpr int kMaxStack = 16;

__device__ __forceinline__ double as_f(i64 b) { return __longlong_as_double(b); }
__device__ __forceinline__ i64 as_i(double d) { return __double_as_longlong(d); }

// wrapping integer arithmetic (signed overflow is undefined in C++)
__device__ __forceinline__ i64 wadd(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 wsub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 wmul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }

template <typename T>
__device__ __forceinline__ bool cmp(int code, T a, T b) {
  switch (code) {
    case CMP_EQ: return a == b;
    case CMP_NE: return a != b;
    case CMP_LT: return a < b;
    case CMP_LE: return a <= b;
    case CMP_GT: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ i64 load(const i64* col, i64 row) {
  const void* p = (const void*)col[0];
  switch ((int)col[2]) {
    case DT_BOOL: return ((const unsigned char*)p)[row] != 0;
    case DT_I32: return ((const int*)p)[row];
    case DT_F32: return as_i((double)((const float*)p)[row]);
    default: return ((const i64*)p)[row];  // DT_I64, DT_F64 (bits)
  }
}

// Column loads of the row kernels: (data pointer, validity pointer or 0,
// dtype code) per column index, at meta[H_OFF_COLS].
struct RowColumns {
  const i64* cols;
  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    const i64* c = cols + 3 * idx;
    *v = load(c, row);
    const unsigned char* vp = (const unsigned char*)c[1];
    return vp == nullptr || vp[row] != 0;
  }
};

// Run program `prog` for one row. Returns the valid bit; the value
// (int64, or float64 bits) goes to *out. `col(idx, row, &v)` loads one
// column value and returns its valid bit.
template <class Columns>
__device__ bool run(const i64* meta, const i64* aux, int prog, i64 row,
                    const Columns& col, i64* out) {
  const i64* code = meta + meta[H_OFF_CODE];
  const i64* ic = meta + meta[H_OFF_ICONST];
  const i64* fc = meta + meta[H_OFF_FCONST];
  const i64 start = meta[meta[H_OFF_PROGS] + 2 * prog];
  const i64 len = meta[meta[H_OFF_PROGS] + 2 * prog + 1];
  i64 v[kMaxStack];
  unsigned ok = 0;   // valid bit of stack entry i is bit i
  int sp = 0;        // number of entries
#define OK(i) ((ok >> (i)) & 1u)
#define SET_OK(i, b) (ok = (ok & ~(1u << (i))) | ((unsigned)(b) << (i)))
  for (i64 pc = start; pc < start + len; ++pc) {
    const int op = (int)code[3 * pc];
    const i64 a = code[3 * pc + 1];
    const i64 b = code[3 * pc + 2];
    switch (op) {
      case OP_COL: {
        const bool valid = col(a, row, &v[sp]);
        SET_OK(sp, valid);
        ++sp;
        break;
      }
      case OP_ICONST: v[sp] = ic[a]; SET_OK(sp, 1); ++sp; break;
      case OP_FCONST: v[sp] = fc[a]; SET_OK(sp, 1); ++sp; break;
      case OP_NULL: v[sp] = 0; SET_OK(sp, 0); ++sp; break;
      case OP_ADD_I: case OP_SUB_I: case OP_MUL_I:
      case OP_ADD_F: case OP_SUB_F: case OP_MUL_F:
      case OP_CMP_I: case OP_CMP_F: {
        const i64 x = v[sp - 2], y = v[sp - 1];
        const bool valid = OK(sp - 2) && OK(sp - 1);
        i64 r;
        switch (op) {
          case OP_ADD_I: r = wadd(x, y); break;
          case OP_SUB_I: r = wsub(x, y); break;
          case OP_MUL_I: r = wmul(x, y); break;
          case OP_ADD_F: r = as_i(as_f(x) + as_f(y)); break;
          case OP_SUB_F: r = as_i(as_f(x) - as_f(y)); break;
          case OP_MUL_F: r = as_i(as_f(x) * as_f(y)); break;
          case OP_CMP_I: r = cmp<i64>((int)a, x, y); break;
          default: r = cmp<double>((int)a, as_f(x), as_f(y)); break;
        }
        --sp;
        v[sp - 1] = r;
        SET_OK(sp - 1, valid);
        break;
      }
      case OP_AND: case OP_OR: {
        const bool x = v[sp - 2] != 0, y = v[sp - 1] != 0;
        const bool xv = OK(sp - 2), yv = OK(sp - 1);
        bool d, valid;
        if (op == OP_AND) {  // Kleene: false wins over NULL
          d = (x || !xv) && (y || !yv);
          valid = (xv && yv) || (xv && !x) || (yv && !y);
        } else {             // Kleene: true wins over NULL
          const bool tl = xv && x, tr = yv && y;
          d = tl || tr;
          valid = (xv && yv) || tl || tr;
        }
        --sp;
        v[sp - 1] = d;
        SET_OK(sp - 1, valid);
        break;
      }
      case OP_NEG_I: v[sp - 1] = wsub(0, v[sp - 1]); break;
      case OP_NEG_F: v[sp - 1] = as_i(-as_f(v[sp - 1])); break;
      case OP_MULC_I: v[sp - 1] = wmul(v[sp - 1], ic[a]); break;
      case OP_DIVC_F: v[sp - 1] = as_i(as_f(v[sp - 1]) / as_f(fc[a])); break;
      case OP_I2F: v[sp - 1] = as_i((double)v[sp - 1]); break;
      case OP_F32:
        v[sp - 1] = as_i((double)__double2float_rn(as_f(v[sp - 1])));
        break;
      case OP_WRAP32: v[sp - 1] = (i64)(int)v[sp - 1]; break;
      case OP_STRCMP: {
        const i64* s = aux + aux[2 * b];
        const i64 x = v[sp - 1], pos = s[0], exact = s[1];
        bool d;
        switch ((int)a) {
          case CMP_EQ: d = x == exact; break;
          case CMP_NE: d = x != exact; break;
          case CMP_LT: d = x < pos; break;
          case CMP_LE: d = x < pos || x == exact; break;
          case CMP_GT: d = x >= pos && x != exact; break;
          default: d = x >= pos; break;
        }
        v[sp - 1] = d;
        break;
      }
      case OP_DECCMP: {
        const i64 x = v[sp - 1], t_ge = ic[b], t_gt = ic[b + 1];
        bool d;
        switch ((int)a) {
          case CMP_EQ: d = x >= t_ge && x < t_gt; break;
          case CMP_NE: d = x < t_ge || x >= t_gt; break;
          case CMP_LT: d = x < t_ge; break;
          case CMP_LE: d = x < t_gt; break;
          case CMP_GT: d = x >= t_gt; break;
          default: d = x >= t_ge; break;
        }
        v[sp - 1] = d;
        break;
      }
      case OP_LUT: {
        const i64* lut = aux + aux[2 * a];
        const i64 n = aux[2 * a + 1];
        i64 x = v[sp - 1];
        x = x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
        v[sp - 1] = lut[x];
        break;
      }
      case OP_IN_I: case OP_IN_F: {
        const i64 x = v[sp - 1];
        bool hit = false;
        for (i64 k = 0; k < b; ++k) {
          hit |= op == OP_IN_I ? x == ic[a + k] : as_f(x) == as_f(fc[a + k]);
        }
        v[sp - 1] = hit;
        break;
      }
      case OP_NOT: v[sp - 1] = v[sp - 1] == 0; break;
      case OP_ISNULL: case OP_ISNOTNULL: {
        const bool valid = OK(sp - 1);
        v[sp - 1] = op == OP_ISNOTNULL ? valid : !valid;
        SET_OK(sp - 1, 1);
        break;
      }
      default: break;  // the host compiler emits no other opcode
    }
  }
  *out = v[0];
  return OK(0);
#undef OK
#undef SET_OK
}

__device__ __forceinline__ i64 identity(int kind) {
  switch (kind) {
    case LANE_MIN_I64: return INT64_MAX;
    case LANE_MAX_I64: return INT64_MIN;
    case LANE_MIN_F64: return as_i(INFINITY);
    case LANE_MAX_F64: return as_i(-INFINITY);
    default: return 0;
  }
}

__device__ __forceinline__ void atomic_min_f64(u64* addr, double x) {
  u64 old = *addr;
  while (x < as_f((i64)old)) {
    const u64 seen = atomicCAS(addr, old, (u64)as_i(x));
    if (seen == old) break;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_max_f64(u64* addr, double x) {
  u64 old = *addr;
  while (x > as_f((i64)old)) {
    const u64 seen = atomicCAS(addr, old, (u64)as_i(x));
    if (seen == old) break;
    old = seen;
  }
}

// fold value x of a lane of kind `kind` into *cell (shared or global)
__device__ __forceinline__ void fold(int kind, u64* cell, i64 x) {
  switch (kind) {
    case LANE_SUM_F64: atomicAdd((double*)cell, as_f(x)); break;
    // float32 sum in the cell's low word (little-endian); x is a float64
    // holding a float32 value, so the narrowing is exact
    case LANE_SUM_F32: atomicAdd((float*)cell, (float)as_f(x)); break;
    case LANE_MIN_I64: atomicMin((long long*)cell, x); break;
    case LANE_MAX_I64: atomicMax((long long*)cell, x); break;
    case LANE_MIN_F64: atomic_min_f64(cell, as_f(x)); break;
    case LANE_MAX_F64: atomic_max_f64(cell, as_f(x)); break;
    default: atomicAdd(cell, (u64)x); break;  // counts and int64 sums
  }
}

// Fold one row's lanes into the table cells cell(l) of one group, under the
// rules of DeviceGroupAggregateExec._make_step.prepare
// (datafusion_tpu/physical/plan/device_aggregate.py:718-767): count(*) and
// CNT count the row (CNT only where its argument is valid), NaN is masked
// out of float min/max and counted in the NANCNT lane.
template <class Columns, class Cell>
__device__ __forceinline__ void fold_lanes(const i64* meta, const i64* aux,
                                           const i64* lanes, int n_lanes,
                                           i64 row, const Columns& cols,
                                           Cell cell) {
  for (int l = 0; l < n_lanes; ++l) {
    const int prog = (int)lanes[2 * l];
    const int kind = (int)lanes[2 * l + 1];
    if (prog < 0) {  // count(*)
      atomicAdd(cell(l), 1ull);
      continue;
    }
    i64 x;
    const bool valid = run(meta, aux, prog, row, cols, &x);
    if (!valid) continue;
    switch (kind) {
      case LANE_CNT: atomicAdd(cell(l), 1ull); break;
      case LANE_NANCNT:
        if (isnan(as_f(x))) atomicAdd(cell(l), 1ull);
        break;
      case LANE_MIN_F64: case LANE_MAX_F64:
        if (!isnan(as_f(x))) fold(kind, cell(l), x);
        break;
      default: fold(kind, cell(l), x); break;
    }
  }
}

// The packed group key of one row: each key program's value packs as
// (v - offset + 1) << shift, 0 for NULL (device_aggregate.py:708-716).
template <class Columns>
__device__ __forceinline__ i64 pack_key(const i64* meta, const i64* aux,
                                        const i64* keys, int n_keys, i64 row,
                                        const Columns& cols) {
  i64 packed = 0;
  for (int k = 0; k < n_keys; ++k) {
    i64 x;
    const bool valid = run(meta, aux, (int)keys[3 * k], row, cols, &x);
    const i64 code = valid ? wadd(wsub(x, keys[3 * k + 1]), 1) : 0;
    packed |= code << keys[3 * k + 2];
  }
  return packed;
}

// Copy the descriptor into shared memory (the block's first words).
__device__ __forceinline__ void stage_meta(i64* smem, const i64* meta_g,
                                           int meta_len) {
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) smem[i] = meta_g[i];
  __syncthreads();
}

}  // namespace
