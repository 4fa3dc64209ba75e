// program.cuh: the expression-program interpreter, the lane folds and the
// row bodies that the port's row kernels share.
//
// Every expression (predicate, each group key, each lane argument, a
// HAVING predicate, a join's probe key) arrives as a small stack program
// compiled on the host (datafusion_tpu_torch/device/lower.py). `run`
// interprets one program for one row on a stack of (64-bit value, valid
// bit) entries. Its column loads go through a loader object, so the same
// interpreter reads table rows (`RowColumns`, the aggregate kernels),
// finalised group-table columns (the HAVING loader of compact_groups.cu),
// or the pair space of a join chain (`ChainColumns`: spine columns at the
// row, build payloads at the row each hop found).
//
// The row bodies `dense_fold` and `hash_fold` (a dense shared-memory
// table of <= 64 slots, a global hash table) are templates on the row
// source: `PlainRows` admits the rows that pass an aggregate's predicate,
// `ChainRows` those that also survive the join chain's walk, so the
// grouped aggregate and the join-chain aggregate share one fold.
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
       H_OFF_CODE, H_OFF_ICONST, H_OFF_FCONST, H_OFF_KEYS, H_OFF_LANES,
       H_OFF_CHAIN };

// join-chain section (datafusion_tpu_torch/device/join_chain.py): a head,
// one record per hop, then the hop of every pair-space column (-1: spine)
enum { C_NSPINE, C_NHOPS, C_PPRED, C_OFF_HOPOF, C_HOPS };
enum { HOP_KIND, HOP_JTYPE, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS,
       HOP_KEY0 };
constexpr int kMaxHops = 8;
constexpr int kMaxHopKeys = 4;
constexpr int kHopWords = HOP_KEY0 + 4 * kMaxHopKeys;  // (prog, lo, hi, shift)
enum { TAB_DIRECT, TAB_HASH, TAB_EMPTY };               // build table kinds
enum { JT_INNER, JT_SEMI, JT_ANTI };                    // hop join types

constexpr int kMaxStack = 16;
constexpr i64 kEmpty = -1;   // key of a free hash slot

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

// column inputs are read-only for the whole launch: read-only cache loads
__device__ __forceinline__ i64 load(const i64* col, i64 row) {
  const void* p = (const void*)col[0];
  switch ((int)col[2]) {
    case DT_BOOL: return __ldg((const unsigned char*)p + row) != 0;
    case DT_I32: return __ldg((const int*)p + row);
    case DT_F32: return as_i((double)__ldg((const float*)p + row));
    default: return __ldg((const long long*)p + row);  // DT_I64, DT_F64 bits
  }
}

// one column value at `row`: its valid bit, the value to *v
__device__ __forceinline__ bool load_valid(const i64* c, i64 row, i64* v) {
  *v = load(c, row);
  const unsigned char* vp = (const unsigned char*)c[1];
  return vp == nullptr || __ldg(vp + row) != 0;
}

// Column loads of the row kernels: (data pointer, validity pointer or 0,
// dtype code) per column index, at meta[H_OFF_COLS].
struct RowColumns {
  const i64* cols;
  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    return load_valid(cols + 3 * idx, row, v);
  }
};

// Column loads of a join chain's pair space: a spine column (hop_of < 0)
// at the spine row, a payload column of hop h at the build row that hop
// found (brow[h]); a hop that found nothing reads as NULL.
struct ChainColumns {
  const i64* cols;
  const i64* hop_of;
  i64 brow[kMaxHops];
  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    const int h = (int)hop_of[idx];
    if (h >= 0) {
      row = brow[h];
      if (row < 0) {
        *v = 0;
        return false;
      }
    }
    return load_valid(cols + 3 * idx, row, v);
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

// ---- hashing ----------------------------------------------------------------

__device__ __forceinline__ u64 splitmix64(u64 x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The slot of `key` (>= 0) in an open-addressing table of `cap` (a power
// of two) int64 keys, claimed if new (*fresh = true); -1 when the table is
// full. Linear probing from splitmix64(key).
__device__ __forceinline__ i64 claim_slot(i64* keys, i64 cap, i64 key,
                                          bool* fresh) {
  const i64 mask = cap - 1;
  i64 h = (i64)(splitmix64((u64)key) & (u64)mask);
  for (i64 probes = 0; probes < cap; ++probes) {
    // a slot's key never changes once written, so a stale read can only
    // be EMPTY, and the CAS below settles that case
    const i64 seen = *(volatile i64*)&keys[h];
    if (seen == key) {
      *fresh = false;
      return h;
    }
    if (seen == kEmpty) {
      const i64 old = (i64)atomicCAS((u64*)&keys[h], (u64)kEmpty, (u64)key);
      if (old == kEmpty || old == key) {
        *fresh = old == kEmpty;
        return h;
      }
    }
    h = (h + 1) & mask;
  }
  return -1;
}

__device__ __forceinline__ i64 find_slot(i64* keys, i64 cap, i64 key) {
  bool fresh;
  return claim_slot(keys, cap, key, &fresh);
}

// ---- the row bodies ---------------------------------------------------------

// Rows of a plain aggregate: those that pass its predicate (H_PRED).
struct PlainRows {
  const i64* meta;
  const i64* aux;
  typedef RowColumns Columns;
  __device__ __forceinline__ bool operator()(i64 row, RowColumns* cols) const {
    cols->cols = meta + meta[H_OFF_COLS];
    if (meta[H_PRED] < 0) return true;
    i64 x;
    const bool valid = run(meta, aux, (int)meta[H_PRED], row, *cols, &x);
    return valid && x != 0;
  }
};

// Every admitted row folded into a dense table of G = meta[H_G] <= 64 slots
// in shared memory (`tab`: [lanes + 1][G], row 0 the counts), merged into
// the global table `table_g` with atomics at the end, so any number of
// launches accumulate into one table.
template <class Rows>
__device__ void dense_fold(const i64* meta, const i64* aux, i64 n_rows,
                           u64* tab, u64* table_g, const Rows& rows) {
  const int n_lanes = (int)meta[H_NLANES];
  const int groups = (int)meta[H_G];
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  const i64* lanes = meta + meta[H_OFF_LANES];
  const int cells = (n_lanes + 1) * groups;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int lane = i / groups;
    tab[i] = (u64)(lane == 0 ? 0 : identity((int)lanes[2 * (lane - 1) + 1]));
  }
  __syncthreads();

  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    typename Rows::Columns cols;
    if (!rows(row, &cols)) continue;
    i64 slot = pack_key(meta, aux, keys, n_keys, row, cols);
    slot = slot < 0 ? 0 : (slot >= groups ? groups - 1 : slot);
    atomicAdd(&tab[slot], 1ull);
    fold_lanes(meta, aux, lanes, n_lanes, row, cols,
               [&](int l) { return &tab[(l + 1) * groups + slot]; });
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int lane = i / groups;
    const int kind = lane == 0 ? LANE_ROWS : (int)lanes[2 * (lane - 1) + 1];
    const i64 x = (i64)tab[i];
    if (x != identity(kind)) fold(kind, &table_g[i], x);
  }
}

// Every admitted row folded into the global hash table `table` of
// [lanes + 2][cap] (row 0 keys, EMPTY = -1; row 1 counts; then the lanes):
// the packed key is the slot when `identity_slots`, else a probed slot. A
// row that finds no slot sets *overflow and is dropped.
template <class Rows>
__device__ void hash_fold(const i64* meta, const i64* aux, i64 n_rows,
                          i64 cap, int identity_slots, i64* table,
                          int* overflow, const Rows& rows) {
  const int n_lanes = (int)meta[H_NLANES];
  const int n_keys = (int)meta[H_NKEYS];
  const i64* keys = meta + meta[H_OFF_KEYS];
  const i64* lanes = meta + meta[H_OFF_LANES];
  u64* counts = (u64*)(table + cap);   // row 1 of the table, then the lanes

  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    typename Rows::Columns cols;
    if (!rows(row, &cols)) continue;
    const i64 packed = pack_key(meta, aux, keys, n_keys, row, cols);
    i64 slot;
    if (identity_slots) {
      slot = packed >= 0 && packed < cap ? packed : -1;
      if (slot >= 0 && table[slot] != packed) table[slot] = packed;
    } else {
      slot = packed >= 0 ? find_slot(table, cap, packed) : -1;
    }
    if (slot < 0) {
      *overflow = 1;
      continue;
    }
    atomicAdd(&counts[slot], 1ull);
    fold_lanes(meta, aux, lanes, n_lanes, row, cols,
               [&](int l) { return &counts[(i64)(l + 1) * cap + slot]; });
  }
}

// ---- the join chain ---------------------------------------------------------

// The build row that hop `hop` (a record of the chain section) finds for
// the current row, -1 for none: each probe-key program evaluated over the
// pair space so far, NULL or outside the build's [lo, hi] never matching,
// packed as the build packed its keys, looked up in the build's table.
template <class Columns>
__device__ __forceinline__ i64 hop_lookup(const i64* meta, const i64* aux,
                                          const i64* hop, i64 row,
                                          const Columns& cols) {
  const int kind = (int)hop[HOP_KIND];
  if (kind == TAB_EMPTY) return -1;
  i64 packed = 0;
  const int n_keys = (int)hop[HOP_NKEYS];
  for (int k = 0; k < n_keys; ++k) {
    const i64* kr = hop + HOP_KEY0 + 4 * k;
    i64 v;
    if (!run(meta, aux, (int)kr[0], row, cols, &v)) return -1;
    if (v < kr[1] || v > kr[2]) return -1;
    packed |= (v - kr[1]) << kr[3];
  }
  const int* rows = (const int*)hop[HOP_TABLE];
  if (kind == TAB_DIRECT) return __ldg(rows + packed);
  const i64* keys = (const i64*)hop[HOP_KEYS];
  const i64 mask = hop[HOP_SIZE] - 1;
  i64 h = (i64)(splitmix64((u64)packed) & (u64)mask);
  for (i64 probes = 0; probes <= mask; ++probes) {
    const i64 seen = __ldg((const long long*)keys + h);
    if (seen == packed) return __ldg(rows + h);
    if (seen == kEmpty) return -1;
    h = (h + 1) & mask;
  }
  return -1;
}

// Rows of a join-chain aggregate: the probe predicate over the spine, then
// each hop in chain order (INNER and SEMI need a match, ANTI needs none;
// the build row an INNER hop found is kept in a register for the payload
// loads of later hops, the residual, the keys and the lanes), then the
// residual predicate (H_PRED) over the whole pair space.
struct ChainRows {
  const i64* meta;
  const i64* aux;
  typedef ChainColumns Columns;
  __device__ __forceinline__ bool operator()(i64 row,
                                             ChainColumns* cols) const {
    const i64* ch = meta + meta[H_OFF_CHAIN];
    cols->cols = meta + meta[H_OFF_COLS];
    cols->hop_of = ch + ch[C_OFF_HOPOF];
#pragma unroll
    for (int h = 0; h < kMaxHops; ++h) cols->brow[h] = -1;
    i64 x;
    if (ch[C_PPRED] >= 0 &&
        !(run(meta, aux, (int)ch[C_PPRED], row, *cols, &x) && x != 0)) {
      return false;
    }
    const int n_hops = (int)ch[C_NHOPS];
    for (int h = 0; h < n_hops; ++h) {
      const i64* hop = ch + C_HOPS + h * kHopWords;
      const i64 b = hop_lookup(meta, aux, hop, row, *cols);
      if ((int)hop[HOP_JTYPE] == JT_ANTI ? b >= 0 : b < 0) return false;
      cols->brow[h] = b;
    }
    if (meta[H_PRED] < 0) return true;
    return run(meta, aux, (int)meta[H_PRED], row, *cols, &x) && x != 0;
  }
};

// ---- launch -----------------------------------------------------------------

// Blocks of `threads` for a grid-stride loop over `n` items: one per
// `threads` items, at most 8 per SM of the current device, at least one.
inline unsigned grid_blocks(long long n, int threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + threads - 1) / threads;
  const long long most = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace
