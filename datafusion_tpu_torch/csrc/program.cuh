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
// row, build payloads at the row each hop found, a folded hop's payloads
// in its records at the record's first word).
//
// The row bodies `dense_fold` and `hash_fold` (a dense shared-memory
// table of <= 64 slots, a global hash table) are templates on the row
// source: `PlainRows` admits the rows that pass an aggregate's predicate,
// `ChainRows` those that also survive the join chain's walk, so the
// grouped aggregate and the join-chain aggregate share one fold (the
// walks' dense fold, `dense_fold_rows`, folds a row at a time). The
// per-row step `hash_fold_row` and the per-warp step `dense_fold_warp` are
// also called once a matching pair by the fanout-N join-aggregate
// (join_aggregate.cu), whose loader `PairColumns` reads build columns in
// the pair's entry record.
//
// The dense fold reduces before any atomic. A warp takes 32 consecutive
// rows a step; each row's admitted bit and slot are found once; then each
// lane program runs and the warp reduces its value over the rows of each
// slot (their peers, by __match_any_sync; at G = 1 the whole warp): counts
// by a ballot, sums, min and max by shuffles (`warp_reduce`, a butterfly;
// `reduce_peers`, a tree over a peer set). The lowest peer makes one
// shared-memory update a slot and lane a warp, and a float min or max runs
// its CAS loop once a warp, not once a row. At G = 1 the aggregate kernel
// goes further (`dense_fold_tiles`): a lane folds its rows of a tile of
// Tile x 32 into a register before the warp reduces, one update a lane a
// tile. What bounds it then is the interpreter, not the atomics. Every
// fold, warp or row at a time, takes what a row adds to a lane from one
// place, `lane_value`, which holds the lane rules.
//
// Lanes run in passes of at most 32 (groupby.py MAX_LANES): a descriptor
// holds one pass's lanes, and H_LANE0 says where they start among the
// table's lane rows. The first pass counts the rows and, in hash mode,
// claims every key's slot; a later pass re-runs the same rows and finds
// the same slots before any EMPTY one.
//
// count(DISTINCT x) is a lane kind: an admitted row whose argument is valid
// inserts the pair (group slot and lane, value) into one global
// open-addressing set (`distinct_insert`); the insert that created the
// pair adds 1 to the group's lane (in the dense fold, a 1 reduced with the
// warp's others), so each pair counts once, in one pass, across every
// batch and block.
//
// Exactness. Integer arithmetic wraps in 64 bits (signed overflow is
// undefined in C++, so it goes through unsigned). There is no signed 64-bit
// atomicAdd: the value is added through unsigned long long, which wraps
// identically. There are no float64 atomic min and max: a compare-and-swap
// loop does them; NaN never reaches them (it is masked out and counted in a
// NANCNT lane). The warp reductions add floats in another order than one
// row at a time; integer lanes stay exact.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

// opcodes: datafusion_tpu_torch/device/lower.py
enum {
  OP_COL = 1, OP_ICONST = 2, OP_FCONST = 3, OP_NULL = 4, OP_ROWID = 5,
  OP_ADD_I = 10, OP_SUB_I = 11, OP_MUL_I = 12,
  OP_ADD_F = 13, OP_SUB_F = 14, OP_MUL_F = 15,
  OP_NEG_I = 16, OP_NEG_F = 17,
  OP_MULC_I = 20, OP_DIVC_F = 22, OP_I2F = 23, OP_F32 = 24,
  OP_WRAP32 = 25,
  OP_CMP_I = 30, OP_CMP_F = 31, OP_STRCMP = 32, OP_DECCMP = 33, OP_LUT = 34,
  OP_IN_I = 35, OP_IN_F = 36,
  OP_AND = 40, OP_OR = 41, OP_NOT = 42, OP_ISNULL = 43, OP_ISNOTNULL = 44,
  OP_DIV_I = 50, OP_MOD_I = 51, OP_DIV_F = 52, OP_MOD_F = 53,
  OP_SELECT = 54, OP_MATH = 55, OP_DATEPART = 56,
  OP_AUX = 58, OP_F2I = 59, OP_DECCMP_AUX = 60,
};
// OP_MATH function ids and OP_DATEPART part ids (lower.py MATH_FUNCS,
// DATE_PARTS)
enum { M_ABS, M_SQRT, M_EXP, M_LN, M_LOG2, M_LOG10, M_SIN, M_COS, M_TAN,
       M_FLOOR, M_CEIL };
enum { P_YEAR, P_QUARTER, P_MONTH, P_DAY, P_WEEK, P_DOY, P_DOW, P_EPOCH,
       P_HOUR, P_MINUTE, P_SECOND, P_MILLISECOND, P_MICROSECOND,
       P_NANOSECOND };
enum { CMP_EQ, CMP_NE, CMP_LT, CMP_LE, CMP_GT, CMP_GE };

// lane kinds: datafusion_tpu_torch/device/groupby.py
enum {
  LANE_ROWS = 0, LANE_CNT = 1, LANE_SUM_I64 = 2, LANE_SUM_F64 = 3,
  LANE_MIN_I64 = 4, LANE_MAX_I64 = 5, LANE_MIN_F64 = 6, LANE_MAX_F64 = 7,
  LANE_NANCNT = 8, LANE_SUM_F32 = 9, LANE_DISTINCT = 10,
  LANE_DISTINCT_F64 = 11,
};

// column dtype codes: datafusion_tpu_torch/device/groupby.py
enum { DT_BOOL, DT_I32, DT_I64, DT_F32, DT_F64 };

// descriptor header words
enum { H_NCOLS, H_NLANES, H_G, H_NKEYS, H_PRED, H_OFF_COLS, H_OFF_PROGS,
       H_OFF_CODE, H_OFF_ICONST, H_OFF_FCONST, H_OFF_KEYS, H_OFF_LANES,
       H_OFF_CHAIN, H_LANE0, H_DSET, H_DMASK };

// join-chain section (datafusion_tpu_torch/device/join_chain.py): a head,
// one record per hop, then the hop of every pair-space column (-1: spine)
enum { C_NSPINE, C_NHOPS, C_PPRED, C_OFF_HOPOF, C_HOPS };
// HOP_MOP: the comparison code of a SEMI/ANTI min/max membership test
// (-1: none), HOP_MPROG its probe program, HOP_MN/HOP_MX the int64 min and
// max of the member column, slot-aligned with the table. HOP_TABLE holds
// each slot's build row as an int32 every HOP_STRIDE bytes: an int32 table
// (4), or a folded hop's records of HOP_FOLD int64 words, the row in the
// first (its row handle is then slot x HOP_FOLD). A composed hop
// (TAB_COMPOSED) reads its int64 words at (const i64*)HOP_TABLE +
// brow[HOP_OWNER] x HOP_STRIDE: its row, then a min/max hop's min and max
// (HOP_MN, HOP_MX: the same words at handle 0).
enum { HOP_KIND, HOP_JTYPE, HOP_TABLE, HOP_KEYS, HOP_SIZE, HOP_NKEYS,
       HOP_MOP, HOP_MPROG, HOP_MN, HOP_MX, HOP_STRIDE, HOP_OWNER, HOP_FOLD,
       HOP_KEY0 };
constexpr int kMaxHops = 8;
constexpr int kMaxHopKeys = 4;
constexpr int kHopWords = HOP_KEY0 + 4 * kMaxHopKeys;  // (prog, lo, hi, shift)
enum { TAB_DIRECT, TAB_HASH, TAB_EMPTY, TAB_COMPOSED };  // build table kinds
enum { JT_INNER, JT_SEMI, JT_ANTI };                    // hop join types

constexpr int kMaxStack = 16;
constexpr i64 kEmpty = -1;   // key of a free hash slot

__device__ __forceinline__ double as_f(i64 b) { return __longlong_as_double(b); }
__device__ __forceinline__ i64 as_i(double d) { return __double_as_longlong(d); }

// wrapping integer arithmetic (signed overflow is undefined in C++)
__device__ __forceinline__ i64 wadd(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 wsub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 wmul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }

// Python's floor `//` and `mod` for b != 0 and (a, b) != (INT64_MIN, -1)
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ i64 floormod(i64 a, i64 b) {
  const i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// -x and |x| in an operand width of 32 or 64 bits (values held in int64):
// the width's minimum stays itself, as int32/int64 negation wraps
__device__ __forceinline__ i64 wneg(i64 x, int width) {
  return width == 32 ? (x == INT32_MIN ? x : -x) : wsub(0, x);
}
__device__ __forceinline__ i64 wabs(i64 x, int width) {
  return x < 0 ? wneg(x, width) : x;
}
__device__ __forceinline__ i64 sgn(i64 x) { return (x > 0) - (x < 0); }

// `/` and `%` as the reference's device path computes them
// (datafusion_tpu/device/lower.py:496-507): a zero divisor counts as 1;
// integer `/` is sign(x) sign(y) (|x| // |y|), `%` is x >= 0 ? x mod |y| :
// -((-x) mod |y|). |y| is >= 1 or the width's minimum, so no division
// traps, INT64_MIN / -1 included (it wraps to INT64_MIN).
__device__ __forceinline__ i64 div_i(i64 x, i64 y, int width) {
  const i64 safe = y == 0 ? 1 : y;
  return wmul(sgn(x) * sgn(safe), floordiv(wabs(x, width), wabs(safe, width)));
}
__device__ __forceinline__ i64 mod_i(i64 x, i64 y, int width) {
  const i64 m = wabs(y == 0 ? 1 : y, width);
  return x >= 0 ? floormod(x, m) : wneg(floormod(wneg(x, width), m), width);
}
__device__ __forceinline__ double mod_f(double x, double y) {
  const double m = fabs(y == 0.0 ? 1.0 : y);
  return x >= 0 ? fmod(x, m) : -fmod(-x, m);
}

// float64 -> int64 toward zero; NaN gives 0, out-of-range values saturate
__device__ __forceinline__ i64 f2i(double x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return INT64_MAX;
  if (x <= -9223372036854775808.0) return INT64_MIN;
  return (i64)x;
}

__device__ __forceinline__ double math_fn(int fid, double x) {
  switch (fid) {
    case M_ABS: return fabs(x);
    case M_SQRT: return sqrt(x);
    case M_EXP: return exp(x);
    case M_LN: return log(x);
    case M_LOG2: return log2(x);
    case M_LOG10: return log10(x);
    case M_SIN: return sin(x);
    case M_COS: return cos(x);
    case M_TAN: return tan(x);
    case M_FLOOR: return floor(x);
    default: return ceil(x);
  }
}

// civil from days and the day of 1 January (Hinnant; lower.py:619-645)
__device__ __forceinline__ void days_to_ymd(i64 days, i64* y, i64* m,
                                            i64* d) {
  const i64 z = days + 719468;
  const i64 era = floordiv(z, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const i64 doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const i64 mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2);
}
__device__ __forceinline__ i64 jan1(i64 y) {
  const i64 yy = y - 1;
  const i64 era = floordiv(yy, 400);
  const i64 yoe = yy - era * 400;
  return era * 146097 + yoe * 365 + yoe / 4 - yoe / 100 + 306 - 719468;
}

// date_part of a raw date/timestamp value x (lower.py:678-722): to_us
// converts it to microseconds (a negative to_us divides by -to_us)
__device__ double date_part(int part, i64 to_us, i64 x) {
  const i64 day_us = 86400000000LL;
  const i64 us = to_us < 0 ? floordiv(x, -to_us) : wmul(x, to_us);
  const i64 days = floordiv(us, day_us);
  const i64 within = wsub(us, wmul(days, day_us));
  i64 y, m, d, out;
  switch (part) {
    case P_EPOCH: return (double)us / 1e6;
    case P_YEAR: case P_QUARTER: case P_MONTH: case P_DAY: case P_DOY:
      days_to_ymd(days, &y, &m, &d);
      out = part == P_YEAR ? y : part == P_QUARTER ? (m - 1) / 3 + 1
          : part == P_MONTH ? m : part == P_DAY ? d : days - jan1(y) + 1;
      break;
    case P_WEEK: {  // ISO week: that of this week's Thursday
      const i64 thu = days - floormod(days + 3, 7) + 3;
      days_to_ymd(thu, &y, &m, &d);
      out = floordiv(thu - jan1(y), 7) + 1;
      break;
    }
    case P_DOW: out = floormod(days + 4, 7); break;
    case P_HOUR: out = within / 3600000000LL; break;
    case P_MINUTE: out = within % 3600000000LL / 60000000LL; break;
    case P_SECOND: out = within % 60000000LL / 1000000LL; break;
    case P_MILLISECOND: out = within % 60000000LL / 1000; break;
    case P_MICROSECOND: out = within % 60000000LL; break;
    default: out = within % 60000000LL * 1000; break;  // P_NANOSECOND
  }
  return (double)out;
}

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
// dtype code) per column index, at meta[H_OFF_COLS]. `Full` picks the
// interpreter's variant (`run`), as in every loader.
template <bool Full>
struct RowColumns {
  static constexpr bool kFull = Full;
  const i64* cols;
  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    return load_valid(cols + 3 * idx, row, v);
  }
};

// Column loads of a join chain's pair space: a spine column (hop_of < 0)
// at the spine row, a payload column of hop h at the row handle that hop
// found (brow[h]: its build row, or for a folded hop the index of its
// record's first int64 word, the column's descriptor then pointing at the
// column's word of record 0 as an int64 column, and its validity at the
// records' validity bytes, laid out as the words); a hop that found
// nothing reads as NULL. The loads are the same for every chain, so the
// interpreter's code is too.
template <bool Full>
struct ChainColumns {
  static constexpr bool kFull = Full;
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

// Column loads of a fanout-N join's pair space (join_aggregate.cu): the
// first n_build indices are build columns, read at the pair's build row
// (NULL before a match), the rest probe columns at the probe row.
template <bool Full>
struct PairColumns {
  static constexpr bool kFull = Full;
  const i64* cols;
  i64 n_build;
  i64 brow;
  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    if (idx < n_build) {
      if (brow < 0) {
        *v = 0;
        return false;
      }
      row = brow;
    }
    return load_valid(cols + 3 * idx, row, v);
  }
};

// Run program `prog` for one row. Returns the valid bit; the value
// (int64, or float64 bits) goes to *out. `col(idx, row, &v)` loads one
// column value and returns its valid bit.
//
// The loader's `kFull` picks one of two variants. The full one runs every
// opcode. The lean one leaves out the opcodes from OP_DIV_I on (`/`, `%`,
// CASE, the math functions, date_part, scalar subqueries): their integer
// division, math library and calendar would cost every walk registers and
// spills that most programs never use. The host launches the full variant
// for a descriptor whose programs use any of them (`_ProgramSpec.full` in
// groupby.py).
template <class Columns>
__device__ bool run(const i64* meta, const i64* aux, int prog, i64 row,
                    const Columns& col, i64* out) {
  constexpr bool kFull = Columns::kFull;
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
      case OP_ROWID: v[sp] = row; SET_OK(sp, 1); ++sp; break;
      case OP_AUX: {
        if constexpr (kFull) {
          const i64* s = aux + aux[2 * a];
          v[sp] = s[0];
          SET_OK(sp, s[1] != 0);
          ++sp;
        }
        break;
      }
      case OP_ADD_I: case OP_SUB_I: case OP_MUL_I:
      case OP_ADD_F: case OP_SUB_F: case OP_MUL_F:
      case OP_DIV_I: case OP_MOD_I: case OP_DIV_F: case OP_MOD_F:
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
          case OP_DIV_I: r = kFull ? div_i(x, y, (int)b) : 0; break;
          case OP_MOD_I: r = kFull ? mod_i(x, y, (int)b) : 0; break;
          case OP_DIV_F: r = kFull ? as_i(as_f(x) / as_f(y)) : 0; break;
          case OP_MOD_F:
            r = kFull ? as_i(mod_f(as_f(x), as_f(y))) : 0;
            break;
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
      case OP_SELECT: {  // (acc, cond, then)
        if constexpr (kFull) {
          if (OK(sp - 2) && v[sp - 2] != 0) {
            v[sp - 3] = v[sp - 1];
            SET_OK(sp - 3, OK(sp - 1));
          }
          sp -= 2;
        }
        break;
      }
      case OP_MATH:
        if constexpr (kFull) {
          v[sp - 1] = as_i(math_fn((int)a, as_f(v[sp - 1])));
        }
        break;
      case OP_DATEPART:
        if constexpr (kFull) {
          v[sp - 1] = as_i(date_part((int)a, b, v[sp - 1]));
        }
        break;
      case OP_F2I:
        if constexpr (kFull) v[sp - 1] = f2i(as_f(v[sp - 1]));
        break;
      case OP_DECCMP_AUX: {
        if constexpr (kFull) {
          const i64* s = aux + aux[2 * b];
          const i64 x = v[sp - 1], t_ge = s[0], t_gt = s[1];
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
          SET_OK(sp - 1, OK(sp - 1) && s[2] != 0);
        }
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

// ---- the distinct set -------------------------------------------------------

// Insert the pair (a, b) into the distinct set `set` of mask + 1 entries
// (a power of two) of three int64 words each, (tag, a, b), then one
// overflow word; true when this call created the pair. A tag is 0 while
// the entry is free; a claim CASes in the pair's hash with bit 1 set and
// bit 0 clear, writes the pair, then sets bit 0, after which the entry
// never changes. A thread that meets a claimed entry of its own tag waits
// for bit 0 before it compares the pair: a 64-bit CAS suffices, and two
// threads with one pair agree on which of them created it. A probe that
// wraps the whole set sets the overflow word and drops the pair; the set
// is sized at twice the pairs there can be, so that does not happen.
__device__ __forceinline__ bool distinct_insert(i64* set, i64 mask, i64 a,
                                                i64 b) {
  const u64 h = splitmix64((u64)a ^ splitmix64((u64)b));
  const u64 ready = h | 3ull, claimed = ready ^ 1ull;
  i64 i = (i64)(h & (u64)mask);
  for (i64 probes = 0; probes <= mask; ++probes) {
    u64* e = (u64*)(set + 3 * i);
    u64 seen = *(volatile u64*)e;
    if (seen == 0) {
      seen = atomicCAS(e, 0ull, claimed);
      if (seen == 0) {
        ((volatile i64*)e)[1] = a;
        ((volatile i64*)e)[2] = b;
        __threadfence();
        *(volatile u64*)e = ready;
        return true;
      }
    }
    if ((seen | 1ull) == ready) {
      while ((seen & 1ull) == 0) seen = *(volatile u64*)e;
      __threadfence();
      if (((volatile i64*)e)[1] == a && ((volatile i64*)e)[2] == b) {
        return false;
      }
    }
    i = (i + 1) & mask;
  }
  *(volatile i64*)(set + 3 * (mask + 1)) = 1;
  return false;
}

// ---- warp reductions ----------------------------------------------------------

constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return (int)(threadIdx.x & 31); }

// The lanes of the calling warp that hold a thread: all 32 on the card (the
// kernels launch whole warps), one where the sources run as one thread.
__device__ __forceinline__ unsigned warp_members() {
  return __ballot_sync(kWarp, 1);
}

// a and b combined under a lane kind's fold: min, max, a float add (in
// float32 for SUM_F32, whose values are float32s held as float64), or a
// wrapping int64 add (counts and int64 sums)
__device__ __forceinline__ i64 combine(int kind, i64 a, i64 b) {
  switch (kind) {
    case LANE_SUM_F64: return as_i(as_f(a) + as_f(b));
    case LANE_SUM_F32:
      return as_i((double)((float)as_f(a) + (float)as_f(b)));
    case LANE_MIN_I64: return b < a ? b : a;
    case LANE_MAX_I64: return b > a ? b : a;
    case LANE_MIN_F64: return as_f(b) < as_f(a) ? b : a;
    case LANE_MAX_F64: return as_f(b) > as_f(a) ? b : a;
    default: return wadd(a, b);
  }
}

// lanes whose per-row values are 0 or 1, reduced by a ballot
__device__ __forceinline__ bool counts_kind(int kind) {
  return kind == LANE_ROWS || kind == LANE_CNT || kind == LANE_NANCNT ||
         kind == LANE_DISTINCT || kind == LANE_DISTINCT_F64;
}

// x combined over every member of the warp (a butterfly of shuffles), in
// every lane.
__device__ __forceinline__ i64 warp_reduce(int kind, unsigned members, i64 x) {
  const int lane = lane_id();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const i64 t = __shfl_xor_sync(kWarp, x, o);
    if ((members >> (lane ^ o)) & 1u) x = combine(kind, x, t);
  }
  return x;
}

// x combined over the lanes of `peers` (the calling lane's set), in the
// lowest lane of each set: a tree over the set in log2(its size) rounds,
// each lane adding in the next lane still in play (Harris, "Voting and
// shuffling to optimize atomic operations"). Every lane of the warp calls
// it.
__device__ __forceinline__ i64 reduce_peers(int kind, unsigned peers, i64 x) {
  const int lane = lane_id();
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);   // the peers above this lane
  while (__any_sync(kWarp, peers != 0)) {
    const int next = __ffs(peers);
    const i64 t = __shfl_sync(kWarp, x, (next - 1) & 31);
    if (next) x = combine(kind, x, t);
    peers &= ~__ballot_sync(kWarp, rank & 1u);
    rank >>= 1;
  }
  return x;
}

// ---- the lane folds ---------------------------------------------------------

// What one admitted row adds to lane `l` of group `slot` (program `prog`,
// kind `kind`): false when it adds nothing, else true with the value in
// *out, as `fold` and `combine` take it. The rules of
// DeviceGroupAggregateExec._make_step.prepare
// (datafusion_tpu/physical/plan/device_aggregate.py:718-767): count(*) and
// CNT count the row (CNT only where its argument is valid), NaN is kept
// out of float min and max and counted in the NANCNT lane. A DISTINCT lane
// counts the row when its (slot, lane, value) pair is new to the set at
// meta[H_DSET] (its insert happens here): the value is the argument's
// int64, or for a float its float64 bits with -0.0 read as 0.0
// (`:732-743`); NULL never counts.
template <class Columns>
__device__ __forceinline__ bool lane_value(const i64* meta, const i64* aux,
                                           int prog, int kind, int l, i64 row,
                                           const Columns& cols, i64 slot,
                                           i64* out) {
  if (prog < 0) {   // count(*)
    *out = 1;
    return true;
  }
  i64 x;
  if (!run(meta, aux, prog, row, cols, &x)) return false;
  switch (kind) {
    case LANE_CNT: x = 1; break;
    case LANE_NANCNT:
      if (!isnan(as_f(x))) return false;
      x = 1;
      break;
    case LANE_MIN_F64: case LANE_MAX_F64:
      if (isnan(as_f(x))) return false;
      break;
    case LANE_DISTINCT_F64: case LANE_DISTINCT:
      if (kind == LANE_DISTINCT_F64 && x == INT64_MIN) x = 0;  // -0.0
      if (!distinct_insert((i64*)meta[H_DSET], meta[H_DMASK],
                           (slot << 12) | (meta[H_LANE0] + l), x)) {
        return false;
      }
      x = 1;
      break;
    default: break;
  }
  *out = x;
  return true;
}

// Fold one row's lanes into the table cells cell(l) of group `slot`: one
// atomic a lane whose value (`lane_value`) is not its identity (a CASE
// sum's 0 makes none).
template <class Columns, class Cell>
__device__ __forceinline__ void fold_lanes(const i64* meta, const i64* aux,
                                           const i64* lanes, int n_lanes,
                                           i64 row, const Columns& cols,
                                           i64 slot, Cell cell) {
  for (int l = 0; l < n_lanes; ++l) {
    const int kind = (int)lanes[2 * l + 1];
    i64 x;
    if (lane_value(meta, aux, (int)lanes[2 * l], kind, l, row, cols, slot,
                   &x) && x != identity(kind)) {
      fold(kind, cell(l), x);
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

// ---- the row bodies ---------------------------------------------------------

// Rows of a plain aggregate: those that pass its predicate (H_PRED).
template <bool Full>
struct PlainRows {
  const i64* meta;
  const i64* aux;
  typedef RowColumns<Full> Columns;
  __device__ __forceinline__ bool operator()(i64 row, Columns* cols) const {
    cols->cols = meta + meta[H_OFF_COLS];
    if (meta[H_PRED] < 0) return true;
    i64 x;
    const bool valid = run(meta, aux, (int)meta[H_PRED], row, *cols, &x);
    return valid && x != 0;
  }
};

// The dense table of one pass in shared memory (`tab`: [lanes + 1][G], row
// 0 the counts), each cell at its identity.
__device__ __forceinline__ void dense_init(const i64* meta, u64* tab) {
  const int groups = (int)meta[H_G];
  const i64* lanes = meta + meta[H_OFF_LANES];
  const int cells = ((int)meta[H_NLANES] + 1) * groups;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int lane = i / groups;
    tab[i] = (u64)(lane == 0 ? 0 : identity((int)lanes[2 * (lane - 1) + 1]));
  }
  __syncthreads();
}

// One row (or pair) a lane of the calling warp folded into the dense table
// `tab`, `adm` saying which lanes hold an admitted one. The rows of one
// slot are reduced across the warp before any atomic: their lanes are the
// slot's peers (__match_any_sync on the slot, computed once a row and kept
// for every lane; at G = 1 the whole warp), counts reduce by a ballot and
// the other lanes by shuffles (`reduce_peers`, `warp_reduce`, so a float
// min or max runs its CAS loop once a warp), and the lowest peer makes one
// shared-memory update a slot and lane. Every lane of the warp calls it.
template <class Columns>
__device__ __forceinline__ void dense_fold_warp(const i64* meta,
                                                const i64* aux, bool adm,
                                                i64 row, const Columns& cols,
                                                u64* tab) {
  const unsigned admitted = __ballot_sync(kWarp, adm);
  if (admitted == 0) return;
  const int groups = (int)meta[H_G];
  int slot = 0;
  if (adm && groups > 1) {
    const i64 k = pack_key(meta, aux, meta + meta[H_OFF_KEYS],
                           (int)meta[H_NKEYS], row, cols);
    slot = (int)(k < 0 ? 0 : (k >= groups ? groups - 1 : k));
  }
  const unsigned members = warp_members();
  const unsigned peers =
      groups == 1 ? members : __match_any_sync(kWarp, adm ? slot : -1);
  const bool lead = (adm || groups == 1) && lane_id() == __ffs(peers) - 1;
  if (lead) atomicAdd(&tab[slot], (u64)__popc(admitted & peers));
  const i64* lanes = meta + meta[H_OFF_LANES];
  const int n_lanes = (int)meta[H_NLANES];
  for (int l = 0; l < n_lanes; ++l) {
    const int prog = (int)lanes[2 * l];
    const int kind = (int)lanes[2 * l + 1];
    i64 x;
    if (!(adm && lane_value(meta, aux, prog, kind, l, row, cols, slot, &x))) {
      x = identity(kind);
    }
    i64 r;
    if (counts_kind(kind)) {
      r = __popc(__ballot_sync(kWarp, x != 0) & peers);
    } else {
      r = groups == 1 ? warp_reduce(kind, members, x)
                      : reduce_peers(kind, peers, x);
    }
    if (lead && r != identity(kind)) fold(kind, &tab[(l + 1) * groups + slot], r);
  }
}

// One admitted row folded into the dense table `tab` on its own: one
// shared-memory atomic a lane (`fold_lanes`), for the join-chain walks
// (`dense_fold_rows`).
template <class Columns>
__device__ __forceinline__ void dense_fold_row(const i64* meta, const i64* aux,
                                               i64 row, const Columns& cols,
                                               u64* tab) {
  const int groups = (int)meta[H_G];
  i64 slot = pack_key(meta, aux, meta + meta[H_OFF_KEYS], (int)meta[H_NKEYS],
                      row, cols);
  slot = slot < 0 ? 0 : (slot >= groups ? groups - 1 : slot);
  atomicAdd(&tab[slot], 1ull);
  fold_lanes(meta, aux, meta + meta[H_OFF_LANES], (int)meta[H_NLANES], row,
             cols, slot, [&](int l) { return &tab[(l + 1) * groups + slot]; });
}

// The block's dense table merged into the global table `table_g` ([all
// lanes + 1][G]) with atomics: the counts by the first pass only, this
// pass's lanes into their rows from H_LANE0 on.
__device__ __forceinline__ void dense_merge(const i64* meta, u64* tab,
                                            u64* table_g) {
  __syncthreads();
  const int groups = (int)meta[H_G];
  const i64 lane0 = meta[H_LANE0];
  const i64* lanes = meta + meta[H_OFF_LANES];
  const int cells = ((int)meta[H_NLANES] + 1) * groups;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int lane = i / groups;
    if (lane == 0 && lane0 > 0) continue;
    const int kind = lane == 0 ? LANE_ROWS : (int)lanes[2 * (lane - 1) + 1];
    const i64 x = (i64)tab[i];
    const i64 at = lane == 0 ? i : (lane + lane0) * groups + i % groups;
    if (x != identity(kind)) fold(kind, &table_g[at], x);
  }
}

// G = 1 over tiles of Tile rows a lane: a lane's admitted rows are found
// first (their bits in one register), then each lane program runs over
// them into a register, and the warp reduces each lane once a tile: one
// shared-memory update a lane a tile of Tile x 32 rows. The rows' loader
// must not depend on the row (PlainRows).
template <int Tile, class Rows>
__device__ __forceinline__ void dense_fold_tiles(const i64* meta,
                                                 const i64* aux, i64 n_rows,
                                                 u64* tab, const Rows& rows,
                                                 i64 first, i64 step,
                                                 i64 width) {
  const unsigned members = warp_members();
  const int lane = lane_id();
  const bool lead = lane == __ffs(members) - 1;
  const i64* lanes = meta + meta[H_OFF_LANES];
  const int n_lanes = (int)meta[H_NLANES];
  for (i64 base = first; base < n_rows; base += step) {
    typename Rows::Columns cols;
    unsigned adm = 0;
#pragma unroll 1
    for (int r = 0; r < Tile; ++r) {
      const i64 row = base + r * width + lane;
      if (row < n_rows && rows(row, &cols)) adm |= 1u << r;
    }
    if (!__any_sync(kWarp, adm != 0)) continue;
    const i64 n = warp_reduce(LANE_ROWS, members, __popc(adm));
    if (lead) atomicAdd(&tab[0], (u64)n);
    for (int l = 0; l < n_lanes; ++l) {
      const int prog = (int)lanes[2 * l];
      const int kind = (int)lanes[2 * l + 1];
      i64 acc = identity(kind);
#pragma unroll 1
      for (int r = 0; r < Tile; ++r) {
        i64 x;
        if (((adm >> r) & 1u) &&
            lane_value(meta, aux, prog, kind, l, base + r * width + lane,
                       cols, 0, &x)) {
          acc = combine(kind, acc, x);
        }
      }
      acc = warp_reduce(kind, members, acc);
      if (lead && acc != identity(kind)) fold(kind, &tab[l + 1], acc);
    }
  }
}

// Every admitted row folded into a dense table of G = meta[H_G] <= 64 slots
// in shared memory (`tab`), merged into the global table `table_g` with
// atomics at the end, so any number of launches accumulate into one table.
// A warp takes 32 consecutive rows a step (Tile x 32 at G = 1:
// `dense_fold_tiles`), so its loads are coalesced and its rows reduce
// together (`dense_fold_warp`).
template <int Tile, class Rows>
__device__ void dense_fold(const i64* meta, const i64* aux, i64 n_rows,
                           u64* tab, u64* table_g, const Rows& rows) {
  dense_init(meta, tab);
  const i64 width = __popc(warp_members());
  const i64 per_block = (blockDim.x + 31) >> 5;
  const i64 warp = (i64)blockIdx.x * per_block + (threadIdx.x >> 5);
  const i64 warps = (i64)gridDim.x * per_block;
  if (meta[H_G] == 1) {
    dense_fold_tiles<Tile>(meta, aux, n_rows, tab, rows, warp * width * Tile,
                           warps * width * Tile, width);
  } else {
    for (i64 base = warp * width; base < n_rows; base += warps * width) {
      const i64 row = base + lane_id();
      typename Rows::Columns cols;
      const bool adm = row < n_rows && rows(row, &cols);
      dense_fold_warp(meta, aux, adm, row, cols, tab);
    }
  }
  dense_merge(meta, tab, table_g);
}

// Every admitted row folded into the dense table one row at a time
// (`dense_fold_row`), merged as `dense_fold` merges: the join-chain walks'
// fold. Their hops admit few rows, so their atomics are few, and the warp
// reduction's registers cost them more than it saves under their
// 64-register cap (measured on an NVIDIA H100: 48 more stack bytes, TPC-H
// Q12's walk 22% and Q14's 8% slower with it).
template <class Rows>
__device__ void dense_fold_rows(const i64* meta, const i64* aux, i64 n_rows,
                                u64* tab, u64* table_g, const Rows& rows) {
  dense_init(meta, tab);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    typename Rows::Columns cols;
    if (!rows(row, &cols)) continue;
    dense_fold_row(meta, aux, row, cols, tab);
  }
  dense_merge(meta, tab, table_g);
}

// One admitted row (or pair) folded into the global hash table `table` of
// [all lanes + 2][cap] (row 0 keys, EMPTY = -1; row 1 counts; then the
// lanes): the packed key is the slot when `identity_slots`, else a probed
// slot. A row that finds no slot sets *overflow and is dropped.
template <class Columns>
__device__ __forceinline__ void hash_fold_row(const i64* meta, const i64* aux,
                                              i64 row, const Columns& cols,
                                              i64 cap, int identity_slots,
                                              i64* table, int* overflow) {
  u64* counts = (u64*)(table + cap);   // row 1 of the table, then the lanes
  const i64 lane0 = meta[H_LANE0];
  const i64 packed = pack_key(meta, aux, meta + meta[H_OFF_KEYS],
                              (int)meta[H_NKEYS], row, cols);
  i64 slot;
  if (identity_slots) {
    slot = packed >= 0 && packed < cap ? packed : -1;
    if (slot >= 0 && table[slot] != packed) table[slot] = packed;
  } else {
    slot = packed >= 0 ? find_slot(table, cap, packed) : -1;
  }
  if (slot < 0) {
    *overflow = 1;
    return;
  }
  if (lane0 == 0) atomicAdd(&counts[slot], 1ull);
  fold_lanes(meta, aux, meta + meta[H_OFF_LANES], (int)meta[H_NLANES], row,
             cols, slot,
             [&](int l) { return &counts[(l + 1 + lane0) * cap + slot]; });
}

// Every admitted row folded into the global hash table (`hash_fold_row`).
template <class Rows>
__device__ void hash_fold(const i64* meta, const i64* aux, i64 n_rows,
                          i64 cap, int identity_slots, i64* table,
                          int* overflow, const Rows& rows) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += stride) {
    typename Rows::Columns cols;
    if (!rows(row, &cols)) continue;
    hash_fold_row(meta, aux, row, cols, cap, identity_slots, table,
                  overflow);
  }
}

// ---- the fanout-N join ------------------------------------------------------

// Join key kinds (datafusion_tpu_torch/device/join_agg.py): an integer, a
// float (its float64 bits, -0.0 read as 0.0, NaN never matching) or a
// dictionary code remapped into the build's dictionary (-1: absent from
// it, never matching).
enum { JK_INT, JK_FLOAT, JK_CODE };
constexpr int kMaxJoinKeys = 4;

// The key word of one join key value; false when the row can match nothing.
__device__ __forceinline__ bool join_key_word(int kind, bool valid, i64 x,
                                              i64* w) {
  if (!valid) return false;
  if (kind == JK_FLOAT) {
    if (isnan(as_f(x))) return false;
    if (x == INT64_MIN) x = 0;   // -0.0
  } else if (kind == JK_CODE && x < 0) {
    return false;
  }
  *w = x;
  return true;
}

// The hash of a row's key words, non-negative: splitmix64 of the first,
// each further word XORed into the hash so far and mixed by splitmix64.
// (Mixing both sides through one function, splitmix64(h) ^ splitmix64(w),
// sends every equal pair of words to one bucket: TPC-H partsupp's rows
// with ps_partkey = ps_suppkey.)
__device__ __forceinline__ i64 join_hash(const i64* w, int n) {
  u64 h = splitmix64((u64)w[0]);
  for (int k = 1; k < n; ++k) h = splitmix64(h ^ (u64)w[k]);
  return (i64)(h >> 1);
}

// ---- the join chain ---------------------------------------------------------

// The build row that hop `hop` (a record of the chain section) finds for
// the current row, -1 for none, and its table slot to *slot: each
// probe-key program evaluated over the pair space so far, NULL or outside
// the build's [lo, hi] never matching, packed as the build packed its
// keys, looked up in the build's table. `Staged`: the rows lie HOP_STRIDE
// bytes apart (a folded hop's records); else the table is int32 rows.
template <bool Staged, class Columns>
__device__ __forceinline__ i64 hop_lookup(const i64* meta, const i64* aux,
                                          const i64* hop, i64 row,
                                          const Columns& cols, i64* slot) {
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
  const char* rows = (const char*)hop[HOP_TABLE];
  const i64 stride = Staged ? hop[HOP_STRIDE] : 4;
  if (kind == TAB_DIRECT) {
    *slot = packed;
    return __ldg((const int*)(rows + packed * stride));
  }
  const i64* keys = (const i64*)hop[HOP_KEYS];
  const i64 mask = hop[HOP_SIZE] - 1;
  i64 h = (i64)(splitmix64((u64)packed) & (u64)mask);
  for (i64 probes = 0; probes <= mask; ++probes) {
    const i64 seen = __ldg((const long long*)keys + h);
    if (seen == packed) {
      *slot = h;
      return __ldg((const int*)(rows + h * stride));
    }
    if (seen == kEmpty) return -1;
    h = (h + 1) & mask;
  }
  return -1;
}

// The build row a composed hop finds through its owner's row handle
// (brow[HOP_OWNER]), -1 for none, and the int64 index of its words from
// HOP_TABLE to *slot: the owner's composed words (a build row's), or the
// owner's records when it is folded.
__device__ __forceinline__ i64 composed_row(const i64* hop, const i64* brow,
                                            i64* slot) {
  const i64 ob = brow[hop[HOP_OWNER]];
  if (ob < 0) return -1;
  *slot = ob * hop[HOP_STRIDE];
  return __ldg((const long long*)hop[HOP_TABLE] + *slot);
}

// The min/max membership test of a filtered SEMI/ANTI hop
// (device_join_chain.py:1325-1347): some member row of the key found at
// `slot` satisfies `member OP x`, x the hop's probe program over the pair
// space; a NULL x satisfies nothing.
template <class Columns>
__device__ __forceinline__ bool mmx_exists(const i64* meta, const i64* aux,
                                           const i64* hop, i64 row,
                                           const Columns& cols, i64 slot) {
  i64 x;
  if (!run(meta, aux, (int)hop[HOP_MPROG], row, cols, &x)) return false;
  const i64 mn = __ldg((const long long*)hop[HOP_MN] + slot);
  const i64 mx = __ldg((const long long*)hop[HOP_MX] + slot);
  switch ((int)hop[HOP_MOP]) {
    case CMP_NE: return mn != x || mx != x;
    case CMP_LT: return mn < x;
    case CMP_LE: return mn <= x;
    case CMP_GT: return mx > x;
    default: return mx >= x;  // CMP_GE
  }
}

// Rows of a join-chain aggregate: the probe predicate over the spine, then
// each hop in chain order (INNER and SEMI need a match, ANTI needs none; a
// filtered SEMI/ANTI hop's match must also pass its min/max membership
// test; the row handle an INNER hop found is kept for the payload loads of
// later hops, the residual, the keys and the lanes), then the residual
// predicate (H_PRED) over the whole pair space. A composed hop runs no
// probe-key program: it reads its row (and a min/max hop's min and max)
// from its owner's words at the owner's handle. A folded hop's handle is
// its record's first word. Only the full variant has the min/max test;
// the host picks it for a chain with a filtered hop. Only the `Staged`
// variant reads composed and folded hops; the host picks it for a chain
// that has any, so other walks keep their registers.
template <bool Full, bool Staged>
struct ChainRows {
  const i64* meta;
  const i64* aux;
  typedef ChainColumns<Full> Columns;
  __device__ __forceinline__ bool operator()(i64 row, Columns* cols) const {
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
      i64 slot;
      i64 b;
      if constexpr (Staged) {
        b = hop[HOP_KIND] == TAB_COMPOSED
                ? composed_row(hop, cols->brow, &slot)
                : hop_lookup<true>(meta, aux, hop, row, *cols, &slot);
      } else {
        b = hop_lookup<false>(meta, aux, hop, row, *cols, &slot);
      }
      if constexpr (Full) {
        if (b >= 0 && hop[HOP_MOP] >= 0 &&
            !mmx_exists(meta, aux, hop, row, *cols, slot)) {
          b = -1;
        }
      }
      if ((int)hop[HOP_JTYPE] == JT_ANTI ? b >= 0 : b < 0) return false;
      if constexpr (Staged) {
        if (hop[HOP_FOLD] && b >= 0) b = slot * hop[HOP_FOLD];
      }
      cols->brow[h] = b;
    }
    if (meta[H_PRED] < 0) return true;
    return run(meta, aux, (int)meta[H_PRED], row, *cols, &x) && x != 0;
  }
};

// ---- launch -----------------------------------------------------------------

// A walk kernel's instantiation from the host's variant: bit 0 the full
// interpreter, bit 1 the staged chain (join_chain.py `variant`).
#define DFT_WALK_VARIANT(kernel, variant)                              \
  ((variant) == 0   ? kernel<false, false>                             \
   : (variant) == 1 ? kernel<true, false>                              \
   : (variant) == 2 ? kernel<false, true>                              \
                    : kernel<true, true>)

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
