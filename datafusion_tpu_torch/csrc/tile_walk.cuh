// tile_walk.cuh: the parts of the join chain's tile walk that the
// aggregate walk (chain_aggregate.cu) and the row-returning walk
// (chain_rows.cu) share.
//
// A warp tests the probe predicate on its spine rows, kRowsPerStep x 32 at
// a time (`admit_rows`: the host's conjuncts, a one-column test read
// straight from its column), and appends the admitted rows to its list in
// shared memory in spine order (`warp_append`: a ballot and a popcount).
// `walk_hops` then runs the list through the chain's hops: for each hop in
// order the lanes take the list's entries densely, so every hop's lookups
// are issued by full warps however few rows survive; each entry's row
// handle goes to handles[hop][entry] in shared memory (int32: a build row,
// or a folded hop's slot), and the survivors are compacted, in order, in
// place. Later loads of a payload column read the handle of its hop
// (`TileColumns`), so no thread holds a row handle a hop in registers.
#pragma once

#include "program.cuh"

namespace {

// Spine rows a lane tests a step.
constexpr int kRowsPerStep = 2;

// Appends v where keep to the warp's `list`, whose first n entries are
// taken, after the lanes below; returns the new count, the same in every
// lane. Every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool keep, int v, int* list,
                                           int n) {
  const unsigned b = __ballot_sync(kWarp, keep);
  if (keep) list[n + __popc(b & ((1u << lane_id()) - 1u))] = v;
  return n + __popc(b);
}

// Column loads of the tile walk's pair space for list entry `e`: a spine
// column (hop_of < 0) at the row given, a payload column of hop h at the
// handle the walk stored for the entry (handles[h * cap + e]: its build
// row, or for a folded hop its slot times HOP_FOLD, the index of the
// record's first int64 word, the column's descriptor then pointing at the
// column's word of record 0 as an int64 column); a hop that found nothing
// reads as NULL. `handles` may lie in shared or global memory.
template <bool Full, bool Staged>
struct TileColumns {
  static constexpr bool kFull = Full;
  const i64* meta;      // the descriptor in shared memory
  const int* handles;   // [hops][cap]
  int cap;
  int e;

  __device__ __forceinline__ i64 handle(int h) const {
    const int b = handles[h * (i64)cap + e];
    if (b < 0) return -1;
    if constexpr (Staged) {
      const i64* ch = meta + meta[H_OFF_CHAIN];
      const i64 f = ch[C_HOPS + h * kHopWords + HOP_FOLD];
      if (f) return (i64)b * f;
    }
    return b;
  }

  __device__ __forceinline__ bool operator()(i64 idx, i64 row, i64* v) const {
    const i64* ch = meta + meta[H_OFF_CHAIN];
    const int h = (int)ch[ch[C_OFF_HOPOF] + idx];
    if (h >= 0) {
      row = handle(h);
      if (row < 0) {
        *v = 0;
        return false;
      }
    }
    return load_valid(meta + meta[H_OFF_COLS] + 3 * idx, row, v);
  }
};

// Which of the lane's R rows (row[r], those with alive[r]) pass the probe
// predicate, conjunct by conjunct: a direct conjunct loads its column for
// every row still alive at once, then tests them.
template <int R, class Columns>
__device__ __forceinline__ void admit_rows(const i64* meta, const i64* aux,
                                           const i64* ch, const i64 (&row)[R],
                                           bool (&alive)[R],
                                           const Columns& cols) {
  const i64* cj = ch + ch[C_OFF_CONJ];
  const int n = (int)ch[C_NCONJ];
  for (int c = 0; c < n; ++c, cj += kConjWords) {
    if ((int)cj[0] == CJ_PROG) {
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        i64 x;
        if (alive[r]) {
          alive[r] = run(meta, aux, (int)cj[1], row[r], cols, &x) && x != 0;
        }
      }
      continue;
    }
    i64 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (alive[r]) alive[r] = cols(cj[1], row[r], &x[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (alive[r]) alive[r] = conjunct_test(meta, aux, cj, x[r], row[r],
                                             cols);
    }
  }
}

// Walks the first n entries of the warp's `rows` (admitted spine rows)
// through the hops; returns the entries that survive every hop, which are
// rows[0..m) when *dense is left true, else the entries list[0..m) name.
// `list` holds `cols.cap` entries, compacted in place hop after hop (a
// round reads its entries before it writes, and writes no further than it
// read), `handles` [hops][cap]; every lane of the warp calls it.
template <bool Full, bool Staged>
__device__ __forceinline__ int walk_hops(const i64* meta, const i64* aux,
                                         const int* rows, int n, int* list,
                                         int* handles,
                                         TileColumns<Full, Staged>& cols,
                                         bool* dense) {
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const int n_hops = (int)ch[C_NHOPS];
  const int cap = cols.cap;
  const int width = __popc(warp_members());
  const int lane = lane_id();
  *dense = true;   // the list is still rows[0..n) in order
  int m = n;
  for (int h = 0; h < n_hops && m > 0; ++h) {
    const i64* hop = ch + C_HOPS + h * kHopWords;
    int kept = 0;
    for (int i0 = 0; i0 < m; i0 += width) {
      const int i = i0 + lane;
      const int e = i < m ? (*dense ? i : list[i]) : 0;
      bool keep = false;
      if (i < m) {
        cols.e = e;
        const i64 row = rows[e];
        i64 slot = 0;
        i64 b;
        if constexpr (Staged) {
          b = hop[HOP_KIND] == TAB_COMPOSED
                  ? composed_row(hop, cols.handle((int)hop[HOP_OWNER]), &slot)
                  : hop_lookup<true>(meta, aux, hop, row, cols, &slot);
        } else {
          b = hop_lookup<false>(meta, aux, hop, row, cols, &slot);
        }
        if constexpr (Full) {
          if (b >= 0 && hop[HOP_MOP] >= 0 &&
              !mmx_exists(meta, aux, hop, row, cols, slot)) {
            b = -1;
          }
        }
        keep = (int)hop[HOP_JTYPE] == JT_ANTI ? b < 0 : b >= 0;
        if constexpr (Staged) {
          if (hop[HOP_FOLD] && b >= 0) b = slot;
        }
        handles[h * cap + e] = b < 0 ? -1 : (int)b;
      }
      __syncwarp();
      kept = warp_append(keep, e, list, kept);
    }
    __syncwarp();
    *dense = false;
    m = kept;
  }
  return m;
}

}  // namespace
