// chain_compose: resolve a join chain's snowflake hops when the chain is
// staged, and fold a hop's row and payload into one record a table slot:
// one launch a chain for all its compositions, one for all its folds.
//
// Replaces two staging programs of the JAX package's chain execs
// (datafusion_tpu/physical/plan/device_join_chain.py):
//   - _compose_staged_hops (:786), one program a composed hop,
//     _make_compose_prog (:926, jit :887): a hop whose probe keys are all
//     payload columns of one earlier INNER hop (its owner), or of hops
//     already composed into it, is probed once for each of the owner's
//     build rows, and its results ride extra int32 lanes of the owner's
//     payload matrix;
//   - _fold_lut_pmat (:719, jit :756): a direct-address INNER hop's
//     table and payload matrix merged into lutmat[key] = [row, lanes...].
// Here the results are int64 words: a composition writes, for each owner
// build row, the build row the hop finds (-1: none) and for a filtered
// SEMI/ANTI hop the member's min and max of the key found (0 where none);
// the walk reads them at the row it found for the owner and runs no
// probe-key program for the hop. A fold writes one record a slot of the
// hop's table (any layout), int64 words: the build row, the owner's
// composed words at that row, and the value of each payload column the
// walk's programs read as the interpreter loads it (a float32 widened),
// with a validity byte a word beside the records; the walk then resolves
// the hop and all that hangs on it from adjacent words of one record,
// loading a payload as an int64 column whose row is the record's first
// word (program.cuh `ChainColumns`), so its column loads are those of any
// chain.
//
// Design. Both kernels read one descriptor that the host uploads once a
// chain, from pinned memory, without a wait (join_chain.py `StageSpec`);
// neither needs its output zeroed first:
//   1. compose: one thread a build row of an owner, the owners' rows laid
//      end to end (a small table of each owner's first thread). A thread
//      walks, in chain order, every hop composed into its owner: the hop's
//      probe keys over the pair space (the owner's columns at the row, a
//      hop composed before it at the build row it found, in a register),
//      `hop_lookup` in the hop's own table, NULL or out-of-range keys
//      finding nothing, and writes all the hop's words. Every key of a
//      composed hop hangs on its one owner, so no thread waits for
//      another. A row the owner's build predicate dropped is probed too:
//      its words are defined, and the walk never reads them.
//   2. fold: one thread a slot of a folded table, the folded tables' slots
//      laid end to end; it writes every word and every validity byte of
//      its record, an empty slot's -1 and zeros included.
//
// Bounds. TPC-H Q5 at SF10 composes nation and region into supplier's
// 100,000 rows: an 8-byte key column read and 8 bytes written a row and
// hop, the probed tables (25 and 5 entries) read once, a few MB in all,
// about 1 us at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W; the
// launch dominates, which is why a chain takes one. Its fold writes
// 100,000 records of four words (the row, two composed words,
// s_nationkey): one 32-byte sector each.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

// The compose table at the end of the chain section (the composition's
// chain has no conjuncts, so it starts at C_OFF_CONJ): the number of
// owners, then (hop, build rows, first thread) a owner; then the number of
// composed hops, then (hop, owner, out, stride, mmx) a hop in chain order:
// `out` the address of the hop's first word at owner row 0, `stride` the
// int64 words of an owner row, `mmx` whether min and max follow the row.
constexpr int kOwnerWords = 3;
constexpr int kComposedWords = 5;

template <bool Full>
__global__ void __launch_bounds__(kThreads)
chain_compose_kernel(const i64* __restrict__ meta_g, int meta_len,
                     const i64* __restrict__ aux, i64 n_threads) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const i64* ct = ch + ch[C_OFF_CONJ];
  const int n_owners = (int)ct[0];
  const i64* comp = ct + 1 + kOwnerWords * n_owners;
  const int n_comp = (int)comp[0];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < n_threads;
       g += stride) {
    int o = 0;
    while (o + 1 < n_owners && ct[1 + kOwnerWords * (o + 1) + 2] <= g) ++o;
    const i64* own = ct + 1 + kOwnerWords * o;
    const int owner = (int)own[0];
    const i64 r = g - own[2];
    ChainColumns<Full> cols;
    cols.cols = meta + meta[H_OFF_COLS];
    cols.hop_of = ch + ch[C_OFF_HOPOF];
#pragma unroll
    for (int h = 0; h < kMaxHops; ++h) cols.brow[h] = -1;
    cols.brow[owner] = r;
    const i64* c = comp + 1;
    for (int k = 0; k < n_comp; ++k, c += kComposedWords) {
      if ((int)c[1] != owner) continue;
      const int h = (int)c[0];
      const i64* hop = ch + C_HOPS + h * kHopWords;
      i64 slot = 0;
      const i64 b = hop_lookup<false>(meta, aux, hop, r, cols, &slot);
      i64* out = (i64*)c[2] + r * c[3];
      out[0] = b;
      if (c[4]) {
        out[1] = b >= 0 ? __ldg((const long long*)hop[HOP_MN] + slot) : 0;
        out[2] = b >= 0 ? __ldg((const long long*)hop[HOP_MX] + slot) : 0;
      }
      cols.brow[h] = b;
    }
  }
}

// The fold table: the number of folded tables, then kFoldWords a table:
// (first thread, slots, rows (int32, -1 empty), composed words or 0, their
// width, records, validity bytes or 0, record words, columns, the column
// section's offset from the table's start); a column section holds 4
// words a column: (data, validity or 0, dtype code, its word in a record).
constexpr int kFoldWords = 10;

__global__ void __launch_bounds__(kThreads)
chain_fold_kernel(const i64* __restrict__ ft, i64 n_threads) {
  const int n_folds = (int)__ldg((const long long*)ft);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < n_threads;
       g += stride) {
    int f = 0;
    while (f + 1 < n_folds &&
           __ldg((const long long*)ft + 1 + kFoldWords * (f + 1)) <= g) {
      ++f;
    }
    const i64* d = ft + 1 + kFoldWords * f;
    const i64 s = g - __ldg((const long long*)d);
    const i64 r = __ldg((const int*)d[2] + s);
    const int comp_words = (int)d[4];
    const int rec_words = (int)d[7];
    const int n_cols = (int)d[8];
    const i64* cols = ft + d[9];
    i64* o = (i64*)d[5] + s * rec_words;
    unsigned char* valid = d[6] ? (unsigned char*)d[6] + s * rec_words
                                : nullptr;
    o[0] = r;
    for (int w = 1; w < rec_words; ++w) o[w] = 0;
    if (valid != nullptr) {
      for (int w = 0; w < rec_words; ++w) valid[w] = 0;
    }
    if (r < 0) continue;
    for (int w = 0; w < comp_words; ++w) {
      o[1 + w] = __ldg((const long long*)d[3] + r * comp_words + w);
    }
    for (int k = 0; k < n_cols; ++k) {
      const i64* cd = cols + 4 * k;
      i64 v;
      const bool ok = load_valid(cd, r, &v);
      o[cd[3]] = v;
      if (cd[1] != 0) valid[cd[3]] = ok;
    }
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py
// StageSpec) whose chain section ends with the compose table; aux: device
// int64 inputs; n_threads: the owners' build rows in all; full: the
// programs need the interpreter's full variant. One launch on `stream`;
// returns cudaGetLastError().
extern "C" int dft_chain_compose(const void* meta, int meta_len,
                                 const void* aux, long long n_threads,
                                 int full, void* stream) {
  const auto kernel = full ? chain_compose_kernel<true>
                           : chain_compose_kernel<false>;
  kernel<<<grid_blocks(n_threads, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_threads);
  return (int)cudaGetLastError();
}

// table: the device fold table (see chain_fold_kernel); n_threads: the
// folded tables' slots in all. One launch on `stream`; returns
// cudaGetLastError().
extern "C" int dft_chain_fold(const void* table, long long n_threads,
                              void* stream) {
  chain_fold_kernel<<<grid_blocks(n_threads, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>((const i64*)table, n_threads);
  return (int)cudaGetLastError();
}
