// chain_compose: resolve a join chain's snowflake hops when the chain is
// staged, and fold a hop's row and payload into one record a table slot.
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
// SEMI/ANTI hop the member's min and max of the key found; the walk reads
// them at the row it found for the owner and runs no probe-key program
// for the hop. A fold writes one record a slot of the hop's table (any
// layout), int64 words: the build row, the owner's composed words at that
// row, and the value of each payload column the walk's programs read as
// the interpreter loads it (a float32 widened), with a validity byte a
// word beside the records; the walk then resolves the hop and all that
// hangs on it from adjacent words of one record, loading a payload as an
// int64 column whose row is the record's first word (program.cuh
// `ChainColumns`), so its column loads are those of any chain.
//
// Design. One thread a row, grid-stride:
//   1. compose: one thread per owner build row. The owner's row handle is
//      the row itself; each hop composed into the owner before this one
//      gets its row from its words (`composed_row`), then the hop's probe
//      keys run over the pair space through `ChainColumns` (program.cuh)
//      and `hop_lookup` probes its table, NULL or out-of-range keys
//      finding nothing. A row the owner's build predicate dropped is
//      probed too: its words are defined, and the walk never reads them.
//   2. fold: one thread per table slot, writing its whole record.
//
// Bounds. TPC-H Q5 at SF10 composes nation and region into supplier's
// 100,000 rows: an 8-byte key column read and 8 bytes written a row and
// hop, the probed tables (25 and 5 entries) read once, a few MB in all,
// about 1 us at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at 700 W; the
// launch dominates. Its fold writes 100,000 records of four words (the
// row, two composed words, s_nationkey): one 32-byte sector each.

#include "program.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Full>
__global__ void __launch_bounds__(kThreads)
chain_compose_kernel(const i64* __restrict__ meta_g, int meta_len,
                     const i64* __restrict__ aux, i64 n_rows, int owner,
                     i64* __restrict__ out, i64 out_words, int mmx) {
  extern __shared__ i64 smem[];
  stage_meta(smem, meta_g, meta_len);
  const i64* meta = smem;
  const i64* ch = meta + meta[H_OFF_CHAIN];
  const int last = (int)ch[C_NHOPS] - 1;
  const i64* hop = ch + C_HOPS + last * kHopWords;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += stride) {
    ChainColumns<Full> cols;
    cols.cols = meta + meta[H_OFF_COLS];
    cols.hop_of = ch + ch[C_OFF_HOPOF];
#pragma unroll
    for (int h = 0; h < kMaxHops; ++h) cols.brow[h] = -1;
    cols.brow[owner] = r;
    for (int h = 0; h < last; ++h) {
      const i64* prior = ch + C_HOPS + h * kHopWords;
      if (prior[HOP_KIND] == TAB_COMPOSED && prior[HOP_OWNER] == owner) {
        i64 at;
        cols.brow[h] = composed_row(prior, cols.brow[prior[HOP_OWNER]], &at);
      }
    }
    i64 slot = 0;
    const i64 b = hop_lookup<true>(meta, aux, hop, r, cols, &slot);
    i64* o = out + r * out_words;
    o[0] = b;
    if (mmx) {
      o[1] = b >= 0 ? __ldg((const long long*)hop[HOP_MN] + slot) : 0;
      o[2] = b >= 0 ? __ldg((const long long*)hop[HOP_MX] + slot) : 0;
    }
  }
}

// cols: per payload column 4 words (data pointer, validity pointer or 0,
// dtype code, its word in a record); valid: the records' validity bytes
// (one a word, set for a column with a validity), null when no column has
// one
__global__ void __launch_bounds__(kThreads)
chain_fold_kernel(const int* __restrict__ rows, i64 size,
                  const i64* __restrict__ comp, int comp_words,
                  const i64* __restrict__ cols, int n_cols,
                  i64* __restrict__ rec, unsigned char* __restrict__ valid,
                  int rec_words) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < size;
       s += stride) {
    const i64 r = __ldg(rows + s);
    i64* o = rec + s * rec_words;
    o[0] = r;
    if (r < 0) continue;   // the wrapper zero-fills the rest
    for (int w = 0; w < comp_words; ++w) {
      o[1 + w] = __ldg((const long long*)comp + r * comp_words + w);
    }
    for (int c = 0; c < n_cols; ++c) {
      const i64* d = cols + 4 * c;
      i64 v;
      const bool ok = load_valid(d, r, &v);
      o[d[3]] = v;
      if (d[1] != 0) valid[s * rec_words + d[3]] = ok;
    }
  }
}

}  // namespace

// meta: device int64 descriptor of meta_len words (join_chain.py
// ComposeSpec), its chain section's last hop the composed one; aux: device
// int64 inputs; owner: the owner's hop index; out: the composed hop's
// first word in row 0 of the owner's words (int64, out_words a row);
// mmx: also write the min and max of a min/max table; full: the programs
// need the interpreter's full variant. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dft_chain_compose(const void* meta, int meta_len,
                                 const void* aux, long long n_rows,
                                 int owner, void* out, long long out_words,
                                 int mmx, int full, void* stream) {
  const auto kernel = full ? chain_compose_kernel<true>
                           : chain_compose_kernel<false>;
  kernel<<<grid_blocks(n_rows, kThreads), kThreads, (size_t)meta_len * 8,
           (cudaStream_t)stream>>>(
      (const i64*)meta, meta_len, (const i64*)aux, n_rows, owner,
      (i64*)out, out_words, mmx);
  return (int)cudaGetLastError();
}

// rows: the table's int32 rows (-1 empty), size slots; comp: the owner's
// composed words (int64 [build rows, comp_words]) or null; cols: device
// int64 [4 * n_cols] as chain_fold_kernel reads them; rec: int64 [size,
// rec_words] and valid: uint8 [size, rec_words] or null, zero-filled by
// the caller. Launches on `stream` and returns cudaGetLastError().
extern "C" int dft_chain_fold(const void* rows, long long size,
                              const void* comp, int comp_words,
                              const void* cols, int n_cols, void* rec,
                              void* valid, int rec_words, void* stream) {
  chain_fold_kernel<<<grid_blocks(size, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)rows, size, (const i64*)comp, comp_words,
      (const i64*)cols, n_cols, (i64*)rec, (unsigned char*)valid, rec_words);
  return (int)cudaGetLastError();
}
