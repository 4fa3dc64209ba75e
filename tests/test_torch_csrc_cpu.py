"""The port's CUDA sources compiled for the CPU, against the plain versions.

`g++` builds `csrc/program.cuh` and the kernel bodies of
`fused_dense_aggregate.cu`, `hash_group_aggregate.cu`, `chain_build.cu`,
`chain_aggregate.cu`, `chain_rows.cu`, `chain_compose.cu`, `join_build.cu`,
`join_aggregate.cu`, `exchange.cu` and `compact_groups.cu` (each file
above its `extern "C"` launch wrappers; `scan.cuh`, whose device-wide scan
launches kernels, is left out and the join build's scan runs as
`torch.cumsum`) through `SHIM`, a
header that defines the CUDA names for one thread: `__device__` is empty,
`__ldg` a load, an atomic a plain read-modify-write, a warp shuffle gives
back its own value, a ballot its own bit, `__match_any_sync` and
`__activemask` the thread alone (so a warp loop sized by the warp's
members takes one row a step; `test_torch_join_walk.py` and
`test_torch_hash_fold.py` replay the 32-lane steps), and a block's static
`__shared__` variables are the function's own locals. Each kernel then runs as one thread of one block over
the inputs its plain PyTorch version reads, and the two must agree
exactly (the transcendental math functions within rel 1e-15, glibc's
against PyTorch's): every program of the lowering tests, the dense fold, the aggregate's
hash fold (identity and probed tables, both interpreter variants, skewed
keys, block caches of 0, 1 and 64 entries, a table that overflows),
every build table (the insert pass; the range pass needs a warp) and
every chain walk of TPC-H at SF 0.01 and of the min/max membership cases
(with their staging-time compositions and folds, as the exec stages them;
a chain's compositions and folds from its one descriptor, and the
row-returning walk and its emit over TPC-H's row chains in tiles of 1 to
256 rows, writing nothing past its state words or its survivor scratch of
an entry a spine row, and min/max hops),
the count(DISTINCT x) lane's set inserts (dense, hash and chain folds,
lanes past 32 in passes), the fanout-N join's build (the multiset of
entry records a bucket) and probe-and-fold, the mesh's row partition (K1:
histogram, the scan as `torch.cumsum`, the stable scatter, round after
round) and partial-table merge (K2: several local tables a call, by owner
or a source a table, with its launch parameters from the wrapper), and
the mask of an unfiltered build table by a build predicate (`chain_mask`,
direct conjuncts and whole programs), the compaction mark's HAVING test
(`keep_entries` of `compact_groups.cu`,
its direct conjuncts and its interpreter mode) against `HavingSpec.mask`,
with the constant fold against `run`.
Each kernel runs in the interpreter variant (lean or full) that its spec's
`full` flag picks, and a walk in the staged variant when its chain has
composed or folded hops (`spec.variant`), as the launch wrappers do, so a
program that needs the full variant and is not flagged for it fails here. This holds the kernels' logic where there is no GPU; their parallel
behaviour is held on the card by `tests/test_torch_cuda.py`.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "datafusion_tpu_torch", "csrc")
CPU = torch.device("cpu")

SHIM = r"""
#pragma once
#include <cstdint>
#include <cmath>
#include <cstring>
#include <climits>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__
typedef void* cudaStream_t;
typedef int cudaError_t;
struct longlong2 { long long x, y; };
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16 };
struct Dim3S { unsigned x = 0, y = 0, z = 0; };
static Dim3S threadIdx, blockIdx, blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
inline double __longlong_as_double(long long b) {
  double d; memcpy(&d, &b, 8); return d; }
inline long long __double_as_longlong(double d) {
  long long b; memcpy(&b, &d, 8); return b; }
inline float __double2float_rn(double d) { return (float)d; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T atomicAdd(T* a, T v) { T o = *a; *a = o + v; return o; }
inline long long atomicMin(long long* a, long long v) {
  long long o = *a; if (v < o) *a = v; return o; }
inline long long atomicMax(long long* a, long long v) {
  long long o = *a; if (v > o) *a = v; return o; }
template <class T> T atomicCAS(T* a, T c, T v) {
  T o = *a; if (o == c) *a = v; return o; }
inline void __syncthreads() {}
inline void __threadfence() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline int __reduce_add_sync(unsigned, int v) { return v; }
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_up_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline int __any_sync(unsigned, int p) { return p; }
inline unsigned __activemask() { return 1u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline int cudaGetLastError() { return 0; }
"""

HARNESS = r"""
#include "program.cuh"
#include "lookback.cuh"
#include "tile_walk.cuh"
namespace fd { namespace { long long smem[1 << 16]; }
#include "fused_dense_aggregate_k.cu"
}
namespace cb { namespace { long long smem[1 << 16]; }
#include "chain_build_k.cu"
}
namespace ca { namespace { long long smem[1 << 16]; }
#include "chain_aggregate_k.cu"
}
namespace cr { namespace { long long smem[1 << 16]; }
#include "chain_rows_k.cu"
}
namespace cc { namespace { long long smem[1 << 16]; }
#include "chain_compose_k.cu"
}
namespace hg { namespace { long long smem[1 << 16]; }
#include "hash_group_aggregate_k.cu"
}
namespace jb { namespace { long long smem[1 << 16]; }
#include "join_build_k.cu"
}
namespace ja { namespace { long long smem[1 << 16]; }
#include "join_aggregate_k.cu"
}
namespace xc {
#include "exchange_k.cu"
}
namespace cg { namespace { long long smem[1 << 16]; }
#include "compact_groups_k.cu"
}
extern "C" {
void h_part_count(const long long* keys, const unsigned char* pending,
                  long long n, int n_dest, int salt, int mode, long long r,
                  unsigned long long* totals) {
  xc::partition_count_kernel(keys, pending, n, n_dest, salt, mode, r,
                             totals);
}
void h_part_sweep(const long long* keys, unsigned char* pending,
                  long long n, int n_dest, int salt, int mode, long long r,
                  const unsigned long long* totals, long long cap,
                  int n_lanes, void* const* src, void* const* dst,
                  const int* width, long long* key_out,
                  unsigned long long* status, unsigned long long* ticket,
                  unsigned long long epoch, int clear) {
  xc::XLanes x;
  x.n_lanes = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    x.src[l] = src[l];
    x.dst[l] = dst[l];
    x.width[l] = width[l];
  }
  xc::partition_sweep_kernel(keys, pending, n, n_dest, salt, mode, r, totals,
                             cap, x, key_out, clear, status, ticket, epoch);
}
void h_merge(const void* args, long long* tables, long long cap,
             unsigned long long* groups, long long limit,
             unsigned long long* overflow) {
  const xc::MergeArgs& a = *(const xc::MergeArgs*)args;
  for (int y = 0; y < (a.n_owner > 0 ? 1 : a.n_tables); ++y) {
    blockIdx.y = y;   // the launch's block row of source y
    xc::merge_partials_kernel(a, tables, cap, groups, limit, overflow);
  }
  blockIdx.y = 0;
}
void h_keep(const long long* meta, const long long* table, long long cap,
            long long n, int mode, int pairs, unsigned char* out) {
  // pairs: a lane's 16-byte rounds (keep_pairs) over windows of 64 kLoads
  // slots, lane l's round at window + 2 l; else each slot by `passes`
  if (pairs) {
    const long long span = 64 * cg::kLoads;
    for (long long w = 0; w < n; w += span) {
      for (int l = 0; l < 32; ++l) {
        const long long j0 = w + 2 * l;
        unsigned alive = 0;
        for (int e = 0; e < 2 * cg::kLoads; ++e) {
          const long long s = cg::pair_slot(j0, e);
          alive |= (unsigned)(s < n && table[s] != -1) << e;
        }
        const unsigned kept =
            mode == 1 ? cg::keep_pairs<1>(meta, table, cap, j0, alive)
          : mode == 2 ? cg::keep_pairs<2>(meta, table, cap, j0, alive)
                      : cg::keep_pairs<0>(meta, table, cap, j0, alive);
        for (int e = 0; e < 2 * cg::kLoads; ++e) {
          const long long s = cg::pair_slot(j0, e);
          if (s < n) out[s] = kept >> e & 1;
        }
      }
    }
    return;
  }
  for (long long s = 0; s < n; ++s) {
    out[s] = table[s] != -1 &&
             (mode == 0 || cg::passes(meta, table, cap, s));
  }
}
void h_run(const long long* meta, const long long* aux, int prog,
           long long n, long long* out, unsigned char* valid) {
  RowColumns<true> cols{meta + meta[H_OFF_COLS]};
  for (long long r = 0; r < n; ++r) valid[r] = run(meta, aux, prog, r, cols,
                                                   &out[r]);
}
void h_dense(const long long* meta, int len, const long long* aux,
             long long n, unsigned long long* table, int full) {
  (full ? fd::fused_dense_aggregate_kernel<true>
        : fd::fused_dense_aggregate_kernel<false>)(meta, len, aux, n, table);
}
void h_insert(const long long* meta, int len, const long long* aux,
              long long n, int kind, long long size, int* table,
              long long* keys, long long* mn, long long* mx, int* dup,
              int full) {
  (full ? cb::chain_build_insert_kernel<true>
        : cb::chain_build_insert_kernel<false>)(meta, len, aux, n, kind, size,
                                                table, keys, mn, mx, dup);
}
void h_mask(const long long* meta, int len, const long long* aux,
            long long size, const int* rows_in, int* out, int full) {
  (full ? cb::chain_mask_kernel<true> : cb::chain_mask_kernel<false>)(
      meta, len, aux, size, rows_in, out);
}
void h_chain_hash(const long long* meta, int len, const long long* aux,
                  long long n, long long cap, int ident, long long* table,
                  int* overflow, int variant, int list_cap) {
  DFT_WALK_VARIANT(ca::chain_hash_kernel, variant)(
      meta, len, aux, n, list_cap, cap, ident, table, overflow);
}
void h_chain_dense(const long long* meta, int len, const long long* aux,
                   long long n, unsigned long long* table, int variant,
                   int list_cap) {
  DFT_WALK_VARIANT(ca::chain_dense_kernel, variant)(meta, len, aux, n,
                                                    list_cap, table);
}
void h_admit_rows(const long long* meta, const long long* aux, long long n,
                    unsigned char* out) {
  const long long* ch = meta + meta[H_OFF_CHAIN];
  TileColumns<true, false> cols{meta, nullptr, 0, 0};
  for (long long r = 0; r < n; r += 2) {
    long long row[2] = {r, r + 1};
    bool alive[2] = {true, r + 1 < n};
    admit_rows(meta, aux, ch, row, alive, cols);
    out[r] = alive[0];
    if (r + 1 < n) out[r + 1] = alive[1];
  }
}
void h_rows_walk(const long long* meta, int len, const long long* aux,
                 long long n, int cap, unsigned long long* state, int* rows,
                 int* handles, int variant) {
  DFT_WALK_VARIANT(cr::rows_walk_kernel, variant)(
      meta, len, aux, n, cap, state, rows, handles);
}
void h_rows_emit(const long long* meta, int len, const long long* aux,
                 long long total, const int* rows, const int* handles,
                 long long stride, const long long* outs, int n_out,
                 int variant) {
  cr::Outputs o;
  memcpy(o.ptr, outs, sizeof(long long) * 2 * n_out);
  DFT_WALK_VARIANT(cr::rows_emit_kernel, variant)(meta, len, aux, total,
                                                  rows, handles, stride, o);
}
void h_compose(const long long* meta, int len, const long long* aux,
               long long n, int full) {
  (full ? cc::chain_compose_kernel<true> : cc::chain_compose_kernel<false>)(
      meta, len, aux, n);
}
void h_fold(const long long* table, long long n) {
  cc::chain_fold_kernel(table, n);
}
void h_hash(const long long* meta, int len, const long long* aux,
            long long n, long long cap, int ident, long long* table,
            int* overflow, int full, int entries) {
  (full ? hg::hash_group_aggregate_kernel<true>
        : hg::hash_group_aggregate_kernel<false>)(meta, len, aux, n, cap,
                                                  ident, table, overflow,
                                                  entries);
}
void h_jb_hash(const long long* meta, int len, const long long* aux,
               long long n, long long* hashes, long long* words,
               long long* live, int full) {
  (full ? jb::join_build_hash_kernel<true>
        : jb::join_build_hash_kernel<false>)(meta, len, aux, n, hashes,
                                             words, live);
}
void h_jb_count(const long long* hashes, long long n, long long nb,
                unsigned long long* counts) {
  jb::join_build_count_kernel(hashes, n, nb, counts);
}
void h_jb_scatter(const long long* hashes, const long long* words,
                  int n_keys, long long n, long long nb,
                  const long long* start, unsigned long long* cursor,
                  const long long* cols, int n_cols, int width, int* start32,
                  long long* rec, unsigned char* valid) {
  jb::join_build_scatter_kernel(hashes, words, n_keys, n, nb, start, cursor,
                                cols, n_cols, width, start32, rec, valid);
}
void h_join(const long long* meta, int len, const long long* aux,
            long long n, long long cap, int mode, long long* table,
            int* overflow, int full) {
  if (mode == 0) {
    (full ? ja::join_aggregate_kernel<true, true>
          : ja::join_aggregate_kernel<false, true>)(meta, len, aux, n, 0, 0,
                                                    table, overflow);
  } else {
    (full ? ja::join_aggregate_kernel<true, false>
          : ja::join_aggregate_kernel<false, false>)(
        meta, len, aux, n, cap, mode == 1 ? 1 : 0, table, overflow);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    d = tmp_path_factory.mktemp("csrc_cpu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    for header in ("program.cuh", "lookback.cuh", "tile_walk.cuh"):
        shutil.copy(os.path.join(CSRC, header), d / header)
    (d / "scan.cuh").write_text("#pragma once\n")
    for name in ("fused_dense_aggregate", "chain_build", "chain_aggregate",
                 "chain_rows", "chain_compose", "hash_group_aggregate",
                 "join_build", "join_aggregate", "exchange",
                 "compact_groups"):
        with open(os.path.join(CSRC, name + ".cu")) as f:
            src = f.read()
        (d / f"{name}_k.cu").write_text(src[:src.index('extern "C"')])
    so = d / "libcsrc_cpu.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
                    "-w", "-o", str(so), str(d / "harness.cpp")], check=True)
    out = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out.h_run.argtypes = [P, P, I, LL, P, P]
    out.h_dense.argtypes = [P, I, P, LL, P, I]
    out.h_insert.argtypes = [P, I, P, LL, I, LL, P, P, P, P, P, I]
    out.h_mask.argtypes = [P, I, P, LL, P, P, I]
    out.h_chain_hash.argtypes = [P, I, P, LL, LL, I, P, P, I, I]
    out.h_chain_dense.argtypes = [P, I, P, LL, P, I, I]
    out.h_admit_rows.argtypes = [P, P, LL, P]
    out.h_rows_walk.argtypes = [P, I, P, LL, I, P, P, P, I]
    out.h_rows_emit.argtypes = [P, I, P, LL, P, P, LL, P, I, I]
    out.h_compose.argtypes = [P, I, P, LL, I]
    out.h_fold.argtypes = [P, LL]
    out.h_hash.argtypes = [P, I, P, LL, LL, I, P, P, I, I]
    out.h_jb_hash.argtypes = [P, I, P, LL, P, P, P, I]
    out.h_jb_count.argtypes = [P, LL, LL, P]
    out.h_jb_scatter.argtypes = [P, P, I, LL, LL, P, P, P, I, I, P, P, P]
    out.h_join.argtypes = [P, I, P, LL, LL, I, P, P, I]
    out.h_part_count.argtypes = [P, P, LL, I, I, I, LL, P]
    out.h_part_sweep.argtypes = [P, P, LL, I, I, I, LL, P, LL, I, P, P, P, P,
                                 P, P, LL, I]
    out.h_merge.argtypes = [P, P, LL, P, LL, P]
    out.h_keep.argtypes = [P, P, LL, LL, I, I, P]
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


# --- the interpreter ----------------------------------------------------------

def _lowering_cases():
    import test_torch_lower as L
    return L.CASES + [("wide", q) for q in L.SCALAR_QUERIES]


@pytest.mark.parametrize("table,q", _lowering_cases())
def test_interpreter_matches_evaluate(lib, table, q):
    """`run` of `program.cuh` against `evaluate` on every program of a
    lowering case, as an expression and as a group key."""
    import test_torch_lower as L
    from torch_twin import twin
    from datafusion_tpu_torch.common.column import to_device
    from datafusion_tpu_torch.device.groupby import LANE_SUM_I64, _ProgramSpec
    from datafusion_tpu_torch.device.lower import (Pools, compile_expr,
                                                   compile_key, evaluate)
    ctx = {"lineitem": L._lineitem_ctx, "test_device": L._test_device_table,
           "wide": L._wide_ctx}[table]()
    exprs, batch = L._exprs(ctx, q)
    pb = twin(batch)
    n = pb.num_rows
    for e in exprs:
        for compile_ in (compile_expr, compile_key):
            pools = Pools()
            prog = compile_(twin(e), pools)
            cols = {i: to_device(pb.columns[i], CPU) for i in pools.columns}
            aux = torch.from_numpy(pools.aux_buffer(pb))
            spec = _ProgramSpec(pools, None, [], [(prog, LANE_SUM_I64)])
            meta = spec.device_meta(cols, CPU, spec._layout(0))
            got = torch.zeros(n, dtype=torch.int64)
            valid = torch.zeros(n, dtype=torch.uint8)
            lib.h_run(_ptr(meta), _ptr(aux), 0, n, _ptr(got), _ptr(valid))
            d, v = evaluate(prog, cols, aux, n)
            assert torch.equal(valid.bool(), v), str(e)
            if not prog.is_float:
                assert torch.equal(got[v], d[v]), str(e)
                continue
            gf, wf = got.view(torch.float64)[v], d.to(torch.float64)[v]
            if L._has_function(e, L._TRANSCENDENTAL):
                np.testing.assert_allclose(gf.numpy(), wf.numpy(), rtol=1e-15,
                                           atol=0, err_msg=str(e))
            else:
                np.testing.assert_array_equal(gf.numpy(), wf.numpy(),
                                              err_msg=str(e))


# --- the dense fold -------------------------------------------------------------

def _cuda_queries():
    import test_torch_cuda as C
    return C.QUERIES


@pytest.mark.parametrize("q", _cuda_queries())
def test_dense_fold_matches_plain(lib, q):
    import datafusion_tpu_torch as dft
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F64, dense_group_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    batch = C._table(20_000, 7)
    ctx = dft.SessionContext(CPU)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = ctx.sql(q).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    cols, aux = node.stage(spec, src)
    got, want = spec.new_table(CPU), spec.new_table(CPU)
    meta = spec.device_meta(cols, CPU)
    lib.h_dense(_ptr(meta), len(spec.meta), _ptr(aux), src.num_rows,
                _ptr(got), int(spec.full))
    dense_group_aggregate_plain(spec, cols, aux, src.num_rows, want)
    g, w = got.numpy(), want.numpy()
    np.testing.assert_array_equal(g[0], w[0])
    for (_prog, kind), a, b in zip(spec.lanes, spec.lane_arrays(g),
                                   spec.lane_arrays(w)):
        if kind == LANE_SUM_F64:
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


# --- the chain: build inserts and walks -----------------------------------------

def _entries(keys, rows, mn, mx, unique):
    """{packed key: (row if unique, min, max)} of a build table."""
    from datafusion_tpu_torch.device.groupby import EMPTY
    if keys is None:
        slots = (rows >= 0).nonzero().squeeze(1)
        packed = slots
    else:
        slots = (keys != EMPTY).nonzero().squeeze(1)
        packed = keys[slots]
    return {int(k): (int(rows[s]) if unique else 0,
                     0 if mn is None else int(mn[s]),
                     0 if mx is None else int(mx[s]))
            for k, s in zip(packed, slots)}


def _groups(table, dense):
    """{packed key: lane values} of a group table."""
    from datafusion_tpu_torch.device.groupby import EMPTY
    if dense:
        return {int(s): tuple(table[:, s].tolist())
                for s in (table[0] > 0).nonzero().squeeze(1)}
    return {int(table[0, s]): tuple(table[1:, s].tolist())
            for s in (table[0] != EMPTY).nonzero().squeeze(1)}


def _pairs_by_key(dset, table, dense):
    """The set's pairs as (group key, lane, value): the slot in a pair's
    group word is the key in a dense table, else the key at that slot."""
    pairs = dset.pairs()
    slot, lane = pairs[:, 0] >> 12, pairs[:, 0] & 4095
    key = slot if dense else table[0][slot]
    return set(zip(key.tolist(), lane.tolist(), pairs[:, 1].tolist()))


def _check_chain(lib, ctx, sql, list_cap=None, compose=True):
    """Every build side's insert pass and the walk of the query's first
    chain aggregate (its tile lists of `list_cap` entries, the launch
    wrapper's by default; staged as the exec stages it, or with `compose`
    false without composition or folding), against the plain versions."""
    from datafusion_tpu_torch.device.groupby import (
        EMPTY, LANE_SUM_F64, AggregateSpec)
    from datafusion_tpu_torch.device.join_chain import (
        LIST_CAP, TAB_EMPTY, TAB_HASH, chain_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    list_cap = LIST_CAP if list_cap is None else list_cap
    todo = [ctx.sql(sql).create_physical_plan()]
    while not isinstance(todo[-1], TorchJoinChainAggregateExec):
        node = todo.pop()
        todo += node.children()[::-1]
    spec, _plan, _n, _s, inputs, staged = todo[-1].prepare(
        ctx.task_context(), compose)
    for bi in staged:
        t = bi.table if bi.base is None else bi.base   # the unfiltered one
        if t.kind == TAB_EMPTY:
            continue
        bspec = bi.spec if bi.base is None else bi.spec.unfiltered()
        mmx = t.mn is not None
        rows = torch.full((t.size,), -1, dtype=torch.int32)
        keys = torch.full((t.size,), EMPTY, dtype=torch.int64) \
            if t.kind == TAB_HASH else None
        mn = torch.full_like(t.mn, np.iinfo(np.int64).max) if mmx else None
        mx = torch.full_like(t.mx, np.iinfo(np.int64).min) if mmx else None
        dup = torch.zeros(1, dtype=torch.int32)
        meta = bspec.device_meta(bi.cols, CPU,
                                 bspec.packed_meta(t.los, t.shifts))
        lib.h_insert(_ptr(meta), len(meta), _ptr(bi.aux), bi.batch.num_rows,
                     t.kind, t.size, _ptr(rows), _ptr(keys), _ptr(mn),
                     _ptr(mx), _ptr(dup), int(bspec.full))
        assert _entries(keys, rows, mn, mx, bi.unique) == \
            _entries(t.keys, t.rows, t.mn, t.mx, bi.unique)
        assert not bi.unique or int(dup) == int(t.duplicate)
    dense = isinstance(spec, AggregateSpec)
    got, want = spec.new_table(CPU), spec.new_table(CPU)
    rows = sum(n for _c, _a, n in inputs)
    dg, dw = spec.distinct_set(rows, CPU), spec.distinct_set(rows, CPU)
    ovf = torch.zeros(1, dtype=torch.int32)
    for cols, aux, n in inputs:
        for meta in spec.metas:
            m = spec.device_meta(cols, CPU, meta, dg)
            if dense:
                lib.h_chain_dense(_ptr(m), len(meta), _ptr(aux), n,
                                  _ptr(got), spec.variant, list_cap)
            else:
                lib.h_chain_hash(_ptr(m), len(meta), _ptr(aux), n,
                                 spec.cap, int(spec.identity_slots),
                                 _ptr(got), _ptr(ovf), spec.variant,
                                 list_cap)
        chain_aggregate_plain(spec, cols, aux, n, want,
                              torch.zeros(1, dtype=torch.int32), dset=dw)
    g, w = _groups(got, dense), _groups(want, dense)
    assert g.keys() == w.keys() and int(ovf) == 0
    if dg is not None:
        assert _pairs_by_key(dg, got, dense) == _pairs_by_key(dw, want, dense)
    floats = [i + 1 for i, (_p, k) in enumerate(spec.lanes)
              if k == LANE_SUM_F64]
    for key, row in g.items():
        for i, (a, b) in enumerate(zip(row, w[key])):
            if i in floats:      # the float sums add in another order
                a, b = (np.int64(x).view(np.float64) for x in (a, b))
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True)
            else:
                assert a == b, (key, i)
    return staged


@pytest.fixture(scope="module")
def tpch():
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.tpch.datagen import register_tpch
    ctx = dft.SessionContext(CPU)
    register_tpch(ctx, sf=0.01, seed=1)
    return ctx


@pytest.mark.parametrize("q", [2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 14, 16, 17,
                               18, 19, 21])
def test_tpch_chain_kernels_match_plain(lib, tpch, q):
    from datafusion_tpu_torch.tpch.queries import QUERIES
    _check_chain(lib, tpch, QUERIES[q])


@pytest.mark.parametrize("wide", [False, True], ids=["direct", "hashed"])
@pytest.mark.parametrize("anti", [False, True], ids=["semi", "anti"])
@pytest.mark.parametrize("op", ["<>", "<", "<=", ">", ">="])
def test_min_max_membership_kernels_match_plain(lib, op, anti, wide):
    import test_torch_join_chain as J
    port, _ref = J._mmx_pair(J._mmx_data(wide))
    sql = ("SELECT d.name, count(*) c, sum(f.v) s FROM f "
           "JOIN d ON f.g = d.id WHERE " + ("NOT " if anti else "") +
           f"EXISTS (SELECT 1 FROM m WHERE m.k = f.k AND m.s {op} f.s "
           "AND m.w > 0) GROUP BY d.name")
    staged = _check_chain(lib, port, sql)
    assert any(s.table.mn is not None for s in staged)


# the tile walk's lists of 2 (a step of the one-thread build: every step
# walks), 5 and 64 entries, staged as the exec stages it and not
@pytest.mark.parametrize("list_cap", [2, 5, 64])
@pytest.mark.parametrize("compose", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("q", [3, 5, 7, 9, 12, 14, 18, 21])
def test_tpch_tile_walk_tiles_match_plain(lib, tpch, q, compose, list_cap):
    _check_chain(lib, tpch, QUERIES_TPCH()[q], list_cap, compose)


def QUERIES_TPCH():
    from datafusion_tpu_torch.tpch.queries import QUERIES
    return QUERIES


@pytest.mark.parametrize("list_cap", [2, 1024])
@pytest.mark.parametrize("op", ["<>", ">="])
def test_min_max_membership_tiles_match_plain(lib, op, list_cap):
    """A SEMI and an ANTI min/max hop over a hashed table, unstaged, at
    lists of 2 and 1024 entries."""
    import test_torch_join_chain as J
    port, _ref = J._mmx_pair(J._mmx_data(True))
    for anti in (False, True):
        sql = ("SELECT d.name, count(*) c, sum(f.v) s FROM f "
               "JOIN d ON f.g = d.id WHERE " + ("NOT " if anti else "") +
               f"EXISTS (SELECT 1 FROM m WHERE m.k = f.k AND m.s {op} f.s "
               "AND m.w > 0) GROUP BY d.name")
        _check_chain(lib, port, sql, list_cap, compose=False)


def test_eight_hop_tile_walk_matches_plain(lib):
    """A chain of eight INNER hops, two over filtered dimensions, with a
    probe predicate, at lists of 2, 3 and 1024 entries."""
    from test_torch_tile_walk import EIGHT_HOP_SQL, eight_hop_ctx
    ctx = eight_hop_ctx(CPU, 6_000)
    for list_cap in (2, 3, 1024):
        _check_chain(lib, ctx, EIGHT_HOP_SQL, list_cap)


def test_chain_lanes_past_32_match_plain(lib, tpch):
    """A walk of more than 32 lanes (passes of at most 32, one launch
    each, each re-walking the chain) and a distinct lane, over lineitem
    JOIN orders, at lists of 5 entries."""
    sums = ", ".join(f"sum(l_quantity + {i}) s{i}" for i in range(38))
    sql = ("SELECT o_orderpriority, count(*) c, count(DISTINCT o_custkey) "
           f"u, {sums} FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
           "WHERE l_shipdate > DATE '1995-03-15' GROUP BY o_orderpriority")
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    _check_chain(lib, tpch, sql, 5)
    ex = next(iter(_chain_execs(tpch, sql)))
    assert isinstance(ex, TorchJoinChainAggregateExec)
    spec = ex.prepare(tpch.task_context())[0]
    assert len(spec.metas) >= 2 and spec.distinct_lanes


@pytest.mark.parametrize("pred", [p for p, _f in __import__(
    "test_torch_tile_walk").PREDICATES])
def test_admit_rows_matches_run(lib, pred):
    """The tile walk's probe predicate through its conjuncts
    (`admit_rows`, two rows at once: one-column tests straight from their
    columns, the rest through `run`) passes exactly the rows `run` of the
    whole predicate passes: NULLs, NaN, -0.0, decimals and dictionary
    codes."""
    from test_torch_tile_walk import _conj_ctx, conj_chain
    from datafusion_tpu_torch.device.groupby import H_OFF_PROGS
    spec, cols, aux, n = conj_chain(_conj_ctx(), pred)
    meta = spec.device_meta(cols, CPU)
    got = torch.zeros(n, dtype=torch.uint8)
    lib.h_admit_rows(_ptr(meta), _ptr(aux), n, _ptr(got))
    index = spec.chain.programs().index(spec.chain.ppred)
    progs = spec._pass_programs(spec.lanes)
    prog = next(i for i, p in enumerate(progs) if p is spec.chain.ppred)
    assert index >= 0 and int(meta[H_OFF_PROGS]) > 0
    x = torch.zeros(n, dtype=torch.int64)
    valid = torch.zeros(n, dtype=torch.uint8)
    lib.h_run(_ptr(meta), _ptr(aux), prog, n, _ptr(x), _ptr(valid))
    want = (valid.bool() & (x != 0)).to(torch.uint8)
    assert torch.equal(got, want) and 0 < int(want.sum())


# --- staging-time composition and folding --------------------------------------

def _check_compose_and_fold(lib, ex, tctx):
    """The chain exec `ex`'s staging (`stage_spec` over its builds, every
    payload column of a folded hop held) through the compose kernel once
    and the fold kernel once, from one descriptor, into outputs filled
    with garbage, against `chain_stage_plain`; the composed words also
    against those the exec staged. Returns (compositions, folds)
    checked."""
    from datafusion_tpu_torch.device.join_chain import (chain_stage_plain,
                                                        new_stage_outputs)
    staged = ex.stage_builds(tctx)
    made = ex.stage_spec(staged)
    if made is None:
        return 0, 0
    spec, cols, aux = made
    words, folds = new_stage_outputs(spec, CPU)
    for t in list(words.values()) + [t for f in folds for t in f
                                     if t is not None]:
        t.fill_(-7 if t.dtype == torch.int64 else 0x5A)
    desc = torch.from_numpy(spec.host_words(cols, words, folds))
    if spec.compose_threads:
        lib.h_compose(_ptr(desc), len(spec.meta), _ptr(aux),
                      spec.compose_threads, int(spec.full))
    if spec.fold_threads:
        lib.h_fold(desc.data_ptr() + 8 * len(spec.meta), spec.fold_threads)
    want_w, want_f = new_stage_outputs(spec, CPU)
    chain_stage_plain(spec, cols, aux, want_w, want_f)
    for o, w in words.items():
        assert torch.equal(w, want_w[o]), o
    for (h, _t, _f), got, want in zip(spec.folds, folds, want_f):
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), h
    for bi, s in enumerate(staged):
        if s.compose is not None:
            assert torch.equal(words[s.compose.owner], s.compose.words), bi
    return len(spec.composed), len(spec.folds)


def _chain_execs(ctx, sql):
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchChainExec)
    todo, out = [ctx.sql(sql).create_physical_plan()], []
    while todo:
        node = todo.pop()
        if isinstance(node, TorchChainExec):
            out.append(node)
        todo += node.children()
    return out


@pytest.mark.parametrize("q", [2, 3, 5, 7, 8, 9, 10, 11, 12, 14, 16, 17, 18,
                               19, 21])
def test_tpch_compose_and_fold_kernels_match_plain(lib, tpch, q):
    from datafusion_tpu_torch.tpch.queries import QUERIES
    done = [_check_compose_and_fold(lib, ex, tpch.task_context())
            for ex in _chain_execs(tpch, QUERIES[q])]
    assert sum(f for _c, f in done) >= 1


def test_edge_case_compose_and_fold_kernels_match_plain(lib):
    """The composition edge cases of `test_torch_chain_compose.py` (NULL
    and out-of-range owner keys, dropped owner rows, ANTI and min/max
    composed hops, an int32 owner column, the fold budget's edge)."""
    import test_torch_chain_compose as T
    checked = [0, 0]
    for name, (data, sql) in T.edge_cases().items():
        port, _ref = T.pair(data)
        for ex in _chain_execs(port, sql):
            c, f = _check_compose_and_fold(lib, ex, port.task_context())
            checked[0] += c
            checked[1] += f
    assert checked[0] >= 6 and checked[1] >= 1


GUARD = 7   # words past each of the walk's arrays that it must not touch


def _rows_kernels(lib, spec, cols, aux, n, cap):
    """`chain_rows` through the one-thread build, as its wrapper runs it:
    the walk in tiles of `cap` spine rows (a one-warp block's tile) into a
    survivor scratch of an entry a spine row, then the emit. Every tile's
    ticket is taken once, its status word ends inclusive, and nothing is
    written past the state words or the scratch. Returns (the outputs,
    the survivor count)."""
    meta = spec.device_meta(cols, CPU)
    n_hops = len(spec.chain.hops)
    tiles = -(-n // cap)
    state = torch.zeros(2 + tiles + GUARD, dtype=torch.int64)
    rows = torch.full((n + GUARD,), -9, dtype=torch.int32)
    handles = torch.full((n_hops * n + GUARD,), -9, dtype=torch.int32)
    lib.h_rows_walk(_ptr(meta), len(spec.meta), _ptr(aux), n, cap,
                    _ptr(state), _ptr(rows), _ptr(handles), spec.variant)
    assert int(state[0]) == tiles + 1
    assert all((int(w) & (1 << 64) - 1) >> 62 == 2
               for w in state[2:2 + tiles])
    assert not state[2 + tiles:].any()
    assert (rows[n:] == -9).all() and (handles[n_hops * n:] == -9).all()
    total = int(state[1])
    assert 0 <= total <= n
    outs = [(torch.zeros(total, dtype=d), torch.zeros(total, dtype=torch.bool))
            for d in spec.output_dtypes()]
    ptrs = torch.tensor([p for d, v in outs for p in (d.data_ptr(),
                                                      v.data_ptr())],
                        dtype=torch.int64)
    if total:
        lib.h_rows_emit(_ptr(meta), len(spec.meta), _ptr(aux), total,
                        _ptr(rows), _ptr(handles), n, _ptr(ptrs),
                        len(outs), spec.variant)
    return outs, total


def _rows_ctx():
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.tpch.datagen import register_tpch
    ctx = dft.SessionContext(CPU)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    register_tpch(ctx, sf=0.01, seed=1)
    return ctx


@pytest.fixture(scope="module")
def tpch_rows():
    return _rows_ctx()


@pytest.mark.parametrize("q", [2, 3, 5, 8, 9, 10, 11, 16, 17, 20, 21])
def test_chain_mask_matches_plain(lib, tpch_rows, q):
    """The mask kernel's body over every eligible filtered build side of
    the query's chains at SF 0.01 (direct conjuncts of every form, and a
    program conjunct in Q16), with the predicate split into conjuncts and
    run whole through the interpreter, exactly equal to
    `chain_mask_plain`."""
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.join_chain import chain_mask_plain
    from datafusion_tpu_torch.tpch.queries import QUERIES
    sides = [bi for ex in _chain_execs(tpch_rows, QUERIES[q])
             for bi in ex.stage_builds(tpch_rows.task_context(),
                                       compose=False)
             if bi.base is not None and bi.table is not bi.base]
    assert sides
    for bi in sides:
        base = bi.base
        for spec in C._mask_specs(bi):
            got = torch.full_like(base.rows, 7)
            meta = spec.device_meta(bi.cols, CPU)
            lib.h_mask(_ptr(meta), len(meta), _ptr(bi.aux), base.size,
                       _ptr(base.rows), _ptr(got), int(spec.full))
            want = chain_mask_plain(spec, bi.cols, bi.aux,
                                    bi.batch.num_rows, base)
            assert torch.equal(got, want.rows)
            assert torch.equal(got, bi.table.rows)


def _check_rows(lib, ctx, sql, cap, compose=True):
    """The row-returning walk of every rows chain of `sql` through the
    kernels (`_rows_kernels`) against `chain_rows_plain`: the same rows in
    spine order, every output and its validity. Returns (chains, the rows
    each call kept, the spine rows of each call)."""
    from datafusion_tpu_torch.device.join_chain import chain_rows_plain
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainRowsExec)
    execs = [e for e in _chain_execs(ctx, sql)
             if isinstance(e, TorchJoinChainRowsExec)]
    kept, spine = [], []
    for ex in execs:
        spec, inputs, _staged = ex.prepare_rows(ctx.task_context(), compose)
        for cols, aux, n, _view in inputs:
            got, total = _rows_kernels(lib, spec, cols, aux, n, cap)
            want = chain_rows_plain(spec, cols, aux, n)
            for (gd, gv), (wd, wv) in zip(got, want):
                assert torch.equal(gv, wv) and torch.equal(gd, wd)
            assert total == want[0][0].numel()
            kept.append(total)
            spine.append(n)
    return len(execs), kept, spine


def test_q2_rows_walk_with_composed_and_folded_hops_matches_plain(lib):
    """`chain_rows`' tile walk and emit over TPC-H Q2's row-returning
    chain, whose nation and region hops compose into supplier and whose
    supplier hop folds: the outputs equal `chain_rows_plain`'s in spine
    order."""
    from datafusion_tpu_torch.device.join_chain import ROWS_TILE
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainRowsExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = _rows_ctx()
    (ex,) = [e for e in _chain_execs(ctx, QUERIES[2])
             if isinstance(e, TorchJoinChainRowsExec)]
    spec, _inputs, _staged = ex.prepare_rows(ctx.task_context())
    assert any(h.compose is not None for h in spec.chain.hops)
    assert any(h.fold is not None for h in spec.chain.hops)
    assert spec.variant & 2
    chains, kept, _spine = _check_rows(lib, ctx, QUERIES[2], ROWS_TILE)
    assert chains == 1 and kept[0] > 0


# TPC-H's row-returning chains at SF 0.01 with the threshold at 1 (Q13's
# LEFT count plans no rows chain)
ROWS_TPCH = (2, 20)


@pytest.mark.parametrize("cap", [2, 5, 64, 256])
@pytest.mark.parametrize("compose", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("q", ROWS_TPCH)
def test_tpch_rows_walk_tiles_match_plain(lib, tpch_rows, q, compose, cap):
    """The row walk in tiles of 2, 5, 64 and 256 spine rows (many tiles,
    each placed by the look-back), staged and unstaged: the rows equal the
    plain version's in spine order."""
    from datafusion_tpu_torch.tpch.queries import QUERIES
    chains, kept, _spine = _check_rows(lib, tpch_rows, QUERIES[q], cap,
                                       compose)
    assert chains >= 1 and sum(kept) > 0


@pytest.mark.parametrize("compose", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("q", ROWS_TPCH)
def test_rows_walk_writes_within_its_state_and_scratch(lib, tpch_rows, q,
                                                       compose):
    """In tiles of one row, as many status words as spine rows: the walk
    writes a status word a tile and the survivors' rows and handles into
    a scratch of an entry a spine row, and nothing past either
    (`_rows_kernels`' guard words)."""
    from datafusion_tpu_torch.tpch.queries import QUERIES
    chains, kept, spine = _check_rows(lib, tpch_rows, QUERIES[q], 1,
                                      compose)
    assert chains >= 1 and all(0 < k < n for k, n in zip(kept, spine))


@pytest.mark.parametrize("op", ["<>", "<", ">="])
@pytest.mark.parametrize("anti", [False, True], ids=["semi", "anti"])
def test_min_max_rows_walk_matches_plain(lib, op, anti):
    """A row-returning chain with a SEMI or ANTI min/max hop over a hashed
    table (the interpreter's full variant), at tiles of 3 and 64 rows."""
    import test_torch_join_chain as J
    port, _ref = J._mmx_pair(J._mmx_data(True))
    port.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    sql = ("SELECT f.v, d.name FROM f JOIN d ON f.g = d.id WHERE " +
           ("NOT " if anti else "") +
           f"EXISTS (SELECT 1 FROM m WHERE m.k = f.k AND m.s {op} f.s "
           "AND m.w > 0)")
    for cap in (3, 64):
        chains, kept, _w = _check_rows(lib, port, sql, cap, compose=False)
        assert chains == 1 and kept[0] > 0


# --- count(DISTINCT x) and lanes past 32 in the grouped folds ------------------

def _fold_cases():
    import test_torch_distinct as D
    import test_torch_lanes as L
    names = ["dense", "hash", "ungrouped", "predicate", "strings_hash",
             "mixed_dense"]
    return [D.QUERIES[n] for n in names] + [L._lanes_query(65, "g8"),
                                            L._lanes_query(65, "g")]


@pytest.mark.parametrize("q", _fold_cases())
def test_distinct_and_pass_folds_match_plain(lib, q):
    """The dense and hash kernels' folds, one launch a pass, with a
    distinct set: the group tables and the set's (group, lane, value)
    pairs equal the plain versions'."""
    import datafusion_tpu_torch as dft
    import test_torch_distinct as D
    from torch_twin import twin
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, dense_group_aggregate_plain, dense_group_table,
        hash_group_aggregate_plain)
    ctx = dft.SessionContext(CPU)
    b = twin(D.table(20_000, 1))
    ctx.register_table("t", dft.MemTable(b.schema, [[b]]))
    (node,) = D.execs(ctx, q)[1]
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    cols, aux = node.stage(spec, src)
    n = src.num_rows
    got, want = spec.new_table(CPU), spec.new_table(CPU)
    dg, dw = spec.distinct_set(n, CPU), spec.distinct_set(n, CPU)
    dense = isinstance(spec, AggregateSpec)
    ovf = torch.zeros(1, dtype=torch.int32)
    for meta, (_at, lanes) in zip(spec.metas, spec.passes):
        m = spec.device_meta(cols, CPU, meta, dg)
        if dense:
            lib.h_dense(_ptr(m), len(meta), _ptr(aux), n, _ptr(got),
                        int(spec.full))
        else:
            lib.h_hash(_ptr(m), len(meta), _ptr(aux), n, spec.cap,
                       int(spec.identity_slots), _ptr(got), _ptr(ovf),
                       int(spec.full), _cache_entries(lanes, 64))
    if dense:
        dense_group_aggregate_plain(spec, cols, aux, n, want, dset=dw)
        got, want = dense_group_table(got), dense_group_table(want)
    else:
        hash_group_aggregate_plain(spec, cols, aux, n, want,
                                   torch.zeros(1, dtype=torch.int32),
                                   dset=dw)
    _same_groups(spec, got, want)
    assert int(ovf) == 0
    if dg is not None:
        assert _pairs_by_key(dg, got, False) == _pairs_by_key(dw, want, False)
        assert int(dg.words[-1]) == 0


def _cache_entries(lanes, entries):
    """The block cache a pass of `lanes` gets, as the launch wrapper gives
    it: none with a distinct lane."""
    from datafusion_tpu_torch.device.groupby import _DISTINCT_LANES
    return 0 if any(k in _DISTINCT_LANES for _p, k in lanes) else entries


def _same_groups(spec, got, want):
    """Two `[lanes + 2, slots]` tables hold the same groups and lanes (the
    float64 sums within rel 1e-12: they add in another order)."""
    from datafusion_tpu_torch.device.groupby import LANE_SUM_F64
    g, w = _groups(got, False), _groups(want, False)
    assert g.keys() == w.keys() and g
    floats = [i + 1 for i, (_p, k) in enumerate(spec.lanes)
              if k == LANE_SUM_F64]
    for key, row in g.items():
        for i, (a, b) in enumerate(zip(row, w[key])):
            if i in floats:
                a, b = (np.int64(x).view(np.float64) for x in (a, b))
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True)
            else:
                assert a == b, (key, i)


# --- the aggregate's hash fold: warp peers and the block cache ----------------

def _skew_table(n, seed, mult):
    """`test_torch_cuda._table`'s columns under an int64 key x, zipf(1.3)
    over 5,000 keys times `mult` (2^27 makes a 2^40 key space: the probing
    table); a quarter of the rows or so share the hottest key."""
    import test_torch_cuda as C
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.common.schema import Field, Schema
    rng = np.random.default_rng(seed)
    x = (rng.zipf(1.3, n) % 5000).astype(np.int64) * mult
    base = C._table(n, seed)
    schema = Schema([Field("x", dt.INT64, False)] + list(base.schema.fields))
    return Batch(schema, [Column(dt.INT64, x)] + list(base.columns), n)


_WIDE = ("SELECT x, count(*), count(v), sum(v), min(v), max(v), sum(f), "
         "min(i), max(i), sum(d) FROM t GROUP BY x")
_FULL = ("SELECT x, sum(CASE WHEN k > 0 THEN v WHEN i < 0 THEN f END), "
         "sum(i % 7), sum(k / (i % 5)), count(CASE WHEN b THEN 1 END), "
         "max(v) FROM t WHERE g <> 'b' GROUP BY x")
# (query, table, identity slots, full interpreter): the queries of
# test_torch_cuda.HASH_QUERIES, then skewed keys in both modes and both
# interpreter variants
HASH_FOLDS = [
    (_WIDE, ("wide", 40), False, False),
    ("SELECT gi, g, k, count(*), sum(d), avg(v), max(f) FROM t WHERE b "
     "GROUP BY gi, g, k", ("wide", 20), True, False),
    (_WIDE, ("zipf", 1), True, False),
    (_WIDE, ("zipf", 1 << 27), False, False),
    (_FULL, ("zipf", 1), True, True),
    (_FULL, ("zipf", 1 << 27), False, True),
]


@pytest.mark.parametrize("entries", [0, 1, 64])
@pytest.mark.parametrize("q,data,identity,full", HASH_FOLDS)
def test_hash_fold_matches_plain(lib, q, data, identity, full, entries):
    """The aggregate's hash fold (`hash_fold_warps`) against the plain
    version, with no block cache, a cache of one entry (every other key
    misses it) and of 64 (the warp stops probing once its rows mostly
    miss): equal groups, counts, integer lanes and min/max; float64 sums
    within rel 1e-12 and float32 sums within rel 1e-5 (a cached key's
    partial sum joins the table's in another order)."""
    import datafusion_tpu_torch as dft
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F32, LANE_SUM_F64, HashSpec, hash_group_aggregate_plain)
    kind, arg = data
    batch = C._wide_table(20_000, 11, arg) if kind == "wide" \
        else _skew_table(20_000, 5, arg)
    ctx = dft.SessionContext(CPU)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = C._exec(ctx, q)
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    assert isinstance(spec, HashSpec)
    assert spec.identity_slots == identity and spec.full == full
    cols, aux = node.stage(spec, src)
    n = src.num_rows
    got, want = spec.new_table(CPU), spec.new_table(CPU)
    ovf = torch.zeros(1, dtype=torch.int32)
    for meta, (_at, lanes) in zip(spec.metas, spec.passes):
        m = spec.device_meta(cols, CPU, meta)
        lib.h_hash(_ptr(m), len(meta), _ptr(aux), n, spec.cap,
                   int(spec.identity_slots), _ptr(got), _ptr(ovf),
                   int(spec.full), _cache_entries(lanes, entries))
    hash_group_aggregate_plain(spec, cols, aux, n, want,
                               torch.zeros(1, dtype=torch.int32))
    assert int(ovf) == 0
    g, w = _groups(got, False), _groups(want, False)
    assert g.keys() == w.keys() and g
    kinds = [k for _p, k in spec.lanes]
    for key, row in g.items():
        assert row[0] == w[key][0], key
        for kind, a, b in zip(kinds, row[1:], w[key][1:]):
            if kind == LANE_SUM_F64:
                a, b = (np.int64(x).view(np.float64) for x in (a, b))
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True)
            elif kind == LANE_SUM_F32:
                a, b = (np.array([x], np.int64).view(np.float32)[0]
                        for x in (a, b))
                assert a == pytest.approx(b, rel=1e-5, abs=1e-3)
            else:
                assert a == b, (key, kind)


def test_hash_fold_cache_overflow_is_flagged(lib):
    """A table too small for its keys sets the overflow flag, with the keys
    held in a block cache (merged at the block's end) and without one."""
    import datafusion_tpu_torch as dft
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.groupby import HashSpec
    batch = _skew_table(5_000, 6, 1 << 27)
    ctx = dft.SessionContext(CPU)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = C._exec(ctx, "SELECT x, count(*) FROM t GROUP BY x")
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    small = HashSpec(spec.pools, spec.pred,
                     [(p, o, 40) for p, o, _s in spec.keys], spec.lanes, 100)
    cols, aux = node.stage(small, src)
    for entries in (0, 1 << 12):
        table = small.new_table(CPU)
        ovf = torch.zeros(1, dtype=torch.int32)
        m = small.device_meta(cols, CPU, small.meta)
        lib.h_hash(_ptr(m), len(small.meta), _ptr(aux), src.num_rows,
                   small.cap, int(small.identity_slots), _ptr(table),
                   _ptr(ovf), int(small.full), entries)
        assert int(ovf) == 1
        assert int((table[0] != -1).sum()) == small.cap


def test_tpch_q5_distinct_chain_kernels_match_plain(lib, tpch):
    import test_torch_distinct as D
    _check_chain(lib, tpch, D.Q5D)


# --- the fanout-N join: build and probe-and-fold ------------------------------

def _join_ctx(tpch_ctx, q):
    if "partsupp" in q:
        return tpch_ctx
    import datafusion_tpu_torch as dft
    import test_torch_join_agg as T
    from torch_twin import twin
    ctx = dft.SessionContext(CPU)
    for name, part in (("b", T._build()), ("p", T._probe(6_000, 2))):
        tw = twin(part)
        ctx.register_table(name, dft.MemTable(tw.schema, [[tw]]))
    return ctx


def _join_cases():
    import test_torch_join_agg as T
    return [T.J1, T.J2] + [T.QUERIES[n] for n in (
        "hash_keys", "dense_keys", "two_sides", "join_filter",
        "string_keys", "composite_keys", "nan_min_max_dense")]


@pytest.mark.parametrize("q", _join_cases())
def test_join_kernels_match_plain(lib, tpch, q):
    """`join_build`'s hash and scatter passes (the count pass, then the
    scan as `torch.cumsum`) give the plain build's int32 bucket starts and
    the same multiset of (row, record, validity bytes) a bucket, the record
    the key words and the payload columns; `join_aggregate` over that table
    folds the plain version's groups, a launch a pass."""
    import test_torch_distinct as D
    from datafusion_tpu_torch.device.groupby import (AggregateSpec,
                                                     _next_pow2,
                                                     dense_group_table)
    from datafusion_tpu_torch.device.join_agg import (
        join_aggregate_plain, join_build_plain, new_join_table,
        payload_columns)
    from datafusion_tpu_torch.physical.plan.base import (collect_batch,
                                                         execute_stream)
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        _PairView)
    ctx = _join_ctx(tpch, q)
    (ex,) = D.execs(ctx, q, TorchJoinAggregateExec)[1]
    tctx = ctx.task_context()
    lowered = ex.lower()
    build_batch = collect_batch(ex.build_source, tctx)
    bspec, bcols, baux = ex.build_input(lowered, build_batch)
    n, nk = build_batch.num_rows, len(bspec.keys)
    want_t = join_build_plain(bspec, bcols, baux, n)
    hashes = torch.empty(max(n, 1), dtype=torch.int64)
    words = torch.empty(max(nk * n, 1), dtype=torch.int64)
    live = torch.zeros(1, dtype=torch.int64)
    meta = bspec.device_meta(bcols, CPU)
    lib.h_jb_hash(_ptr(meta), len(bspec.meta), _ptr(baux), n, _ptr(hashes),
                  _ptr(words), _ptr(live), int(bspec.full))
    live = int(live)
    nb = _next_pow2(max(live, 1))
    counts = torch.zeros(nb + 1, dtype=torch.int64)
    lib.h_jb_count(_ptr(hashes), n, nb, _ptr(counts))
    start = torch.zeros(nb + 1, dtype=torch.int64)
    start[1:] = torch.cumsum(counts[:nb], 0)
    got_t = new_join_table(bspec, bcols, nb, live, CPU)
    pay = payload_columns(got_t, bcols)
    cursor = torch.zeros(nb, dtype=torch.int64)
    lib.h_jb_scatter(_ptr(hashes), _ptr(words), nk, n, nb, _ptr(start),
                     _ptr(cursor), _ptr(pay), len(got_t.payload),
                     got_t.width, _ptr(got_t.start), _ptr(got_t.records),
                     _ptr(got_t.valid))
    assert (nb, live) == (want_t.nb, want_t.live) and live
    assert torch.equal(got_t.start, want_t.start)
    assert got_t.payload == want_t.payload
    for a, b in zip(got_t.entries(), want_t.entries()):
        np.testing.assert_array_equal(a, b)

    probe = [b for b in execute_stream(ex.probe_source, tctx) if b.num_rows]
    views = [_PairView(list(build_batch.columns) + list(pb.columns),
                       pb.num_rows) for pb in probe]
    spec, _plan, _names, _sm = ex.compile_join(lowered, got_t, views)
    dense = isinstance(spec, AggregateSpec)
    got, want = spec.new_table(CPU), spec.new_table(CPU)
    ovf = torch.zeros(1, dtype=torch.int32)
    mode = 0 if dense else (1 if spec.identity_slots else 2)
    for pb, view in zip(probe, views):
        cols, aux = ex.stage_pair(spec, build_batch, pb, view)
        for meta in spec.metas:
            m = spec.device_meta(cols, CPU, meta)
            lib.h_join(_ptr(m), len(meta), _ptr(aux), pb.num_rows,
                       0 if dense else spec.cap, mode, _ptr(got), _ptr(ovf),
                       int(spec.full))
        join_aggregate_plain(spec, cols, aux, pb.num_rows, want,
                             torch.zeros(1, dtype=torch.int32))
    if dense:
        got, want = dense_group_table(got), dense_group_table(want)
    _same_groups(spec, got, want)
    assert int(ovf) == 0


@pytest.mark.parametrize("n,n_dest,cap,salt,mode", [
    (1, 4, 1, 1, 1), (5000, 8, 300, 1, 1), (5000, 3, 5000, 4, 1),
    (3000, 5, 2000, 3, 2), (9000, 256, 20, 1, 1), (10000, 32, 150, 1, 1),
    (0, 4, 10, 1, 1)])
def test_partition_rows_matches_plain(lib, n, n_dest, cap, salt, mode):
    """K1 run as one thread (the count, then the sweep over tiles of 2048
    rows taken by ticket, each tile's offsets by the look-back) gives the
    plain version's send buffer, splits and pending flags in every round,
    for keys with bit 63 set, a hot key, salted rows and build replicas;
    the lanes in two sweeps (epochs 1 and 2, the second clearing the
    flags) as a partition of more than 32 lanes takes them."""
    import ctypes
    from datafusion_tpu_torch.device.exchange import (TILE,
                                                      partition_rows_plain)
    rng = np.random.default_rng(n + n_dest)
    keys = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n,
                                         dtype=np.int64))
    keys[torch.from_numpy(rng.random(n) < 0.3)] = 42
    lanes = [torch.from_numpy(rng.integers(0, 2**40, n)),
             torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
             torch.from_numpy(rng.random(n) < 0.5),
             torch.from_numpy(rng.integers(0, 99, n).astype(np.int16))]
    pend = torch.from_numpy(rng.random(n) < 0.9)
    mine = pend.clone()
    nt = max(-(-n // TILE), 1)
    for _round in range(1000):
        want = partition_rows_plain(keys, pend, n_dest, cap, lanes, salt,
                                    mode, 2)
        totals = torch.zeros(n_dest, dtype=torch.int64)
        flags = mine.view(torch.uint8)
        lib.h_part_count(_ptr(keys), _ptr(flags), n, n_dest, salt, mode, 2,
                         _ptr(totals))
        splits = [min(int(t), cap) for t in totals]
        assert splits == want.splits
        m = sum(splits)
        key_out = torch.empty(m, dtype=torch.int64)
        outs = [torch.empty(m, dtype=x.dtype) for x in lanes]
        status = torch.zeros(nt * n_dest, dtype=torch.int64)
        tickets = torch.zeros(2, dtype=torch.int64)
        for p, (lo, hi) in enumerate(((0, 2), (2, 4))):
            src = (ctypes.c_void_p * 2)(*[x.data_ptr() for x in lanes[lo:hi]])
            dst = (ctypes.c_void_p * 2)(*[x.data_ptr() for x in outs[lo:hi]])
            width = (ctypes.c_int * 2)(*[x.element_size()
                                         for x in lanes[lo:hi]])
            lib.h_part_sweep(_ptr(keys), _ptr(flags), n, n_dest, salt, mode,
                             2, _ptr(totals), cap, 2, src, dst, width,
                             _ptr(key_out) if p == 0 else None,
                             _ptr(status), tickets.data_ptr() + 8 * p,
                             p + 1, p)
        assert torch.equal(key_out, want.keys)
        for a, b in zip(outs, want.lanes):
            assert torch.equal(a, b)
        assert torch.equal(mine, pend)
        if not want.left:
            break
    assert not bool(pend.any())


@pytest.mark.parametrize("m,n_keys,n_owner,first,n_tables,limit,over", [
    (1, 3, 0, 0, 1, 3, False), (4000, 300, 0, 0, 1, 300, False),
    (6000, 5000, 4, 1, 1, 5000, False), (6000, 40, 7, 1, 1, 40, False),
    (6000, 300, 4, 0, 4, 300, False), (6000, 300, 7, 2, 3, 300, False),
    (6000, 300, 0, 0, 4, 300, False), (3000, 100, 1, 0, 1, 99, True),
    (3000, 100, 0, 0, 3, 100, False), (3000, 100, 0, 0, 3, 99, True)])
def test_merge_partials_matches_plain(lib, m, n_keys, n_owner, first,
                                      n_tables, limit, over):
    """K2 run as one thread folds the plain version's groups (every lane
    kind's merge; integer lanes exactly, float sums within rel 1e-12),
    across three calls into one set of local tables, through the
    wrapper's own launch parameters: on the all_gather route (`n_owner` >
    0) one source whose entries go to their owners' tables, the tables of
    shards `first` .. of the mesh (entries owned elsewhere skipped); on
    the shuffle route a source a table. The same distinct-key counts and
    overflow flags: `over` cases give every table `limit` + 1 keys, the
    case before each of them `limit`."""
    import ctypes
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.exchange import (MergeTables,
                                                      merge_partials_plain)
    from datafusion_tpu_torch.device.groupby import (LANE_SUM_F64,
                                                     compact_groups)
    rng = np.random.default_rng(m + n_tables)
    kinds, e = C._merge_entries(rng, m, n_keys)
    got, want = (MergeTables(kinds, limit, n_tables, CPU) for _ in range(2))
    for part in torch.chunk(e, 3, dim=1):
        srcs = [part.contiguous()] if n_owner > 0 else \
            [x.contiguous() for x in torch.chunk(part, n_tables, dim=1)]
        srcs += [srcs[0][:, :0]] * (n_tables - len(srcs)) * (n_owner == 0)
        args = got._args(srcs, n_owner, first, 0, n_tables)
        lib.h_merge(ctypes.byref(args), _ptr(got.tables), got.cap,
                    _ptr(got.groups), got.limit, _ptr(got.overflow))
        merge_partials_plain(srcs, want, n_owner, first)
    assert torch.equal(got.groups, want.groups)
    assert torch.equal(got.overflow, want.overflow)
    assert int(want.groups.sum()) > 0
    assert want.overflow.tolist() == [int(over)] * n_tables
    if over:
        assert want.groups.tolist() == [limit + 1] * n_tables
    for t in range(n_tables):
        a, b = compact_groups(got.tables[t]), compact_groups(want.tables[t])
        a, b = a[:, torch.argsort(a[0])], b[:, torch.argsort(b[0])]
        assert a.shape == b.shape
        for r in range(a.shape[0]):
            if r >= 2 and kinds[r - 2] == LANE_SUM_F64:
                np.testing.assert_allclose(a[r].view(torch.float64).numpy(),
                                           b[r].view(torch.float64).numpy(),
                                           rtol=1e-12)
            else:
                assert torch.equal(a[r], b[r])


# --- the compaction's HAVING ----------------------------------------------------

@pytest.mark.parametrize("case", [c for c, _f, _m in __import__(
    "test_torch_cuda").HAVING_CASES])
def test_mark_having_matches_mask(lib, case):
    """The mark pass's keep test (a slot occupied and passing every
    conjunct) against `HavingSpec.mask` on every slot of the group table,
    for every case of `test_torch_having.py`: the 16-byte layout's rounds
    (`keep_pairs`: HAVING_DIRECT's inline path over the lane's pairs, or
    `passes` an entry) in the spec's own mode and in the more general
    ones, and `passes` slot by slot (the slot-list layout)."""
    import test_torch_having as T
    from datafusion_tpu_torch.device.groupby import EMPTY, HAVING_PROGRAM
    _ex, hv, table, *_ = T.port_having(T.having_batch(), T.having_sql(case))
    want = ((table[0] != EMPTY) & hv.mask(table)).to(torch.uint8)
    meta = torch.from_numpy(hv.meta)
    n = table.shape[1]
    # a spec runs in its own mode and in the more general ones
    for mode in range(hv.mode, HAVING_PROGRAM + 1):
        for pairs in (0, 1):
            got = torch.zeros(n, dtype=torch.uint8)
            lib.h_keep(_ptr(meta), _ptr(table), n, n, mode, pairs,
                       _ptr(got))
            assert torch.equal(got, want), (mode, pairs)
    assert 0 < int(want.sum()) < int((table[0] != EMPTY).sum())


@pytest.mark.parametrize("name", __import__("test_torch_having").FOLDS)
def test_fold_matches_run(lib, name):
    """A folded constant holds the value the interpreter's `run` computes
    from the steps it replaces, bit for bit."""
    import test_torch_having as T
    from datafusion_tpu_torch.device.groupby import LANE_SUM_I64, _ProgramSpec
    from datafusion_tpu_torch.device.lower import OP_ICONST
    prog, folded = T.fold_case(name)
    ((op, k, _b),) = folded.code
    want = prog.pools.iconst[k] if op == OP_ICONST else \
        int(np.float64(prog.pools.fconst[k]).view(np.int64))
    spec = _ProgramSpec(prog.pools, None, [], [(prog, LANE_SUM_I64)])
    meta = spec.device_meta({}, CPU, spec._layout(0))
    aux = torch.zeros(1, dtype=torch.int64)
    got = torch.zeros(1, dtype=torch.int64)
    valid = torch.zeros(1, dtype=torch.uint8)
    lib.h_run(_ptr(meta), _ptr(aux), 0, 1, _ptr(got), _ptr(valid))
    assert int(valid) == 1 and int(got) == want
