"""The port's CUDA sources compiled for the CPU, against the plain versions.

`g++` builds `csrc/program.cuh` and the kernel bodies of
`fused_dense_aggregate.cu`, `hash_group_aggregate.cu`, `chain_build.cu`,
`chain_aggregate.cu`, `chain_rows.cu`, `chain_compose.cu`, `join_build.cu`
and `join_aggregate.cu` (each file
above its `extern "C"` launch wrappers; `scan.cuh`, whose device-wide scan
launches kernels, is left out and the join build's scan runs as
`torch.cumsum`) through `SHIM`, a
header that defines the CUDA names for one thread: `__device__` is empty,
`__ldg` a load, an atomic a plain read-modify-write, a warp shuffle gives
back its own value, a ballot its own bit, `__match_any_sync` and
`__activemask` the thread alone (so a warp loop sized by the warp's
members takes one row a step; `test_torch_join_walk.py` replays the
32-lane steps). Each kernel then runs as one thread of one block over
the inputs its plain PyTorch version reads, and the two must agree
exactly (the transcendental math functions within rel 1e-15, glibc's
against PyTorch's): every program of the lowering tests, the dense fold,
every build table (the insert pass; the range pass needs a warp) and
every chain walk of TPC-H at SF 0.01 and of the min/max membership cases
(with their staging-time compositions and folds, as the exec stages them;
every composition and fold itself, and the row-returning walk's mark and
emit passes over Q2's composed and folded chain),
the count(DISTINCT x) lane's set inserts (dense, hash and chain folds,
lanes past 32 in passes), the fanout-N join's build (the multiset of
entry records a bucket) and probe-and-fold, and the mesh's row partition (K1:
histogram, the scan as `torch.cumsum`, the stable scatter, round after
round) and partial-table merge (K2).
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
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 16 };
struct Dim3S { unsigned x = 0, y = 0, z = 0; };
static Dim3S threadIdx, blockIdx, blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
inline double __longlong_as_double(long long b) {
  double d; memcpy(&d, &b, 8); return d; }
inline long long __double_as_longlong(double d) {
  long long b; memcpy(&b, &d, 8); return b; }
inline float __double2float_rn(double d) { return (float)d; }
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
extern "C" {
void h_part_hist(const long long* keys, const unsigned char* pending,
                 long long n, int n_dest, int salt, int mode, long long r,
                 long long tile, long long n_tiles, long long* counts,
                 unsigned long long* totals) {
  xc::partition_hist_kernel(keys, pending, n, n_dest, salt, mode, r, tile,
                            n_tiles, counts, totals);
}
void h_part_scatter(const long long* keys, unsigned char* pending,
                    long long n, int n_dest, int salt, int mode, long long r,
                    long long tile, long long n_tiles,
                    const long long* offsets,
                    const unsigned long long* totals, long long cap,
                    int n_lanes, void* const* src, void* const* dst,
                    const int* width, long long* key_out) {
  xc::XLanes x;
  x.n_lanes = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    x.src[l] = src[l];
    x.dst[l] = dst[l];
    x.width[l] = width[l];
  }
  xc::partition_scatter_kernel(keys, pending, n, n_dest, salt, mode, r, tile,
                               n_tiles, offsets, totals, cap, x, key_out, 1);
}
void h_merge(const long long* entries, long long m, int rows,
             const long long* kinds, int my, int n_owner, long long* table,
             long long cap, unsigned long long* groups, long long limit,
             int* overflow) {
  xc::merge_partials_kernel(entries, m, rows, kinds, my, n_owner, table, cap,
                            groups, limit, overflow);
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
void h_chain_hash(const long long* meta, int len, const long long* aux,
                  long long n, long long cap, int ident, long long* table,
                  int* overflow, int variant) {
  DFT_WALK_VARIANT(ca::chain_hash_kernel, variant)(
      meta, len, aux, n, cap, ident, table, overflow);
}
void h_chain_dense(const long long* meta, int len, const long long* aux,
                   long long n, unsigned long long* table, int variant) {
  DFT_WALK_VARIANT(ca::chain_dense_kernel, variant)(meta, len, aux, n, table);
}
void h_rows_mark(const long long* meta, int len, const long long* aux,
                 long long n, long long* pos, int variant) {
  DFT_WALK_VARIANT(cr::rows_mark_kernel, variant)(meta, len, aux, n, pos);
}
void h_rows_emit(const long long* meta, int len, const long long* aux,
                 long long n, const long long* pos, const long long* outs,
                 int variant) {
  DFT_WALK_VARIANT(cr::rows_emit_kernel, variant)(meta, len, aux, n, pos,
                                                  outs);
}
void h_compose(const long long* meta, int len, const long long* aux,
               long long n, int owner, long long* out, long long words,
               int mmx, int full) {
  (full ? cc::chain_compose_kernel<true> : cc::chain_compose_kernel<false>)(
      meta, len, aux, n, owner, out, words, mmx);
}
void h_fold(const int* rows, long long size, const long long* comp,
            int comp_words, const long long* cols, int n_cols,
            long long* rec, unsigned char* valid, int rec_words) {
  cc::chain_fold_kernel(rows, size, comp, comp_words, cols, n_cols, rec,
                        valid, rec_words);
}
void h_hash(const long long* meta, int len, const long long* aux,
            long long n, long long cap, int ident, long long* table,
            int* overflow, int full) {
  (full ? hg::hash_group_aggregate_kernel<true>
        : hg::hash_group_aggregate_kernel<false>)(meta, len, aux, n, cap,
                                                  ident, table, overflow);
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
    shutil.copy(os.path.join(CSRC, "program.cuh"), d / "program.cuh")
    (d / "scan.cuh").write_text("#pragma once\n")
    for name in ("fused_dense_aggregate", "chain_build", "chain_aggregate",
                 "chain_rows", "chain_compose", "hash_group_aggregate",
                 "join_build", "join_aggregate", "exchange"):
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
    out.h_chain_hash.argtypes = [P, I, P, LL, LL, I, P, P, I]
    out.h_chain_dense.argtypes = [P, I, P, LL, P, I]
    out.h_rows_mark.argtypes = [P, I, P, LL, P, I]
    out.h_rows_emit.argtypes = [P, I, P, LL, P, P, I]
    out.h_compose.argtypes = [P, I, P, LL, I, P, LL, I, I]
    out.h_fold.argtypes = [P, LL, P, I, P, I, P, P, I]
    out.h_hash.argtypes = [P, I, P, LL, LL, I, P, P, I]
    out.h_jb_hash.argtypes = [P, I, P, LL, P, P, P, I]
    out.h_jb_count.argtypes = [P, LL, LL, P]
    out.h_jb_scatter.argtypes = [P, P, I, LL, LL, P, P, P, I, I, P, P, P]
    out.h_join.argtypes = [P, I, P, LL, LL, I, P, P, I]
    out.h_part_hist.argtypes = [P, P, LL, I, I, I, LL, LL, LL, P, P]
    out.h_part_scatter.argtypes = [P, P, LL, I, I, I, LL, LL, LL, P, P, LL,
                                   I, P, P, P, P]
    out.h_merge.argtypes = [P, LL, I, P, I, I, P, LL, P, LL, P]
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


def _check_chain(lib, ctx, sql):
    """Every build side's insert pass and the walk of the query's first
    chain aggregate, against the plain versions."""
    from datafusion_tpu_torch.device.groupby import (
        EMPTY, LANE_SUM_F64, AggregateSpec)
    from datafusion_tpu_torch.device.join_chain import (
        TAB_EMPTY, TAB_HASH, chain_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    todo = [ctx.sql(sql).create_physical_plan()]
    while not isinstance(todo[-1], TorchJoinChainAggregateExec):
        node = todo.pop()
        todo += node.children()[::-1]
    spec, _plan, _n, _s, inputs, staged = todo[-1].prepare(
        ctx.task_context())
    for bi in staged:
        t = bi.table
        if t.kind == TAB_EMPTY:
            continue
        mmx = t.mn is not None
        rows = torch.full((t.size,), -1, dtype=torch.int32)
        keys = torch.full((t.size,), EMPTY, dtype=torch.int64) \
            if t.kind == TAB_HASH else None
        mn = torch.full_like(t.mn, np.iinfo(np.int64).max) if mmx else None
        mx = torch.full_like(t.mx, np.iinfo(np.int64).min) if mmx else None
        dup = torch.zeros(1, dtype=torch.int32)
        meta = bi.spec.device_meta(bi.cols, CPU,
                                   bi.spec.packed_meta(t.los, t.shifts))
        lib.h_insert(_ptr(meta), len(meta), _ptr(bi.aux), bi.batch.num_rows,
                     t.kind, t.size, _ptr(rows), _ptr(keys), _ptr(mn),
                     _ptr(mx), _ptr(dup), int(bi.spec.full))
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
                                  _ptr(got), spec.variant)
            else:
                lib.h_chain_hash(_ptr(m), len(meta), _ptr(aux), n,
                                 spec.cap, int(spec.identity_slots),
                                 _ptr(got), _ptr(ovf), spec.variant)
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


# --- staging-time composition and folding --------------------------------------

def _check_compose_and_fold(lib, ex, tctx):
    """Every composition of the chain exec `ex`, run again through the
    kernel into a copy of its owner's words, and every fold, through the
    kernel into fresh records, against what the plain versions staged.
    Returns (compositions, folds) checked."""
    from datafusion_tpu_torch.device.join_chain import fold_columns
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainRowsExec)
    if isinstance(ex, TorchJoinChainRowsExec):
        spec, inputs, staged = ex.prepare_rows(tctx)
    else:
        spec, _p, _n, _s, inputs, staged = ex.prepare(tctx)
    cols = inputs[0][0]
    n_comp = n_fold = 0
    for bi, s in enumerate(staged):
        c = s.compose
        if c is None:
            continue
        cspec, ccols, aux, n = ex.compose_input(staged, bi, c.owner)
        got = c.words.clone()
        got[:, c.word:c.word + c.width] = -7
        meta = cspec.device_meta(ccols, CPU)
        lib.h_compose(_ptr(meta), len(cspec.meta), _ptr(aux), n, c.owner,
                      got.data_ptr() + 8 * c.word, got.shape[1],
                      int(c.tag == "mmx"), int(cspec.full))
        assert torch.equal(got, c.words), bi
        n_comp += 1
    for h, hop in enumerate(spec.chain.hops):
        f = hop.fold
        if f is None:
            continue
        comp = next((o.compose.words for o in spec.chain.hops
                     if o.compose is not None and o.compose.owner == h), None)
        columns = [cols[p] for p in f.columns]
        desc = fold_columns(columns, f)
        rec = torch.zeros_like(f.records)
        valid = None if f.valid is None else torch.zeros_like(f.valid)
        lib.h_fold(_ptr(hop.table.rows), hop.table.size, _ptr(comp), f.n_comp,
                   _ptr(desc) if columns else None, len(columns), _ptr(rec),
                   _ptr(valid), f.words)
        assert torch.equal(rec, f.records), h
        assert valid is None or torch.equal(valid, f.valid), h
        n_fold += 1
    return n_comp, n_fold


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


def test_q2_rows_walk_with_composed_and_folded_hops_matches_plain(lib):
    """`chain_rows`' mark and emit passes (the scan as `torch.cumsum`) over
    TPC-H Q2's row-returning chain, whose nation and region hops compose
    into supplier and whose supplier hop folds: the outputs equal
    `chain_rows_plain`'s in spine order."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.join_chain import (_DTYPE_CODE,
                                                        chain_rows_plain)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainRowsExec)
    from datafusion_tpu_torch.tpch.datagen import register_tpch
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = dft.SessionContext(CPU)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    register_tpch(ctx, sf=0.01, seed=1)
    (ex,) = [e for e in _chain_execs(ctx, QUERIES[2])
             if isinstance(e, TorchJoinChainRowsExec)]
    spec, inputs, _staged = ex.prepare_rows(ctx.task_context())
    assert any(h.compose is not None for h in spec.chain.hops)
    assert any(h.fold is not None for h in spec.chain.hops)
    ((cols, aux, n, _view),) = inputs
    meta = spec.device_meta(cols, CPU)
    pos = torch.full((n + 1,), -1, dtype=torch.int64)
    lib.h_rows_mark(_ptr(meta), len(spec.meta), _ptr(aux), n, _ptr(pos),
                    spec.variant)
    assert int(pos[n]) == 0
    keep = pos[:n].clone()
    pos[1:] = torch.cumsum(keep, 0)
    pos[0] = 0
    total = int(pos[n])
    want = chain_rows_plain(spec, cols, aux, n)
    assert total == want[0][0].numel() > 0
    outs = [(torch.zeros(total, dtype=d.dtype), torch.zeros(total,
                                                            dtype=torch.bool))
            for d, _v in want]
    ptrs = torch.tensor([p for d, v in outs for p in (d.data_ptr(),
                                                      v.data_ptr())],
                        dtype=torch.int64)
    assert all(d.dtype in _DTYPE_CODE for d, _v in outs)
    lib.h_rows_emit(_ptr(meta), len(spec.meta), _ptr(aux), n, _ptr(pos),
                    _ptr(ptrs), spec.variant)
    assert spec.variant & 2
    for (gd, gv), (wd, wv) in zip(outs, want):
        assert torch.equal(gv, wv) and torch.equal(gd, wd)


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
    for meta in spec.metas:
        m = spec.device_meta(cols, CPU, meta, dg)
        if dense:
            lib.h_dense(_ptr(m), len(meta), _ptr(aux), n, _ptr(got),
                        int(spec.full))
        else:
            lib.h_hash(_ptr(m), len(meta), _ptr(aux), n, spec.cap,
                       int(spec.identity_slots), _ptr(got), _ptr(ovf),
                       int(spec.full))
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
    (3000, 5, 2000, 3, 2), (9000, 256, 20, 1, 1)])
def test_partition_rows_matches_plain(lib, n, n_dest, cap, salt, mode):
    """K1 run as one thread (a tile of 4096 rows at a time) gives the plain
    version's send buffer, splits and pending flags in every round, for
    keys with bit 63 set, a hot key, salted rows and build replicas."""
    import ctypes
    from datafusion_tpu_torch.device.exchange import (TILE,
                                                      partition_rows_plain)
    rng = np.random.default_rng(n + n_dest)
    keys = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n,
                                         dtype=np.int64))
    keys[torch.from_numpy(rng.random(n) < 0.3)] = 42
    lanes = [torch.from_numpy(rng.integers(0, 2**40, n)),
             torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
             torch.from_numpy(rng.random(n) < 0.5)]
    pend = torch.from_numpy(rng.random(n) < 0.9)
    mine = pend.clone()
    nt = max(-(-n // TILE), 1)
    for _round in range(1000):
        want = partition_rows_plain(keys, pend, n_dest, cap, lanes, salt,
                                    mode, 2)
        counts = torch.zeros(n_dest * nt, dtype=torch.int64)
        totals = torch.zeros(n_dest, dtype=torch.int64)
        flags = mine.view(torch.uint8)
        lib.h_part_hist(_ptr(keys), _ptr(flags), n, n_dest, salt, mode, 2,
                        TILE, nt, _ptr(counts), _ptr(totals))
        splits = [min(int(t), cap) for t in totals]
        assert splits == want.splits
        offsets = torch.cumsum(counts, 0) - counts
        m = sum(splits)
        key_out = torch.empty(m, dtype=torch.int64)
        outs = [torch.empty(m, dtype=x.dtype) for x in lanes]
        src = (ctypes.c_void_p * 3)(*[x.data_ptr() for x in lanes])
        dst = (ctypes.c_void_p * 3)(*[x.data_ptr() for x in outs])
        width = (ctypes.c_int * 3)(*[x.element_size() for x in lanes])
        lib.h_part_scatter(_ptr(keys), _ptr(flags), n, n_dest, salt, mode, 2,
                           TILE, nt, _ptr(offsets), _ptr(totals), cap, 3,
                           src, dst, width, _ptr(key_out))
        assert torch.equal(key_out, want.keys)
        for a, b in zip(outs, want.lanes):
            assert torch.equal(a, b)
        assert torch.equal(mine, pend)
        if not want.left:
            break
    assert not bool(pend.any())


@pytest.mark.parametrize("m,n_keys,n_owner", [
    (1, 3, 0), (4000, 300, 0), (6000, 5000, 4), (6000, 40, 7)])
def test_merge_partials_matches_plain(lib, m, n_keys, n_owner):
    """K2 run as one thread folds the plain version's groups (every lane
    kind's merge; integer lanes exactly, float sums within rel 1e-12),
    across three calls into one table, with the ownership test."""
    import test_torch_cuda as C
    from datafusion_tpu_torch.device.exchange import (MergeTable,
                                                      merge_partials_plain)
    from datafusion_tpu_torch.device.groupby import (LANE_SUM_F64,
                                                     compact_groups)
    rng = np.random.default_rng(m)
    kinds, e = C._merge_entries(rng, m, n_keys)
    got, want = MergeTable(kinds, n_keys, CPU), MergeTable(kinds, n_keys, CPU)
    for part in torch.chunk(e, 3, dim=1):
        part = part.contiguous()
        lib.h_merge(_ptr(part), part.shape[1], part.shape[0],
                    _ptr(got.kinds_d), 1, n_owner, _ptr(got.table), got.cap,
                    _ptr(got.groups), got.limit, _ptr(got.overflow))
        merge_partials_plain(part, want, my=1, n_owner=n_owner)
    assert int(got.groups) == int(want.groups)
    assert int(got.overflow) == int(want.overflow) == 0
    a, b = compact_groups(got.table), compact_groups(want.table)
    a, b = a[:, torch.argsort(a[0])], b[:, torch.argsort(b[0])]
    assert a.shape == b.shape
    for r in range(a.shape[0]):
        if r >= 2 and kinds[r - 2] == LANE_SUM_F64:
            np.testing.assert_allclose(a[r].view(torch.float64).numpy(),
                                       b[r].view(torch.float64).numpy(),
                                       rtol=1e-12)
        else:
            assert torch.equal(a[r], b[r])
