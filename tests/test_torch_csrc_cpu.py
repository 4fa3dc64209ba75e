"""The port's CUDA sources compiled for the CPU, against the plain versions.

`g++` builds `csrc/program.cuh` and the kernel bodies of
`fused_dense_aggregate.cu`, `chain_build.cu` and `chain_aggregate.cu`
(each file above its `extern "C"` launch wrappers) through `SHIM`, a
header that defines the CUDA names for one thread: `__device__` is empty,
`__ldg` a load, an atomic a plain read-modify-write, a warp shuffle gives
back its own value. Each kernel then runs as one thread of one block over
the inputs its plain PyTorch version reads, and the two must agree
exactly (the transcendental math functions within rel 1e-15, glibc's
against PyTorch's): every program of the lowering tests, the dense fold,
every build table (the insert pass; the range pass needs a warp) and
every chain walk of TPC-H at SF 0.01 and of the min/max membership cases.
Each kernel runs in the interpreter variant (lean or full) that its spec's
`full` flag picks, as the launch wrappers do, so a program that needs the
full variant and is not flagged for it fails here. This holds the kernels' logic where there is no GPU; their parallel
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
template <class T> T __shfl_down_sync(unsigned, T v, int) { return v; }
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
extern "C" {
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
                  int* overflow, int full) {
  (full ? ca::chain_hash_kernel<true> : ca::chain_hash_kernel<false>)(
      meta, len, aux, n, cap, ident, table, overflow);
}
void h_chain_dense(const long long* meta, int len, const long long* aux,
                   long long n, unsigned long long* table, int full) {
  (full ? ca::chain_dense_kernel<true> : ca::chain_dense_kernel<false>)(
      meta, len, aux, n, table);
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
    for name in ("fused_dense_aggregate", "chain_build", "chain_aggregate"):
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
    ovf = torch.zeros(1, dtype=torch.int32)
    for cols, aux, n in inputs:
        meta = spec.device_meta(cols, CPU)
        if dense:
            lib.h_chain_dense(_ptr(meta), len(spec.meta), _ptr(aux), n,
                              _ptr(got), int(spec.full))
        else:
            lib.h_chain_hash(_ptr(meta), len(spec.meta), _ptr(aux), n,
                             spec.cap, int(spec.identity_slots), _ptr(got),
                             _ptr(ovf), int(spec.full))
        chain_aggregate_plain(spec, cols, aux, n, want,
                              torch.zeros(1, dtype=torch.int32))
    g, w = _groups(got, dense), _groups(want, dense)
    assert g.keys() == w.keys() and int(ovf) == 0
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
