"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the port's
machine does not need.) Each case runs one aggregate through
`fused_dense_aggregate` and through `dense_group_aggregate_plain` on the
same device tensors: counts, integer lanes and min/max must be equal,
float sums within rel 1e-12 (atomic adds change the order).
"""
import numpy as np
import pytest
import torch

from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.schema import Field, Schema

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, n).astype(np.int32)
    k = rng.integers(-1, 2, n).astype(np.int64)
    kv = rng.random(n) > 0.05
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.02] = np.nan
    vv = rng.random(n) > 0.03
    i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    f32 = (rng.normal(size=n) * 10).astype(np.float32)
    b = rng.random(n) < 0.5
    dec = rng.integers(0, 10**6, n).astype(np.int64)
    dic = Dictionary(np.array(["ab", "ac", "b", "ca", "d"], dtype=object))
    schema = Schema([Field("g", dt.STRING, False), Field("k", dt.INT64, True),
                     Field("v", dt.FLOAT64, True), Field("i", dt.INT32, False),
                     Field("f", dt.FLOAT32, False), Field("b", dt.BOOL, False),
                     Field("d", dt.decimal(15, 2), False)])
    return Batch(schema, [Column(dt.STRING, g, None, dic),
                          Column(dt.INT64, k, kv), Column(dt.FLOAT64, v, vv),
                          Column(dt.INT32, i32), Column(dt.FLOAT32, f32),
                          Column(dt.BOOL, b), Column(dt.decimal(15, 2), dec)], n)


QUERIES = [
    "SELECT g, k, count(*), count(v), sum(v), min(v), max(v) FROM t "
    "GROUP BY g, k",
    "SELECT g, sum(i), min(i), max(i), sum(f), min(f), max(f) FROM t "
    "WHERE b AND g LIKE 'a%' GROUP BY g",
    "SELECT k, sum(d * (1 - d)), avg(d), min(d) FROM t "
    "WHERE d >= 0.5 AND g IN ('b', 'd') GROUP BY k",
    "SELECT count(*), sum(i + 1), sum(-k) FROM t WHERE k IS NOT NULL "
    "AND (v > 0 OR v IS NULL) AND g <= 'c'",
]


@pytest.mark.parametrize("q", QUERIES)
def test_kernel_matches_plain(cuda, q):
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F64, dense_group_aggregate, dense_group_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    batch = _table(300_000, 7)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    plan = ctx.sql(q).create_physical_plan()
    node = plan
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    cols, aux = node.stage(spec, src)
    before = dft.launch_counts()["fused_dense_aggregate"]
    got = dense_group_aggregate(spec, cols, aux, src.num_rows,
                                spec.new_table(cuda))
    assert dft.launch_counts()["fused_dense_aggregate"] == before + 1
    want = dense_group_aggregate_plain(spec, cols, aux, src.num_rows,
                                       spec.new_table(cuda))
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[0], w[0])
    for (_prog, kind), a, b in zip(spec.lanes, spec.lane_arrays(g),
                                   spec.lane_arrays(w)):
        if kind == LANE_SUM_F64:
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


def test_cuda_end_to_end_matches_cpu(cuda):
    import datafusion_tpu_torch as dft
    batch = _table(200_000, 3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = dft.SessionContext(dev)
        ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
        out.append(ctx.sql("SELECT g, count(*) c, sum(d) s, avg(d) a FROM t "
                           "WHERE b GROUP BY g ORDER BY g").to_pydict())
    assert out[0] == out[1]


# --- the hash path: hash_group_aggregate, compact_groups, group_topk --------

def _wide_table(n, seed, key_bits):
    """x: int64 keys over 2^key_bits (2^40 makes the kernel probe), few
    rows per key; other columns as `_table`'s, plus an int32 key g."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, n // 3, n) * ((1 << key_bits) // (n // 3))
    base = _table(n, seed)
    schema = Schema([Field("x", dt.INT64, False),
                     Field("gi", dt.INT32, False)] + list(base.schema.fields))
    gi = rng.integers(0, 1000, n).astype(np.int32)
    return Batch(schema, [Column(dt.INT64, x), Column(dt.INT32, gi)]
                 + list(base.columns), n)


def _exec(ctx, q):
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    node = ctx.sql(q).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    return node


def _by_key(spec, host):
    order = np.argsort(host[0], kind="stable")
    return host[0][order], host[1][order], \
        [a[order] for a in spec.lane_arrays(host, first=2)]


def _assert_tables_equal(spec, got, want):
    from datafusion_tpu_torch.device.groupby import LANE_SUM_F32, LANE_SUM_F64
    gk, gc, gl = _by_key(spec, got)
    wk, wc, wl = _by_key(spec, want)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    for (_p, kind), a, b in zip(spec.lanes, gl, wl):
        # atomic adds change the order; a group of a few rows can sum to
        # near 0, so the bound is absolute too: a few float64 (float32)
        # ulps of the largest partial sum, about 1e3 (1e2)
        if kind == LANE_SUM_F64:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9,
                                       equal_nan=True)
        elif kind == LANE_SUM_F32:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)


HASH_QUERIES = [
    # 2^40 key space: the probing table
    ("SELECT x, count(*), count(v), sum(v), min(v), max(v), sum(f), min(i), "
     "max(i), sum(d) FROM t GROUP BY x", 40, False),
    # 1000 x 5 x 3 slots: the packed key is the slot
    ("SELECT gi, g, k, count(*), sum(d), avg(v), max(f) FROM t WHERE b "
     "GROUP BY gi, g, k", 20, True),
]


@pytest.mark.parametrize("q,bits,identity", HASH_QUERIES)
def test_hash_kernel_matches_plain(cuda, q, bits, identity):
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        HashSpec, compact_groups, compact_groups_plain, hash_group_aggregate,
        hash_group_aggregate_plain)
    batch = _wide_table(300_000, 11, bits)
    half = batch.num_rows // 2
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, q)
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    assert isinstance(spec, HashSpec) and spec.identity_slots == identity
    cols, aux = node.stage(spec, src)
    tables = []
    for fold, compact in ((hash_group_aggregate, compact_groups),
                          (hash_group_aggregate_plain, compact_groups_plain)):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        # two folds into one table: the port of the reference's _merge
        fold(spec, cols, aux, half, table, overflow)
        rest = {i: (d[half:], None if v is None else v[half:])
                for i, (d, v) in cols.items()}
        fold(spec, rest, aux, src.num_rows - half, table, overflow)
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        tables.append(compact(table).cpu().numpy())
    assert dft.launch_counts()["hash_group_aggregate"] >= 2
    _assert_tables_equal(spec, *tables)


def test_hash_overflow_is_flagged(cuda):
    """A table too small for its keys sets the overflow flag."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        HashSpec, hash_group_aggregate)
    batch = _wide_table(50_000, 12, 40)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, "SELECT x, count(*) FROM t GROUP BY x")
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    small = HashSpec(spec.pools, spec.pred,
                     [(p, o, 40) for p, o, _s in spec.keys], spec.lanes, 100)
    cols, aux = node.stage(small, src)
    table = small.new_table(cuda)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
    hash_group_aggregate(small, cols, aux, src.num_rows, table, overflow)
    assert int(overflow.item()) == 1


def test_having_compaction_matches_plain(cuda):
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, compact_groups_plain, hash_group_aggregate)
    batch = _wide_table(300_000, 13, 40)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, "SELECT x, sum(d) s, count(*) c, min(v) mn FROM t "
                      "GROUP BY x HAVING sum(d) > 15000 AND count(*) >= 3 "
                      "AND (min(v) < 0 OR min(v) IS NULL)")
    assert node.post_filter is not None
    (src,) = node.input_batches(ctx.task_context())
    spec, plan, names, slot_map = node.compile([src])
    having = node.having(spec, plan, names, slot_map)
    cols, aux = node.stage(spec, src)
    table = spec.new_table(cuda)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
    hash_group_aggregate(spec, cols, aux, src.num_rows, table, overflow)
    before = dft.launch_counts()["compact_groups"]
    got = compact_groups(table, having).cpu().numpy()
    assert dft.launch_counts()["compact_groups"] == before + 1
    want = compact_groups_plain(table, having).cpu().numpy()
    # both keep slot order, so they agree column for column
    np.testing.assert_array_equal(got, want)
    assert 0 < got.shape[1] < int((table[0] != -1).sum())


@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("k", [1, 10, 1000, 200_000])
def test_topk_kernel_matches_plain(cuda, asc, k):
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, group_topk, group_topk_plain, hash_group_aggregate)
    import datafusion_tpu_torch as dft
    batch = _wide_table(400_000, 14, 40)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, "SELECT x, count(*) c, sum(i) s FROM t GROUP BY x")
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, names, _s = node.compile([src])
    cols, aux = node.stage(spec, src)
    table = spec.new_table(cuda)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
    hash_group_aggregate(spec, cols, aux, src.num_rows, table, overflow)
    k = min(k, 1 << 16)
    for lane in (1, 2 + names.index([n for n in names if n.endswith("#s")][0])):
        got = group_topk(table, lane, asc, k)
        want = group_topk_plain(table, lane, asc, k)
        g = compact_groups(table, slots=got).cpu().numpy()
        w = compact_groups(table, slots=want).cpu().numpy()
        assert g.shape == w.shape
        gv, wv = np.sort(g[lane]), np.sort(w[lane])
        np.testing.assert_array_equal(gv, wv)     # the order column
        # the key set beyond the k-th value
        kth = wv[-1] if asc else wv[0]
        beyond = (lambda r: r[lane] < kth) if asc else \
            (lambda r: r[lane] > kth)
        np.testing.assert_array_equal(np.sort(g[0][beyond(g)]),
                                      np.sort(w[0][beyond(w)]))


def test_cuda_hash_path_end_to_end_matches_cpu(cuda):
    import datafusion_tpu_torch as dft
    batch = _wide_table(200_000, 15, 40)
    queries = [
        "SELECT x, count(*) c, sum(d) s, min(i) mn FROM t GROUP BY x "
        "HAVING count(*) > 3 ORDER BY x",
        "SELECT gi, count(*) c FROM t GROUP BY gi ORDER BY c DESC, gi "
        "LIMIT 7",
    ]
    for q in queries:
        out = []
        for dev in (cuda, torch.device("cpu")):
            ctx = dft.SessionContext(dev)
            ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
            out.append(ctx.sql(q).to_pydict())
            assert _exec(ctx, q).fallbacks == 0
        assert out[0] == out[1], q
