"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the port's
machine does not need.) Each case runs one aggregate through
`fused_dense_aggregate` and through `dense_group_aggregate_plain` on the
same device tensors: counts, integer lanes and min/max must be equal,
float sums within rel 1e-12 (atomic adds change the order). The later
cases do the same for the other kernels: the hash path, compaction,
top-k, the join chain, the radix sort, the lane gather and the window
scan.
"""
import numpy as np
import pytest
import torch

from datafusion_tpu_torch.common import dt
from datafusion_tpu_torch.common.batch import Batch
from datafusion_tpu_torch.common.column import Column, Dictionary
from datafusion_tpu_torch.common.schema import Field, Schema

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


# --- the join chain: chain_build, chain_aggregate --------------------------

def _tpch_ctx(device, sf):
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.tpch.datagen import register_tpch
    ctx = dft.SessionContext(device)
    register_tpch(ctx, sf=sf, seed=1)
    return ctx


def _chain_exec(ctx, q):
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    node = ctx.sql(q).create_physical_plan()
    while not isinstance(node, TorchJoinChainAggregateExec):
        node = node.children()[0]
    return node


def _build_inputs(n, seed, sparse, nulls):
    """An int64 key column (unique unless `sparse` draws from a wide range
    with repeats), a NULL mask, and a filter column."""
    rng = np.random.default_rng(seed)
    if sparse:
        keys = rng.integers(0, 1 << 40, n)
    else:
        keys = rng.permutation(n).astype(np.int64) * 3 + 7
    valid = rng.random(n) > 0.05 if nulls else None
    f = rng.integers(0, 100, n).astype(np.int32)
    return keys, valid, f


@pytest.mark.parametrize("sparse,unique", [(False, True), (True, True),
                                           (True, False)])
def test_chain_build_matches_plain(cuda, sparse, unique):
    """Direct and hashed build tables, INNER (duplicates flagged) and
    SEMI (presence), from the kernel and from its plain version."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.common.column import to_device
    from datafusion_tpu_torch.common.scalar import ScalarValue
    from datafusion_tpu_torch.device.join_chain import (
        TAB_DIRECT, TAB_HASH, BuildSpec, chain_build, chain_build_plain)
    from datafusion_tpu_torch.device.lower import Pools, compile_expr
    from datafusion_tpu_torch.expr.operator import Op
    from datafusion_tpu_torch.physical.expressions import (
        BinaryPhysExpr, ColumnExpr, LiteralExpr)
    n = 500_000
    keys, valid, f = _build_inputs(n, 21, sparse, nulls=True)
    if not unique:
        keys[::7] = keys[1::7][:len(keys[::7])]
    cols_h = [Column(dt.INT64, keys, valid), Column(dt.INT32, f)]
    pools = Pools()
    pred = compile_expr(BinaryPhysExpr(
        ColumnExpr(1, "f", dt.INT32), Op.LT,
        LiteralExpr(ScalarValue(dt.INT32, 60)), dt.BOOL), pools)
    spec = BuildSpec(pools, pred, [compile_expr(ColumnExpr(0, "k", dt.INT64),
                                                pools)])
    cols = {i: to_device(cols_h[i], cuda) for i in pools.columns}
    aux = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = dft.launch_counts()["chain_build"]
    got = chain_build(spec, cols, aux, n, unique=True)
    assert dft.launch_counts()["chain_build"] == before + 1
    want = chain_build_plain(spec, cols, aux, n, unique=True)
    assert got.kind == want.kind == (TAB_HASH if sparse else TAB_DIRECT)
    assert (got.los, got.his, got.live, got.duplicate) == \
        (want.los, want.his, want.live, want.duplicate)
    assert got.duplicate == (not unique)
    gk, gr = got.entries()
    wk, wr = want.entries()
    np.testing.assert_array_equal(gk, wk)
    if unique:       # with duplicates any one of a key's rows may stay
        np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("q", [3, 4, 5])
def test_chain_aggregate_matches_plain(cuda, q):
    """TPC-H Q3 (hash fold), Q4 (SEMI) and Q5 (five hops, a residual, a
    payload string key): the kernel's group table against its plain
    version's, on the same staged builds and spine."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F32, LANE_SUM_F64, AggregateSpec, compact_groups,
        dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        chain_aggregate, chain_aggregate_plain)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = _tpch_ctx(cuda, 0.1)
    ex = _chain_exec(ctx, QUERIES[q])
    spec, _plan, _names, _slots, inputs, _staged = ex.prepare(
        ctx.task_context())
    ((cols, aux, rows),) = inputs
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        before = dft.launch_counts()["chain_aggregate"]
        fold(spec, cols, aux, rows, table, overflow)
        assert dft.launch_counts()["chain_aggregate"] == \
            before + (fold is chain_aggregate)
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        if isinstance(spec, AggregateSpec):
            table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in tables)
    assert got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_array_equal(got[:2], want[:2])
    for (_p, kind), a, b in zip(spec.lanes, spec.lane_arrays(got, first=2),
                                spec.lane_arrays(want, first=2)):
        if kind in (LANE_SUM_F64, LANE_SUM_F32):
            np.testing.assert_allclose(a, b, rtol=1e-9)
        else:
            np.testing.assert_array_equal(a, b)


def test_cuda_join_chain_end_to_end_matches_cpu(cuda):
    from datafusion_tpu_torch.tpch.queries import QUERIES
    for q in (3, 4, 5):
        out = []
        for dev in (cuda, torch.device("cpu")):
            ctx = _tpch_ctx(dev, 0.05)
            out.append(ctx.sql(QUERIES[q]).to_pydict())
            assert _chain_exec(ctx, QUERIES[q]).fallbacks == 0
        assert out[0] == out[1], q


def _words(n, seed):
    """Order words of every kind a sort meets: a uint8 null rank, a uint64
    key over the whole range (both extremes), a uint64 key with many ties,
    an all-zero rank."""
    rng = np.random.default_rng(seed)
    full = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    full[: min(n, 2)] = [np.uint64(2**64 - 1), np.uint64(0)][: min(n, 2)]
    return [(rng.random(n) < 0.3).astype(np.uint8),
            rng.integers(0, 7, n).astype(np.uint64),
            np.zeros(n, np.uint8), full]


@pytest.mark.parametrize("n", [1, 2, 4097, 300_000])
@pytest.mark.parametrize("limit", [None, 10])
def test_radix_sort_matches_plain(cuda, n, limit):
    """Kernel 19: the permutation equals its plain version's and
    np.lexsort's, ties in row order, limits included."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain, to_word)
    host = _words(n, n)
    words = [to_word(w).to(cuda) for w in host]
    before = dft.launch_counts()["radix_sort"]
    got = radix_sort(words, limit).cpu().numpy()
    assert dft.launch_counts()["radix_sort"] > before or n == 1
    want = radix_sort_plain(words, limit).cpu().numpy()
    lex = np.lexsort(tuple(reversed(host)))[:limit]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lex)


def test_gather_lanes_matches_plain(cuda):
    """Kernel 8: every lane dtype, more lanes than one launch takes, and an
    index list with repeats (not a permutation)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        reorder_rows, reorder_rows_plain)
    rng = np.random.default_rng(8)
    n = 100_003
    kinds = [np.uint8, np.bool_, np.int16, np.int32, np.int64, np.float32,
             np.float64]
    lanes = [torch.from_numpy(
        (rng.integers(0, 255, n) if k not in (np.float32, np.float64)
         else rng.normal(size=n)).astype(k)).to(cuda)
        for k in kinds * 6]
    for order in (rng.permutation(n), rng.integers(0, n, 5000)):
        o = torch.from_numpy(order.astype(np.int64)).to(cuda)
        before = dft.launch_counts()["gather_lanes"]
        got = reorder_rows(o, lanes)
        assert dft.launch_counts()["gather_lanes"] == before + 2
        for g, w in zip(got, reorder_rows_plain(o, lanes)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)


WINDOW_SPECS = [("rank", f) for f in ("row_number", "rank", "dense_rank",
                                      "percent_rank", "cume_dist")] + [
    ("ntile", 7), ("shift", -1), ("shift", 3),
    ("agg", "sum_i", "part", 0, "part", 0),
    ("agg", "sum_i", "part", 0, "peer", 0),
    ("agg", "sum_f", "part", 0, "cur", 0),
    ("agg", "sum_f", "rows", -6, "cur", 0),
    ("agg", "cnt", "peer", 0, "rows", 2),
    ("agg", "cnt", "cur", 0, "part", 0)]


@pytest.mark.parametrize("spec,with_default", [
    (s, False) for s in WINDOW_SPECS] + [(("shift", -1), True),
                                         (("shift", 2), True)])
def test_window_matches_plain(cuda, spec, with_default):
    """Kernels 19, 8 and 20 over one window evaluation against the plain
    versions on the CPU: exact, but float64 frame sums (prefix sums taken
    in another order) within rel 1e-9 of the prefix magnitude."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.window import window_eval
    from datafusion_tpu_torch.physical.plan.device_sort import to_word
    rng = np.random.default_rng(20)
    n = 262_145
    words = [np.zeros(n, np.uint8), rng.integers(0, 3, n).astype(np.uint64),
             (rng.random(n) < 0.05).astype(np.uint8),
             rng.integers(0, 5000, n).astype(np.uint64)]
    valid = rng.random(n) > 0.1
    arg = None
    if spec[0] == "shift":
        arg = rng.integers(-50, 50, n).astype(np.int64)
    elif spec[0] == "agg" and spec[1] == "sum_i":
        arg = rng.integers(-10**12, 10**12, n).astype(np.int64)
    elif spec[0] == "agg" and spec[1] == "sum_f":
        arg = rng.normal(size=n)
    lanes = [arg, valid if spec[0] in ("shift", "agg") else None,
             rng.integers(0, 9, n).astype(np.int64) if with_default else None,
             rng.random(n) > 0.5 if with_default else None]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        staged = [None if x is None else torch.from_numpy(x).to(dev)
                  for x in lanes]
        before = dft.launch_counts()
        outs.append({k: v.cpu().numpy() for k, v in window_eval(
            [to_word(w).to(dev) for w in words], 2, spec, *staged).items()})
        after = dft.launch_counts()
        if dev.type == "cuda":
            for k in ("radix_sort", "gather_lanes", "window_scan"):
                assert after[k] > before[k], k
    got, want = outs
    assert set(got) == set(want)
    for key in want:
        if key == "sum" and spec[1] == "sum_f":
            scale = np.abs(np.cumsum(arg)).max()
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                       atol=1e-9 * scale)
        elif key == "data" and spec[0] == "shift":
            m = want["valid"]
            np.testing.assert_array_equal(got[key][m], want[key][m])
        else:
            np.testing.assert_array_equal(got[key], want[key])


def test_cuda_sort_and_window_end_to_end_matches_cpu(cuda):
    """ORDER BY ... LIMIT and window functions through a CUDA session and a
    CPU one, thresholds at 1: equal rows."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(5)
    n = 50_000
    data = {"g": rng.integers(0, 37, n), "v": rng.integers(0, 1000, n),
            "x": rng.normal(size=n).round(3)}
    sqls = ["SELECT g, v, x FROM t ORDER BY v DESC, x LIMIT 100",
            "SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY v) rn, "
            "rank() OVER (ORDER BY v) rk, lag(x) OVER (ORDER BY v, x) lx, "
            "sum(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN 3 "
            "PRECEDING AND CURRENT ROW) s FROM t ORDER BY g, v, rn"]
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = dft.SessionContext(dev)
        ctx.sql("SET datafusion.tpu.device_sort_min_rows = 1")
        ctx.sql("SET datafusion.tpu.device_window_min_rows = 1")
        ctx.register_arrays("t", data)
        out.append([ctx.sql(q).to_pydict() for q in sqls])
    assert out[0] == out[1]
