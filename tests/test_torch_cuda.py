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
from test_torch_window_pass import SPECS as WINDOW_SPECS_ALL

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
    day = rng.integers(8000, 10600, n).astype(np.int32)   # 1991-11 to 1999
    dic = Dictionary(np.array(["ab", "ac", "b", "ca", "d"], dtype=object))
    schema = Schema([Field("g", dt.STRING, False), Field("k", dt.INT64, True),
                     Field("v", dt.FLOAT64, True), Field("i", dt.INT32, False),
                     Field("f", dt.FLOAT32, False), Field("b", dt.BOOL, False),
                     Field("d", dt.decimal(15, 2), False),
                     Field("day", dt.DATE, False)])
    return Batch(schema, [Column(dt.STRING, g, None, dic),
                          Column(dt.INT64, k, kv), Column(dt.FLOAT64, v, vv),
                          Column(dt.INT32, i32), Column(dt.FLOAT32, f32),
                          Column(dt.BOOL, b), Column(dt.decimal(15, 2), dec),
                          Column(dt.DATE, day)], n)


QUERIES = [
    "SELECT g, k, count(*), count(v), sum(v), min(v), max(v) FROM t "
    "GROUP BY g, k",
    "SELECT g, sum(i), min(i), max(i), sum(f), min(f), max(f) FROM t "
    "WHERE b AND g LIKE 'a%' GROUP BY g",
    "SELECT k, sum(d * (1 - d)), avg(d), min(d) FROM t "
    "WHERE d >= 0.5 AND g IN ('b', 'd') GROUP BY k",
    "SELECT count(*), sum(i + 1), sum(-k) FROM t WHERE k IS NOT NULL "
    "AND (v > 0 OR v IS NULL) AND g <= 'c'",
    # the opcodes of the full lowering: CASE, `/` and `%` (zero divisors,
    # the int32 width), the _MATH functions and date_part as a key
    "SELECT g, sum(CASE WHEN k > 0 THEN v WHEN i < 0 THEN f END), "
    "sum(k / (i % 5)), sum(i % 7), sum(i / (i % 3)), sum(v / k), "
    "sum(v % 2.5), count(CASE WHEN b THEN 1 END) FROM t GROUP BY g",
    "SELECT date_part('year', day), sum(sqrt(abs(v))), sum(exp(f / 10)), "
    "sum(ln(abs(v) + 1)), sum(sin(v)), sum(floor(v)), min(ceil(f)), "
    "sum(date_part('doy', day)), max(date_part('week', day)) FROM t "
    "WHERE date_part('month', day) <> 2 GROUP BY 1",
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


def _assert_tables_equal(spec, got, want, f64_tol=(1e-12, 1e-9)):
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
            np.testing.assert_allclose(a, b, rtol=f64_tol[0], atol=f64_tol[1],
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


def _fold_edge_batch(n, seed, case):
    """An int64 key x (one key; zipf(1.3) over n / 6 keys; uniform over
    n / 2, more than any block cache holds; zipf over 100,000 keys spread
    over 2^40) beside a float64 v (NaNs and NULLs), a float32 f, an int64 i
    and a low-cardinality int64 u."""
    rng = np.random.default_rng(seed)
    if case == "one_key":
        x = np.full(n, 7, np.int64)
    elif case == "many_keys":
        x = rng.integers(0, n // 2, n)
    elif case == "wide":
        x = (rng.zipf(1.3, n) % 100_000) * (1 << 23)
    else:
        x = rng.zipf(1.3, n) % (n // 6)
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.02] = np.nan
    schema = Schema([Field("x", dt.INT64, False), Field("v", dt.FLOAT64, True),
                     Field("f", dt.FLOAT32, False), Field("i", dt.INT64, False),
                     Field("u", dt.INT64, False)])
    return Batch(schema, [
        Column(dt.INT64, x.astype(np.int64)),
        Column(dt.FLOAT64, v, rng.random(n) > 0.03),
        Column(dt.FLOAT32, (rng.normal(size=n) * 10).astype(np.float32)),
        Column(dt.INT64, rng.integers(-10**12, 10**12, n)),
        Column(dt.INT64, rng.integers(0, 50, n))], n)


_INTS = "SELECT x, count(*), sum(i), min(i), max(i) FROM t GROUP BY x"
# (id, keys, query, key bits forced or None, identity slots)
HASH_EDGES = [
    ("one key for every row", "one_key", _INTS, 20, True),
    ("zipf keys", "zipf", _INTS, None, True),
    ("more keys than a cache", "many_keys", _INTS, None, True),
    ("2^40 key space", "wide", _INTS, None, False),
    ("float min/max with NaN", "zipf", "SELECT x, count(v), min(v), max(v), "
     "sum(v) FROM t GROUP BY x", None, True),
    ("SUM_F32", "zipf", "SELECT x, sum(f), count(*) FROM t GROUP BY x", None,
     True),
    ("40 lanes in two passes", "zipf", "SELECT x, count(*), " + ", ".join(
        f"sum(i + {k})" for k in range(38)) + " FROM t GROUP BY x", None,
     True),
    ("a distinct lane", "zipf", "SELECT x, count(DISTINCT u), sum(i) FROM t "
     "GROUP BY x", None, True),
]


@pytest.mark.parametrize("case,keys,q,bits,identity", HASH_EDGES,
                         ids=[e[0] for e in HASH_EDGES])
def test_hash_fold_edges_match_plain(cuda, case, keys, q, bits, identity):
    """The warp-peer and block-cache fold against the plain version at 2^22
    rows: equal keys, counts and integer lanes, float min/max exactly,
    float sums within `_assert_tables_equal`'s bounds (another order)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        HashSpec, compact_groups, compact_groups_plain, hash_group_aggregate,
        hash_group_aggregate_plain)
    batch = _fold_edge_batch(1 << 22, 21, keys)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, q)
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    if bits is not None:
        spec = HashSpec(spec.pools, spec.pred,
                        [(p, o, bits) for p, o, _s in spec.keys], spec.lanes,
                        src.num_rows)
    assert isinstance(spec, HashSpec) and spec.identity_slots == identity
    cols, aux = node.stage(spec, src)
    n = src.num_rows
    tables = []
    for fold, compact in ((hash_group_aggregate, compact_groups),
                          (hash_group_aggregate_plain, compact_groups_plain)):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        dset = spec.distinct_set(n, cuda)
        fold(spec, cols, aux, n, table, overflow, dset=dset)
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        assert dset is None or not dset.overflowed()
        tables.append(compact(table).cpu().numpy())
    _assert_tables_equal(spec, *tables)


def test_hash_overflow_in_a_block_cache_is_flagged(cuda):
    """A table too small for its keys sets the overflow flag when the keys
    sit in the blocks' caches, so that only the caches' merges reach the
    table: 1,000 keys, each block's cache holding all it meets."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        HashSpec, hash_group_aggregate)
    n = 1 << 20
    rng = np.random.default_rng(13)
    x = rng.integers(0, 1000, n) * (1 << 30)
    batch = Batch(Schema([Field("x", dt.INT64, False)]),
                  [Column(dt.INT64, x)], n)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, "SELECT x, count(*) FROM t GROUP BY x")
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    small = HashSpec(spec.pools, spec.pred,
                     [(p, o, 40) for p, o, _s in spec.keys], spec.lanes, 100)
    assert not small.identity_slots and small.cap < 1000
    cols, aux = node.stage(small, src)
    table = small.new_table(cuda)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
    hash_group_aggregate(small, cols, aux, n, table, overflow)
    assert int(overflow.item()) == 1
    assert int((table[0] != -1).sum().item()) == small.cap


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
    # the mark pass and the copy (groups are kept)
    assert dft.launch_counts()["compact_groups"] == before + 2
    want = compact_groups_plain(table, having).cpu().numpy()
    # both keep slot order, so they agree column for column
    np.testing.assert_array_equal(got, want)
    assert 0 < got.shape[1] < int((table[0] != -1).sum())


_TILE = 4096
_CAP = 3 * _TILE + 77


def _edge_table(case, cuda):
    """A [3, cap] group table (and a slot list or None) for a compaction
    edge case: no live slot, every slot live, one live slot at a tile edge,
    2^28 slots with 1.5% live, a slot list with -1 entries ("listed"), and
    a table at an 8-byte (not 16-byte) aligned address."""
    g = torch.Generator(device=cuda).manual_seed(len(case))
    cap = 1 << 28 if case == "2^28" else _CAP
    table = torch.full((3, cap), -1, dtype=torch.int64, device=cuda)
    if case == "unaligned":
        buf = torch.full((3 * cap + 1,), -1, dtype=torch.int64, device=cuda)
        table = buf[1:].view(3, cap)
    live = {"empty": torch.zeros(cap, dtype=torch.bool, device=cuda),
            "full": torch.ones(cap, dtype=torch.bool, device=cuda)}.get(case)
    if live is None and case.startswith("slot "):
        live = torch.zeros(cap, dtype=torch.bool, device=cuda)
        live[int(case.split()[1])] = True
    if live is None:
        share = 0.015 if case == "2^28" else 0.2
        live = torch.rand(cap, generator=g, device=cuda) < share
    table[0] = torch.where(live, torch.randint(0, 1 << 40, (cap,),
                                               generator=g, device=cuda), -1)
    table[1:] = torch.randint(-1000, 1000, (2, cap), generator=g,
                              device=cuda)
    slots = None
    if case == "listed":
        slots = torch.randperm(cap, generator=g, device=cuda)[:6_000]
        slots[torch.rand(6_000, generator=g, device=cuda) < 0.1] = -1
    return table, slots


@pytest.mark.parametrize("case", [
    "empty", "full", "slot 0", f"slot {_TILE - 1}", f"slot {_TILE}",
    f"slot {3 * _TILE}", f"slot {_CAP - 1}", "sparse", "2^28", "listed",
    "unaligned"])
def test_compaction_edges_match_plain(cuda, case):
    """Kernel row 2 at tile edges against its plain version: equal column
    for column, in 2 launches (1 when nothing is kept)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, compact_groups_plain)
    table, slots = _edge_table(case, cuda)
    before = dft.launch_counts()["compact_groups"]
    got = compact_groups(table, slots=slots)
    torch.cuda.synchronize()
    want = compact_groups_plain(table, slots=slots)
    assert torch.equal(got, want)
    assert dft.launch_counts()["compact_groups"] - before == \
        (2 if want.shape[1] else 1)


def _topk_table(case, cuda):
    """A [3, cap] group table (keys, counts, the order lane at row 2) for a
    top-k edge case: every value equal, 9 live groups (k or fewer for
    k >= 10), INT64_MIN and INT64_MAX among the values, and a sparse
    2^26-slot table."""
    cap, live, seed = {"equal": (1 << 20, 300_000, 1),
                       "few": (1 << 16, 9, 2),
                       "extremes": (1 << 20, 200_000, 3),
                       "sparse": (1 << 26, 1_000_000, 4)}[case]
    rng = np.random.default_rng(seed)
    slots = rng.choice(cap, live, replace=False)
    table = np.zeros((3, cap), np.int64)
    table[0] = -1
    table[0, slots] = rng.integers(0, 2**62, live)
    table[1, slots] = rng.integers(1, 100, live)
    if case == "equal":
        lane = np.full(live, 7, np.int64)
    elif case == "extremes":
        lane = rng.integers(-2**63, 2**63 - 1, live, dtype=np.int64,
                            endpoint=True)
        pick = rng.random(live)
        lane[pick < 0.01] = np.iinfo(np.int64).min
        lane[pick > 0.99] = np.iinfo(np.int64).max
    else:
        lane = rng.zipf(1.5, live).astype(np.int64)
    table[2, slots] = lane
    return torch.from_numpy(table).to(cuda)


def _hash_topk_table(cuda):
    """A hash group table of `SELECT x, count(*) c, sum(i) s ... GROUP BY
    x` and its lane names."""
    from datafusion_tpu_torch.device.groupby import hash_group_aggregate
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
    return table, names


@pytest.mark.parametrize("case", ["hash", "equal", "few", "extremes",
                                  "sparse"])
@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("k", [1, 10, 1000, 200_000])
def test_topk_kernel_matches_plain(cuda, asc, k, case):
    """Kernel 10 on a hash table's count and sum lanes and on the edge
    cases of `_topk_table`: the order column exactly, the key set beyond
    the k-th value; TOPK_LAUNCHES launches a call."""
    if case == "hash":
        table, names = _hash_topk_table(cuda)
        lanes = (1, 2 + names.index([n for n in names
                                     if n.endswith("#s")][0]))
    else:
        table, lanes = _topk_table(case, cuda), (2,)
    for lane in lanes:
        _topk_holds(table, lane, asc, min(k, 1 << 16))


def _topk_holds(table, lane, asc, k):
    """`group_topk` against its plain version: the order column exactly,
    the key set beyond the k-th value, TOPK_LAUNCHES launches a call."""
    from datafusion_tpu_torch.device.groupby import (
        TOPK_LAUNCHES, compact_groups, group_topk, group_topk_kernel,
        group_topk_plain)
    before = group_topk_kernel.launches
    got = group_topk(table, lane, asc, k)
    assert group_topk_kernel.launches - before == TOPK_LAUNCHES
    want = group_topk_plain(table, lane, asc, k)
    assert int((got >= 0).sum()) == int((want >= 0).sum())
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


@pytest.mark.parametrize("case", ["equal", "extremes", "sparse"])
@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("k", [1, 10, 1000])
def test_topk_kernel_past_its_candidates(cuda, monkeypatch, asc, k, case):
    """Kernel 10 with more live groups than its candidate list holds
    (TOPK_CANDIDATES cut to 4,096): the rounds and the gather read the
    table instead, with the same launches and the same answer."""
    from datafusion_tpu_torch.device import groupby
    monkeypatch.setattr(groupby, "TOPK_CANDIDATES", 4096)
    table = _topk_table(case, cuda)
    assert int((table[0] != -1).sum()) > groupby.topk_candidates(
        table.shape[1], k)
    _topk_holds(table, 2, asc, k)


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
    """The first join-chain aggregate of the plan, depth first."""
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    todo = [ctx.sql(q).create_physical_plan()]
    while not isinstance(todo[-1], TorchJoinChainAggregateExec):
        node = todo.pop()
        todo += node.children()[::-1]
    return todo[-1]


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
    # two launches a build side: the range pass and the insert pass
    assert dft.launch_counts()["chain_build"] == before + 2
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


@pytest.mark.parametrize("q", [3, 4, 5, 9, 10, 12, 14, 18, 21])
def test_chain_aggregate_matches_plain(cuda, q):
    """TPC-H Q3 (hash fold), Q4 (SEMI), Q5 (five hops, a residual, a
    payload string key), Q9 (date_part key, decimal amount), Q12 and Q14
    (CASE), Q10 and Q18 (keys reduced by functional dependence: the
    representative-row lane must be equal too) and Q21 (SEMI and ANTI
    min/max membership): the kernel's group table against its plain
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


@pytest.mark.parametrize("sparse", [False, True])
def test_min_max_build_matches_plain(cuda, sparse):
    """A filtered SEMI's build: presence and each key's min and max of a
    member column with NULLs, direct and hashed, from the
    kernel and from its plain version."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.common.column import to_device
    from datafusion_tpu_torch.device.join_chain import (
        EMPTY, TAB_DIRECT, TAB_HASH, BuildSpec, chain_build,
        chain_build_plain)
    from datafusion_tpu_torch.device.lower import Pools, compile_expr
    from datafusion_tpu_torch.physical.expressions import ColumnExpr
    n = 500_000
    rng = np.random.default_rng(23)
    keys = rng.integers(0, n // 4, n) * ((1 << 30) + 1 if sparse else 1)
    member = rng.integers(-1000, 1000, n)
    mvalid = rng.random(n) > 0.1
    cols_h = [Column(dt.INT64, keys), Column(dt.INT64, member, mvalid)]
    pools = Pools()
    spec = BuildSpec(pools, None,
                     [compile_expr(ColumnExpr(0, "k", dt.INT64), pools)],
                     compile_expr(ColumnExpr(1, "m", dt.INT64), pools))
    cols = {i: to_device(cols_h[i], cuda) for i in pools.columns}
    aux = torch.zeros(0, dtype=torch.int64, device=cuda)
    before = dft.launch_counts()["chain_build"]
    got = chain_build(spec, cols, aux, n, unique=False)
    assert dft.launch_counts()["chain_build"] == before + 2
    want = chain_build_plain(spec, cols, aux, n, unique=False)
    assert got.kind == want.kind == (TAB_HASH if sparse else TAB_DIRECT)
    assert (got.los, got.his, got.live) == (want.los, want.his, want.live)

    def by_key(t):
        if t.keys is None:
            slots = (t.rows >= 0).nonzero().squeeze(1)
            k = slots
        else:
            slots = (t.keys != EMPTY).nonzero().squeeze(1)
            k = t.keys[slots]
        order = k.argsort()
        return (k[order].cpu().numpy(), t.mn[slots][order].cpu().numpy(),
                t.mx[slots][order].cpu().numpy())
    for a, b in zip(by_key(got), by_key(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("build", ["inner", "inner-dup", "presence",
                                   "minmax"])
@pytest.mark.parametrize("case", ["sorted", "shuffled", "unique", "warps"])
@pytest.mark.parametrize("wide", [False, True], ids=["direct", "hashed"])
def test_build_peers_match_plain(cuda, build, case, wide):
    """The insert's warp peers on every build kind: keys in runs of 1-7
    rows (as lineitem's orders), the same keys shuffled, unique keys (the
    blocks give matching up), and keys whose rows straddle two warps' steps
    or sit inside one warp; INNER (the duplicate flag, and each key's row
    where keys are unique), presence (any row of the key) and min/max (the
    extremes), direct and hashed; two launches a build."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.join_chain import (
        TAB_DIRECT, TAB_HASH, chain_build, chain_build_plain)
    from test_torch_build_peers import _keys, _spec
    n = 300_001
    rng = np.random.default_rng(31)
    if case == "warps":
        keys = np.arange(n, dtype=np.int64) * 2
        keys[30:34] = keys[30]           # rows 30-33: two warps' steps
        keys[70:74] = keys[70]           # rows 70-73: one warp's step
    else:
        keys = _keys(case, n, rng)
    if build == "inner-dup" and case == "unique":
        keys[1::5] = keys[::5][:len(keys[1::5])]
    member = rng.integers(-1000, 1000, n) if build == "minmax" else None
    spec, cols, aux = _spec(n, keys, member, rng.random(n) > 0.05, wide)
    cols = {i: (d.to(cuda), None if v is None else v.to(cuda))
            for i, (d, v) in cols.items()}
    aux = aux.to(cuda)
    unique = build.startswith("inner")
    before = dft.launch_counts()["chain_build"]
    got = chain_build(spec, cols, aux, n, unique)
    assert dft.launch_counts()["chain_build"] == before + 2
    want = chain_build_plain(spec, cols, aux, n, unique)
    assert got.kind == want.kind == (TAB_HASH if wide else TAB_DIRECT)
    assert (got.los, got.his, got.live, got.duplicate) == \
        (want.los, want.his, want.live, want.duplicate)
    gk, gr = got.entries()
    wk, wr = want.entries()
    np.testing.assert_array_equal(gk, wk)
    if unique and not want.duplicate:
        np.testing.assert_array_equal(gr, wr)
    # every kept row is a row of its key
    packed = (cols[0][0].cpu().numpy() - got.los[0]) << got.shifts[0]
    np.testing.assert_array_equal(packed[gr], gk)
    if build == "minmax":
        for a, b in zip(got.extremes(), want.extremes()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [7, 8, 9, 10, 12, 14, 18, 21])
def test_cuda_full_lowering_end_to_end_matches_cpu(cuda, q):
    from datafusion_tpu_torch.tpch.queries import QUERIES
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = _tpch_ctx(dev, 0.05)
        out.append(ctx.sql(QUERIES[q]).to_pydict())
        assert _chain_exec(ctx, QUERIES[q]).fallbacks == 0
    assert list(out[0]) == list(out[1])
    for name in out[1]:
        for a, b in zip(out[0][name], out[1][name]):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9), (q, name)
            else:
                assert a == b, (q, name)


def test_cuda_join_chain_end_to_end_matches_cpu(cuda):
    from datafusion_tpu_torch.tpch.queries import QUERIES
    for q in (3, 4, 5):
        out = []
        for dev in (cuda, torch.device("cpu")):
            ctx = _tpch_ctx(dev, 0.05)
            out.append(ctx.sql(QUERIES[q]).to_pydict())
            assert _chain_exec(ctx, QUERIES[q]).fallbacks == 0
        assert out[0] == out[1], q


def _words(n, seed, shape="mixed"):
    """Order words of a sort. "mixed": every kind a sort meets, a uint8
    null rank, a uint64 key over the whole range (both extremes), a uint64
    key with many ties, an all-zero rank; "skewed": a uint64 word whose
    every row holds one value but a handful (tiles whose counts are 0 for
    the other digits), under a rank; "all_bytes": a uint64 word whose
    eight bytes all vary; "bytes_only": three uint8 words."""
    rng = np.random.default_rng(seed)
    if shape == "skewed":
        word = np.full(n, 0x0123456789ABCDEF, np.uint64)
        odd = rng.choice(n, min(n, 5), replace=False)
        word[odd] = rng.integers(0, 2**64 - 1, len(odd), dtype=np.uint64,
                                 endpoint=True)
        return [(rng.random(n) < 0.5).astype(np.uint8), word]
    if shape == "all_bytes":
        return [rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                             endpoint=True)]
    if shape == "bytes_only":
        return [rng.integers(0, 256, n).astype(np.uint8),
                rng.integers(0, 3, n).astype(np.uint8),
                rng.integers(0, 256, n).astype(np.uint8)]
    full = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    full[: min(n, 2)] = [np.uint64(2**64 - 1), np.uint64(0)][: min(n, 2)]
    return [(rng.random(n) < 0.3).astype(np.uint8),
            rng.integers(0, 7, n).astype(np.uint64),
            np.zeros(n, np.uint8), full]


@pytest.mark.parametrize("shape", ["mixed", "skewed", "all_bytes",
                                   "bytes_only"])
@pytest.mark.parametrize("n", [1, 2, 4097, 300_000, 3_000_017,
                               (1 << 22) + 1])
@pytest.mark.parametrize("limit", [None, 10])
def test_radix_sort_matches_plain(cuda, n, limit, shape):
    """Kernel 19: the permutation equals its plain version's and
    np.lexsort's, ties in row order, limits included, across many tiles;
    the launches are the design's (a histogram a word, a pass a varying
    byte, a gather a later word)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain, sort_launch_count, to_word)
    host = _words(n, n, shape)
    words = [to_word(w).to(cuda) for w in host]
    before = dft.launch_counts()["radix_sort"]
    got = radix_sort(words, limit).cpu().numpy()
    assert dft.launch_counts()["radix_sort"] - before == \
        sort_launch_count(host)
    want = radix_sort_plain(words, limit).cpu().numpy()
    lex = np.lexsort(tuple(reversed(host)))[:limit]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lex)


def test_gather_lanes_matches_plain(cuda):
    """Kernel 8: every lane dtype, more lanes than one launch takes, and an
    index list with repeats (not a permutation)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        gather_plan, reorder_rows, reorder_rows_plain)
    rng = np.random.default_rng(8)
    n = 100_003
    kinds = [np.uint8, np.bool_, np.int16, np.int32, np.int64, np.float32,
             np.float64]
    lanes = [torch.from_numpy(
        (rng.integers(0, 255, n) if k not in (np.float32, np.float64)
         else rng.normal(size=n)).astype(k)).to(cuda)
        for k in kinds * 6]
    # 168 B a row: a 128-B record and a 40-B one (padded to 64); the
    # permutation packs both (2 launches each), 5000 indices move both
    # directly (1 each)
    for order, launches in ((rng.permutation(n), 4),
                            (rng.integers(0, n, 5000), 2)):
        o = torch.from_numpy(order.astype(np.int64)).to(cuda)
        plan = gather_plan([t.element_size() for t in lanes], len(order), n)
        assert sum(g.launches for g in plan) == launches
        before = dft.launch_counts()["gather_lanes"]
        got = reorder_rows(o, lanes)
        assert dft.launch_counts()["gather_lanes"] == before + launches
        for g, w in zip(got, reorder_rows_plain(o, lanes)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)


@pytest.mark.parametrize("widths", [
    [1, 8, 1, 8], [1, 2, 4, 8, 2, 1, 4], [1, 1], [2, 2], [4, 2, 2],
    [8] * 11 + [4], [8] * 17 + [4, 2, 1], [4]])
@pytest.mark.parametrize("kind", ["permutation", "short", "repeats"])
def test_gather_modes_match_plain(cuda, widths, kind):
    """Kernel row 8 in both modes, every record width the plan makes
    (2, 4, 8, 16, 32 (W1's 18 B), 96 and 128 B; 64 above): equal to
    `reorder_rows_plain`, in the launches `gather_plan` predicts."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        gather_plan, reorder_rows, reorder_rows_plain)
    rng = np.random.default_rng(len(widths) * 3 + len(kind))
    n = 1_000_003
    kinds = {1: np.uint8, 2: np.int16, 4: np.float32, 8: np.int64}
    lanes = [torch.from_numpy(rng.integers(0, 127, n).astype(kinds[w])
                              ).to(cuda) for w in widths]
    order = {"permutation": rng.permutation(n),
             "short": rng.integers(0, n, n // 40),
             "repeats": rng.integers(0, n, n + 5)}[kind]
    o = torch.from_numpy(order.astype(np.int64)).to(cuda)
    plan = gather_plan(widths, len(order), n)
    before = dft.launch_counts()["gather_lanes"]
    got = reorder_rows(o, lanes)
    torch.cuda.synchronize()
    assert dft.launch_counts()["gather_lanes"] - before == \
        sum(g.launches for g in plan)
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


@pytest.mark.parametrize("layout", ["runs", "single", "whole"])
@pytest.mark.parametrize("spec", WINDOW_SPECS_ALL, ids=str)
def test_window_pass_edges_match_plain(cuda, spec, layout):
    """Kernel 20 alone over sorted rows: every function kind and frame
    bound, with partitions of one row each, one partition of the whole
    input, and runs of up to 40 rows, over 2048 x 97 + 1 rows (tiles of
    2,048 rows, the last of one row), against its plain version on the
    same card; its launches as `scan_launches` predicts. Exact, but float64
    frame sums (the tiles' prefix sums add in another order) within rel
    1e-9 of the prefix magnitude."""
    import datafusion_tpu_torch as dft
    from test_torch_window_pass import _lanes, _words
    from datafusion_tpu_torch.device.window import (
        scan_launches, window_scan, window_scan_plain)
    n = 2048 * 97 + 1
    rng = np.random.default_rng(len(layout))
    words = [w.to(cuda) for w in _words(n, layout, rng)]
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    lanes = [None if x is None else x.to(cuda) for x in _lanes(spec, n, rng)]
    before = dft.launch_counts()["window_scan"]
    got = window_scan(words, 2, perm, spec, *lanes)
    assert dft.launch_counts()["window_scan"] - before == scan_launches(spec)
    want = window_scan_plain(words, 2, perm, spec, *lanes)
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].cpu().numpy(), want[key].cpu().numpy()
        if key == "sum" and spec[1] == "sum_f":
            scale = np.abs(np.cumsum(lanes[0].cpu().numpy())).max()
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * scale)
        else:
            np.testing.assert_array_equal(g, w)


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


# --- staging-time composition and folding: chain_compose, chain_fold -------

def _compose_and_fold_vs_plain(ex, tctx):
    """The chain exec `ex`'s staging (`stage_spec`, every payload column of
    a folded hop held) through `chain_stage` (one compose launch and one
    fold launch, into outputs filled with garbage) and through
    `chain_stage_plain`, equal, and the exec's staged words equal to them.
    Returns the compositions and folds checked."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.join_chain import (
        chain_stage, chain_stage_plain, new_stage_outputs)
    staged = ex.stage_builds(tctx)
    made = ex.stage_spec(staged)
    if made is None:
        return 0
    spec, cols, aux = made
    words, folds = new_stage_outputs(spec, aux.device)
    for t in list(words.values()) + [t for f in folds for t in f
                                     if t is not None]:
        t.fill_(-7 if t.dtype == torch.int64 else 0x5A)
    names = ("chain_compose", "chain_fold")
    before = {k: dft.launch_counts()[k] for k in names}
    chain_stage(spec, cols, aux, words, folds)
    assert {k: dft.launch_counts()[k] - before[k] for k in names} == {
        "chain_compose": int(bool(spec.composed)),
        "chain_fold": int(bool(spec.folds))}
    want_w, want_f = new_stage_outputs(spec, aux.device)
    chain_stage_plain(spec, cols, aux, want_w, want_f)
    torch.cuda.synchronize()
    for o, w in want_w.items():
        assert torch.equal(words[o], w)
    for got, want in zip(folds, want_f):
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    for s in staged:
        if s.compose is not None:
            assert torch.equal(s.compose.words, words[s.compose.owner])
    return len(spec.composed) + len(spec.folds)


@pytest.mark.parametrize("q", [2, 5, 7, 8, 9, 10, 14, 18, 21])
def test_tpch_compose_and_fold_match_plain(cuda, q):
    """TPC-H's composed and folded chains at SF 0.1 (Q2 as its
    row-returning chain): each composition and fold from its kernel equals
    its plain version, exactly."""
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchChainExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = _tpch_ctx(cuda, 0.1)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")

    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)
    execs = [n for n in walk(ctx.sql(QUERIES[q]).create_physical_plan())
             if isinstance(n, TorchChainExec)]
    assert sum(_compose_and_fold_vs_plain(ex, ctx.task_context())
               for ex in execs) >= 1


def _compose_ctx(device):
    """A spine `f`, an owner `d` whose `ek` has NULLs and keys outside its
    dimensions' ranges, a dimension `e` keyed by `ek`, a hashed one `h`
    keyed by `hk`, a member table `m`."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(12)
    nf, nd, ne = 400_000, 5000, 300
    ek = rng.integers(-20, ne + 20, nd)
    hid = rng.choice(1 << 40, ne, replace=False)
    ctx = dft.SessionContext(device)
    ctx.register_arrays("f", {"k": rng.integers(0, nd, nf),
                              "v": rng.integers(0, 100, nf),
                              "s": rng.integers(0, 12, nf)})
    ctx.register_table("d", dft.MemTable.from_batches([Batch(
        Schema([Field("id", dt.INT64, False), Field("ek", dt.INT64, True),
                Field("flag", dt.INT64, False), Field("hk", dt.INT64, False)]),
        [Column(dt.INT64, np.arange(nd)),
         Column(dt.INT64, ek, rng.random(nd) > 0.1),
         Column(dt.INT64, rng.integers(0, 5, nd)),
         Column(dt.INT64, rng.choice(hid, nd))], nd)]))
    ctx.register_arrays("e", {"id": np.arange(ne),
                              "w": rng.integers(0, 6, ne)})
    ctx.register_arrays("h", {"id": hid, "w": rng.integers(0, 6, ne)})
    ctx.register_arrays("m", {"k": rng.integers(0, ne, 3000),
                              "s": rng.integers(0, 12, 3000)})
    return ctx


COMPOSE_SQL = [
    "SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
    "JOIN e ON d.ek = e.id WHERE d.flag > 1 GROUP BY e.w",
    "SELECT h.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
    "JOIN h ON d.hk = h.id GROUP BY h.w",
    "SELECT d.flag, count(*) c FROM f JOIN d ON f.k = d.id WHERE NOT EXISTS "
    "(SELECT 1 FROM e WHERE e.id = d.ek AND e.w > 2) GROUP BY d.flag",
    "SELECT d.flag, count(*) c FROM f JOIN d ON f.k = d.id WHERE EXISTS "
    "(SELECT 1 FROM m WHERE m.k = d.ek AND m.s < f.s) GROUP BY d.flag",
]


@pytest.mark.parametrize("sql", COMPOSE_SQL)
def test_composed_walk_matches_plain(cuda, sql):
    """NULL and out-of-range owner keys with dropped owner rows, a hashed
    composed hop, an ANTI and a min/max composed hop: the compositions and
    folds, then `chain_aggregate` over the composed and folded chain, from
    the kernels equal their plain versions; the query equals the CPU's."""
    from datafusion_tpu_torch.device.groupby import (AggregateSpec,
                                                     compact_groups,
                                                     dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        chain_aggregate, chain_aggregate_plain)
    ctx = _compose_ctx(cuda)
    ex = _chain_exec(ctx, sql)
    assert _compose_and_fold_vs_plain(ex, ctx.task_context()) >= 2
    spec, _plan, _names, _slots, inputs, _staged = ex.prepare(
        ctx.task_context())
    assert any(h.compose is not None for h in spec.chain.hops)
    ((cols, aux, rows),) = inputs
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        fold(spec, cols, aux, rows, table, overflow)
        if isinstance(spec, AggregateSpec):
            table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in tables)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > 0
    on_card = ctx.sql(sql).to_pydict()
    assert ex.fallbacks == 0
    assert on_card == _compose_ctx(torch.device("cpu")).sql(sql).to_pydict()


# --- the row-returning chain and the resident emit: chain_rows, group_emit ---

def _rows_exec(ctx, q):
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainRowsExec)

    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)
    return [n for n in walk(ctx.sql(q).create_physical_plan())
            if isinstance(n, TorchJoinChainRowsExec)]


def _star_ctx(device, n):
    """A spine of `n` rows with NULL keys, two INNER hops (the second's
    payload a dictionary string), all on `device`, row chains on at 1."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(8)
    ctx = dft.SessionContext(device)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    k1 = rng.integers(0, 320, n)
    ctx.register_table("fact", dft.MemTable.from_batches([Batch(
        Schema([Field("k1", dt.INT64, True), Field("q", dt.INT64, False),
                Field("v", dt.FLOAT64, False)]),
        [Column(dt.INT64, k1, rng.random(n) > 0.1),
         Column(dt.INT64, rng.integers(0, 1000, n)),
         Column(dt.FLOAT64, rng.normal(size=n))], n)]))
    ctx.register_arrays("d1", {"id": np.arange(300),
                               "k2": rng.integers(0, 40, 300),
                               "w": rng.integers(1, 100, 300)})
    ctx.register_arrays("d2", {"id": np.arange(40), "name": np.array(
        [f"g{i % 7}" for i in range(40)], object)})
    return ctx


ROWS_SQL = ("SELECT f.q, f.v, d1.w, d2.name FROM fact f "
            "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
            "WHERE f.q > d1.w * 3 AND f.k1 IN (SELECT id FROM d1 WHERE w > 20)")


@pytest.mark.parametrize("n", [4097, 300_000])
def test_chain_rows_matches_plain(cuda, n):
    """INNER and SEMI hops, NULL probe keys, a residual, a float and a
    dictionary output: the kernel's columns equal its plain version's, at
    a spine that is not a multiple of the block."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.join_chain import (chain_rows,
                                                        chain_rows_plain)
    ctx = _star_ctx(cuda, n)
    (ex,) = _rows_exec(ctx, ROWS_SQL)
    spec, inputs, _staged = ex.prepare_rows(ctx.task_context())
    ((cols, aux, rows, _view),) = inputs
    before = dft.launch_counts()["chain_rows"]
    got = chain_rows(spec, cols, aux, rows)
    # the tile walk, then the emit
    assert dft.launch_counts()["chain_rows"] == before + 2
    want = chain_rows_plain(spec, cols, aux, rows)
    torch.cuda.synchronize()
    assert got[0][0].numel() > 0
    for (gd, gv), (wd, wv) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.device.type == "cuda"
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


@pytest.mark.parametrize("n", [31, 311, 2049, 4097, 300_001, 3_000_001])
def test_chain_rows_scratch_and_tiles(cuda, n):
    """Spines within one warp's rows, within one block's tile (311 rows: two
    warps' of 256), of two and three tiles (a block's tile is 8 x 256
    rows), of 147 tiles and of 1,465 (more than the card's blocks take at
    once, so blocks take several tiles by ticket): two launches, into a
    survivor scratch of an entry a spine row; the rows equal the plain
    version's in spine order."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device import join_chain
    ctx = _star_ctx(cuda, n)
    (ex,) = _rows_exec(ctx, ROWS_SQL)
    spec, inputs, _staged = ex.prepare_rows(ctx.task_context())
    ((cols, aux, rows, _view),) = inputs
    before = dft.launch_counts()["chain_rows"]
    got = join_chain.chain_rows(spec, cols, aux, rows)
    launched = dft.launch_counts()["chain_rows"] - before
    want = join_chain.chain_rows_plain(spec, cols, aux, rows)
    torch.cuda.synchronize()
    kept = want[0][0].numel()
    assert kept > 0
    assert launched == 2
    for (gd, gv), (wd, wv) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


def test_chain_rows_all_and_none_survive(cuda):
    """Every spine row surviving (one hop that all rows find) and none
    (a predicate nothing passes): one walk and the emit, or the walk
    alone, equal to the plain version."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.join_chain import (chain_rows,
                                                        chain_rows_plain)
    rng = np.random.default_rng(3)
    n = 70_001
    ctx = dft.SessionContext(cuda)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    ctx.register_arrays("f", {"k": rng.integers(0, 50, n),
                              "v": rng.integers(0, 100, n)})
    ctx.register_arrays("d", {"id": np.arange(50),
                              "w": rng.integers(0, 9, 50)})
    for pred, survive in (("f.v >= 0", n), ("f.v < 0", 0)):
        (ex,) = _rows_exec(ctx, "SELECT f.v, d.w FROM f JOIN d ON "
                                f"f.k = d.id WHERE {pred}")
        spec, inputs, _staged = ex.prepare_rows(ctx.task_context())
        ((cols, aux, rows, _view),) = inputs
        before = dft.launch_counts()["chain_rows"]
        got = chain_rows(spec, cols, aux, rows)
        assert dft.launch_counts()["chain_rows"] - before == \
            1 + (survive > 0)
        want = chain_rows_plain(spec, cols, aux, rows)
        assert want[0][0].numel() == survive
        for (gd, gv), (wd, wv) in zip(got, want):
            assert torch.equal(gd, wd) and torch.equal(gv, wv)


def test_staging_one_launch_each_one_sync(cuda):
    """Staging a chain with composed hops and a fold (`stage_builds`, its
    tables already cached on the card): at most one compose launch, one
    fold launch and one synchronisation (torch's sync debug mode) beyond
    the tables' own staging."""
    import warnings
    import datafusion_tpu_torch as dft
    ctx = _compose_ctx(cuda)
    ex = _chain_exec(ctx, COMPOSE_SQL[0])
    tctx = ctx.task_context()
    staged = ex.stage_builds(tctx)
    assert any(s.compose is not None for s in staged)
    assert any(s.fold is not None for s in staged)

    def count(compose):
        names = ("chain_compose", "chain_fold")
        before = {k: dft.launch_counts()[k] for k in names}
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ex.stage_builds(tctx, compose)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return ({k: dft.launch_counts()[k] - before[k] for k in names},
                sum(str(w.message).startswith("called a synchronizing")
                    for w in seen))
    launches, syncs = count(True)
    plain_launches, plain_syncs = count(False)
    assert launches == {"chain_compose": 1, "chain_fold": 1}
    assert plain_launches == {"chain_compose": 0, "chain_fold": 0}
    assert syncs - plain_syncs <= 1


@pytest.mark.parametrize("q", [2, 20])
def test_tpch_chain_rows_matches_plain(cuda, q):
    """TPC-H Q2's and Q20's row-returning chains at SF 0.1: the kernel
    against its plain version on the same staged builds and spine."""
    from datafusion_tpu_torch.device.join_chain import (chain_rows,
                                                        chain_rows_plain)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = _tpch_ctx(cuda, 0.1)
    ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    for ex in _rows_exec(ctx, QUERIES[q]):
        spec, inputs, _staged = ex.prepare_rows(ctx.task_context())
        for cols, aux, rows, _view in inputs:
            got = chain_rows(spec, cols, aux, rows)
            want = chain_rows_plain(spec, cols, aux, rows)
            for (gd, gv), (wd, wv) in zip(got, want):
                assert torch.equal(gd, wd) and torch.equal(gv, wv)


@pytest.mark.parametrize("ng", [1, 4097, 300_000])
def test_group_emit_matches_plain(cuda, ng):
    """Unpacked keys (a signed offset, a dictionary code, NULLs), counts and
    sums with their validity: the kernel against its plain version."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        EMIT_COUNT, EMIT_DICT, EMIT_KEY, EMIT_SUM, EmitField,
        group_emit_columns, group_emit_columns_plain)
    rng = np.random.default_rng(ng)
    a = rng.integers(0, 1 << 20, ng)
    b = rng.integers(0, 9, ng)
    c = rng.integers(0, 1 << 30, ng)
    packed = a | (b << 20) | (c << 24)
    cnt = rng.integers(0, 3, ng)
    groups = torch.from_numpy(np.stack([
        packed, cnt, rng.integers(-10**12, 10**12, ng), cnt])).to(cuda)
    fields = [EmitField(EMIT_KEY, torch.int64, 0, 0, 20, -(1 << 19)),
              EmitField(EMIT_DICT, torch.int32, 0, 20, 4),
              EmitField(EMIT_KEY, torch.int32, 0, 24, 30, 7),
              EmitField(EMIT_COUNT, torch.int64, 1),
              EmitField(EMIT_SUM, torch.int64, 2, count_row=3)]
    before = dft.launch_counts()["group_emit"]
    got = group_emit_columns(groups, fields)
    assert dft.launch_counts()["group_emit"] == before + 1
    want = group_emit_columns_plain(groups, fields)
    torch.cuda.synchronize()
    for (gd, gv), (wd, wv) in zip(got, want):
        assert gd.dtype == wd.dtype and torch.equal(gd, wd)
        assert (gv is None) == (wv is None)
        assert gv is None or torch.equal(gv, wv)


def test_cuda_join_rows_end_to_end_matches_cpu(cuda):
    """TPC-H Q2, Q13 and Q20 through a CUDA session and a CPU one, the
    row-returning threshold at 1: equal rows, no fallback."""
    from datafusion_tpu_torch.tpch.queries import QUERIES
    for q in (2, 13, 20):
        out = []
        for dev in (cuda, torch.device("cpu")):
            ctx = _tpch_ctx(dev, 0.05)
            ctx.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
            out.append(ctx.sql(QUERIES[q]).to_pydict())
            execs = _rows_exec(ctx, QUERIES[q])
            assert all(e.fallbacks == 0 for e in execs)
            assert bool(execs) == (q != 13)
        assert out[0] == out[1], q


# --- count(DISTINCT x), lanes past 32 and the fanout-N join-aggregate ---------

def _distinct_table(n, seed):
    """Keys `g` (1,000) and `g8` (6), and distinct arguments of each kind:
    int32 with NULLs, int64, date, decimal, float32 and float64 with -0.0,
    0.0 and NaN, and `v` for sums."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, 3.0, np.nan]), n)
    cols = [("g", dt.INT64, rng.integers(0, 1000, n), None),
            ("g8", dt.INT32, rng.integers(0, 6, n).astype(np.int32), None),
            ("i32", dt.INT32, rng.integers(-50, 50, n).astype(np.int32),
             rng.random(n) > 0.1),
            ("i64", dt.INT64, rng.integers(-2**40, 2**40, n), None),
            ("day", dt.DATE, rng.integers(8000, 8060, n).astype(np.int32),
             None),
            ("dec", dt.decimal(12, 2), rng.integers(-300, 300, n), None),
            ("f32", dt.FLOAT32, f.astype(np.float32), None),
            ("f64", dt.FLOAT64, f * 0.1, rng.random(n) > 0.1),
            ("v", dt.INT64, rng.integers(0, 100, n), None)]
    schema = Schema([Field(nm, t, v is not None) for nm, t, _d, v in cols])
    return Batch(schema, [Column(t, np.asarray(d), v)
                          for _nm, t, d, v in cols], n)


_ARGS = ("i32", "i64", "day", "dec", "f32", "f64")
DISTINCT_QUERIES = [
    "SELECT g8, " + ", ".join(f"count(DISTINCT {a})" for a in _ARGS) +
    ", sum(v) FROM t GROUP BY g8",
    "SELECT g, " + ", ".join(f"count(DISTINCT {a})" for a in _ARGS) +
    ", count(*) FROM t GROUP BY g",
    # 65 lanes: three passes
    "SELECT g, " + ", ".join(f"sum(v + {i})" for i in range(32)) +
    ", count(*) FROM t GROUP BY g",
    "SELECT g8, count(DISTINCT i64), " +
    ", ".join(f"sum(v + {i})" for i in range(32)) + " FROM t GROUP BY g8",
]


def _pair_keys(dset, host_table, dense):
    """The distinct set's pairs as (group key, lane, value)."""
    pairs = dset.pairs().cpu()
    slot, lane = pairs[:, 0] >> 12, pairs[:, 0] & 4095
    key = slot if dense else torch.from_numpy(host_table[0])[slot]
    return sorted(zip(key.tolist(), lane.tolist(), pairs[:, 1].tolist()))


@pytest.mark.parametrize("q", DISTINCT_QUERIES)
def test_distinct_and_pass_kernels_match_plain(cuda, q):
    """The dense and hash kernels with distinct lanes and lanes in passes
    against their plain versions on the same device tensors: equal group
    tables and equal distinct pairs; one launch a pass."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups, dense_group_aggregate,
        dense_group_aggregate_plain, dense_group_table, hash_group_aggregate,
        hash_group_aggregate_plain)
    batch = _distinct_table(300_000, 5)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, q)
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    cols, aux = node.stage(spec, src)
    dense = isinstance(spec, AggregateSpec)
    name = "fused_dense_aggregate" if dense else "hash_group_aggregate"
    folds = (dense_group_aggregate, dense_group_aggregate_plain) if dense \
        else (hash_group_aggregate, hash_group_aggregate_plain)
    tables, pairs = [], []
    for fold in folds:
        table = spec.new_table(cuda)
        dset = spec.distinct_set(src.num_rows, cuda)
        before = dft.launch_counts()[name]
        if dense:
            fold(spec, cols, aux, src.num_rows, table, dset=dset)
            table = dense_group_table(table)
        else:
            overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
            fold(spec, cols, aux, src.num_rows, table, overflow, dset=dset)
            assert int(overflow.item()) == 0
        assert dft.launch_counts()[name] == before + (
            len(spec.passes) if fold is folds[0] else 0)
        torch.cuda.synchronize()
        host = compact_groups(table).cpu().numpy()
        tables.append(host)
        if dset is not None:
            assert not dset.overflowed()
            pairs.append(_pair_keys(dset, table.cpu().numpy(), False))
    _assert_tables_equal(spec, *tables)
    if pairs:
        assert pairs[0] == pairs[1] and pairs[0]


def test_chain_distinct_matches_plain(cuda):
    """TPC-H Q5 with count(DISTINCT o_custkey) at SF 0.1: the chain walk's
    distinct lane against its plain version."""
    from datafusion_tpu_torch.device.groupby import (AggregateSpec,
                                                     compact_groups,
                                                     dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        chain_aggregate, chain_aggregate_plain)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    q = QUERIES[5].replace("as revenue", "as revenue, count(distinct "
                           "o_custkey) as customers")
    ctx = _tpch_ctx(cuda, 0.1)
    ex = _chain_exec(ctx, q)
    spec, _plan, _names, _slots, inputs, _staged = ex.prepare(
        ctx.task_context())
    ((cols, aux, rows),) = inputs
    assert spec.distinct_lanes
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        dset = spec.distinct_set(rows, cuda)
        fold(spec, cols, aux, rows, table, overflow, dset=dset)
        torch.cuda.synchronize()
        if isinstance(spec, AggregateSpec):
            table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
    _assert_tables_equal(spec, *tables)


def _join_ctx(device):
    """partsupp and lineitem at SF 0.1, and a build of fanouts 0, 1 and 4
    with a hot key of 1,000 rows against 300,000 probe rows, NULL keys on
    both sides."""
    ctx = _tpch_ctx(device, 0.1)
    rng = np.random.default_rng(9)
    keys = [k for k in range(2100) for _ in range((0, 1, 4)[k % 3])]
    keys += [5000] * 1000
    nb = len(keys)
    bkv = rng.random(nb) > 0.01
    n = 300_000
    pk = rng.integers(0, 2200, n)
    pk[rng.random(n) < 0.01] = 5000
    b = Batch(Schema([Field("bk", dt.INT64, True), Field("bg", dt.INT32, False),
                      Field("bd", dt.decimal(12, 2), False)]),
              [Column(dt.INT64, np.asarray(keys, np.int64), bkv),
               Column(dt.INT32, rng.integers(0, 300, nb).astype(np.int32)),
               Column(dt.decimal(12, 2), rng.integers(0, 10**5, nb))], nb)
    p = Batch(Schema([Field("pk", dt.INT64, True), Field("px", dt.INT64, False),
                      Field("pf", dt.FLOAT64, False)]),
              [Column(dt.INT64, pk, rng.random(n) > 0.05),
               Column(dt.INT64, rng.integers(0, 1000, n)),
               Column(dt.FLOAT64, rng.normal(size=n))], n)
    import datafusion_tpu_torch as dft
    ctx.register_table("b", dft.MemTable(b.schema, [[b]]))
    ctx.register_table("p", dft.MemTable(p.schema, [[p]]))
    return ctx


JOIN_QUERIES = [
    "SELECT ps_suppkey, count(*), sum(ps_supplycost * l_quantity) "
    "FROM lineitem JOIN partsupp ON l_partkey = ps_partkey "
    "GROUP BY ps_suppkey",
    "SELECT ps_suppkey, sum(l_extendedprice * (1 - l_discount) - "
    "ps_supplycost * l_quantity) FROM lineitem JOIN partsupp "
    "ON ps_partkey = l_partkey AND ps_suppkey = l_suppkey GROUP BY ps_suppkey",
    "SELECT b.bg, count(*), sum(p.px * b.bd), sum(p.pf), min(p.px), "
    "max(b.bd) FROM p JOIN b ON p.pk = b.bk WHERE p.px + b.bg > 100 "
    "GROUP BY b.bg",
    "SELECT p.px < 500, count(*), sum(p.pf), max(p.pf) FROM p JOIN b "
    "ON p.pk = b.bk GROUP BY p.px < 500",
]


def _join_exec(ctx, q):
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    todo = [ctx.sql(q).create_physical_plan()]
    while not isinstance(todo[-1], TorchJoinAggregateExec):
        node = todo.pop()
        todo += node.children()[::-1]
    return todo[-1]


def _join_vs_plain(ctx, cuda, q):
    """`join_build` and `join_aggregate` against their plain versions on
    the query's inputs: the same entries a bucket, and equal group tables
    (float64 sums within rel 1e-9, abs 1e-6: the atomics' order). Returns
    (spec, group table)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups, dense_group_table)
    from datafusion_tpu_torch.device.join_agg import (
        join_aggregate, join_aggregate_plain, join_build, join_build_plain)
    from datafusion_tpu_torch.physical.plan.base import (collect_batch,
                                                         execute_stream)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        _PairView)
    ex = _join_exec(ctx, q)
    tctx = ctx.task_context()
    lowered = ex.lower()
    bb = collect_batch(ex.build_source, tctx)
    bspec, bcols, baux = ex.build_input(lowered, bb)
    before = dft.launch_counts()["join_build"]
    got_t = join_build(bspec, bcols, baux, bb.num_rows)
    assert dft.launch_counts()["join_build"] == before + 6
    want_t = join_build_plain(bspec, bcols, baux, bb.num_rows)
    torch.cuda.synchronize()
    assert (got_t.nb, got_t.live) == (want_t.nb, want_t.live)
    assert got_t.start.dtype == torch.int32
    assert torch.equal(got_t.start, want_t.start)
    for a, b in zip(got_t.entries(), want_t.entries()):
        np.testing.assert_array_equal(a, b)
    probe = [b for b in execute_stream(ex.probe_source, tctx) if b.num_rows]
    views = [_PairView(list(bb.columns) + list(pb.columns), pb.num_rows)
             for pb in probe]
    spec, _plan, _names, _sm = ex.compile_join(lowered, got_t, views)
    tables = []
    for fold in (join_aggregate, join_aggregate_plain):
        table = spec.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        for pb, view in zip(probe, views):
            cols, aux = ex.stage_pair(spec, bb, pb, view)
            fold(spec, cols, aux, pb.num_rows, table, overflow)
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        if isinstance(spec, AggregateSpec):
            table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
    _assert_tables_equal(spec, *tables, f64_tol=(1e-9, 1e-6))
    return spec, tables[0]


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_join_kernels_match_plain(cuda, q):
    """`join_build` against `join_build_plain` (the int32 bucket starts and
    the multiset of (row, record) a bucket), then `join_aggregate` over the
    kernel's table against `join_aggregate_plain` (equal group tables;
    float64 sums within rel 1e-9 and abs 1e-6: a group here sums up to
    1.7M pairs, whose partial sums reach about 1e3, in the atomics'
    order)."""
    _join_vs_plain(_join_ctx(cuda), cuda, q)


def test_cuda_distinct_and_join_end_to_end_matches_cpu(cuda):
    """count(DISTINCT x), 65 lanes and the join-aggregate through a CUDA
    session and a CPU session: the same rows, no fallback."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    batch = _distinct_table(200_000, 6)
    qs = DISTINCT_QUERIES + JOIN_QUERIES
    out = []
    for dev in (cuda, torch.device("cpu")):
        ctx = _join_ctx(dev)
        ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
        rows = []
        for q in qs:
            q = q + " ORDER BY 1"
            rows.append(ctx.sql(q).to_pydict())
            node = ctx.sql(q).create_physical_plan()
            todo = [node]
            while todo:
                n = todo.pop()
                assert getattr(n, "fallbacks", 0) == 0, q
                todo += n.children()
        assert any(isinstance(n, TorchJoinAggregateExec)
                   for n in [_join_exec(ctx, JOIN_QUERIES[0])])
        out.append(rows)
    for got, want in zip(*out):
        assert list(got) == list(want)
        for k in got:
            for a, b in zip(got[k], want[k]):
                if isinstance(a, float):
                    assert a == pytest.approx(b, rel=1e-9, abs=1e-6,
                                              nan_ok=True)
                else:
                    assert a == b


# --- the dense fold's warp reduction and the join's warp walk: edges --------

def _fold_table(n, seed):
    """`g`: 62 keys (6 key bits: G = 64) with one hot slot holding 90% of
    the rows; floats over NaN, -0.0, 0.0 and infinities with NULLs; int64,
    int32 and decimal lanes; `x` for a distinct count."""
    rng = np.random.default_rng(seed)
    g = np.where(rng.random(n) < 0.9, 17, rng.integers(0, 62, n))
    f = rng.choice(np.array([-0.0, 0.0, np.nan, 1.5, -2.5, np.inf, -np.inf,
                             7.25]), n)
    cols = [("g", dt.INT32, g.astype(np.int32), None),
            ("f", dt.FLOAT64, f, rng.random(n) > 0.1),
            ("f32", dt.FLOAT32, rng.choice(np.array(
                [-0.0, 0.0, np.nan, 3.5, -1.25], np.float32), n), None),
            ("k", dt.INT64, rng.integers(-2**40, 2**40, n),
             rng.random(n) > 0.2),
            ("i", dt.INT32, rng.integers(-2**31, 2**31 - 1, n)
             .astype(np.int32), None),
            ("d", dt.decimal(12, 2), rng.integers(-10**6, 10**6, n), None),
            ("x", dt.INT64, rng.integers(0, 50, n), None)]
    schema = Schema([Field(nm, t, v is not None) for nm, t, _d, v in cols])
    return Batch(schema, [Column(t, np.asarray(d), v)
                          for _nm, t, d, v in cols], n)


def _edge_aggregates():
    """Aggregates of every lane kind, 180 lanes and more with a distinct
    count: sums, counts, min and max of floats (NaN counted apart), of
    float32, int64, int32 and decimals."""
    out = ["count(*)", "count(DISTINCT x)"]
    for i in range(30):
        out += [f"sum(f * {i + 1})", f"min(f + {i})", f"max(f - {i})",
                f"sum(k + {i})", f"min(i - {i})", f"max(d * {i + 1})",
                f"count(f32 + {i})"]
    out += ["min(f32)", "max(f32)", "sum(f32)"]
    return ", ".join(out)


EDGE_DENSE = [
    ("SELECT " + _edge_aggregates() + " FROM t", 1),
    ("SELECT g, " + _edge_aggregates() + " FROM t GROUP BY g", 64),
]


def _dense_vs_plain(cuda, batch, q, groups):
    """The dense kernel (a launch a pass, with its distinct set) against
    its plain version on the same device tensors: equal group tables and
    distinct pairs."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, dense_group_aggregate, dense_group_aggregate_plain,
        dense_group_table)
    ctx = dft.SessionContext(cuda)
    ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
    node = _exec(ctx, q)
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, _n, _s = node.compile([src])
    assert (spec.groups == 1) == (groups == 1) and len(spec.lanes) >= 180
    assert spec.groups == groups or src.num_rows < 1000
    cols, aux = node.stage(spec, src)
    tables, pairs = [], []
    for fold in (dense_group_aggregate, dense_group_aggregate_plain):
        table = spec.new_table(cuda)
        dset = spec.distinct_set(src.num_rows, cuda)
        before = dft.launch_counts()["fused_dense_aggregate"]
        fold(spec, cols, aux, src.num_rows, table, dset=dset)
        assert dft.launch_counts()["fused_dense_aggregate"] == before + (
            len(spec.passes) if fold is dense_group_aggregate and
            src.num_rows else 0)
        torch.cuda.synchronize()
        table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
        assert not dset.overflowed()
        pairs.append(_pair_keys(dset, table.cpu().numpy(), False))
    _assert_tables_equal(spec, *tables, f64_tol=(1e-12, 1e-6))
    assert pairs[0] == pairs[1]
    return tables[0]


@pytest.mark.parametrize("q,groups", EDGE_DENSE)
@pytest.mark.parametrize("n", [1, 31, 33, 127, 128, 129, 255, 257, 300_000])
def test_dense_fold_edges_match_plain(cuda, q, groups, n):
    """G = 1 (the tiled fold: 8 x 32 rows a warp) and G = 64 with one hot
    slot, 180+ lanes of every kind (float min and max over NaN, -0.0, 0.0
    and infinities, NANCNT, a distinct count) in passes, at row counts
    around a warp and a tile."""
    table = _dense_vs_plain(cuda, _fold_table(n, n), q, groups)
    assert table.shape[1] >= 1


@pytest.mark.parametrize("q,groups", EDGE_DENSE)
def test_dense_fold_all_filtered_matches_plain(cuda, q, groups):
    """A predicate that admits no row: no group, every lane at its
    identity, in both versions."""
    q = q.replace(" FROM t", " FROM t WHERE k > 2000000000000")
    table = _dense_vs_plain(cuda, _fold_table(20_000, 3), q, groups)
    assert table.shape[1] == 0


def _join_edge_ctx(device, case):
    """Tables `b` (build) and `p` (probe) for the join edges: `hot_build`
    (one probe key meets 100,000 build rows), `hot_probe` (every probe row
    meets one build key), `mixed` (buckets of 0, 1 and up to 64 entries)
    and `two_keys` (two key words)."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(len(case))
    if case == "hot_build":
        bk = np.concatenate([np.full(100_000, 7), rng.integers(0, 5000, 5000)])
        pk = rng.integers(0, 5000, 40_000)
        pk[::997] = 7
    elif case == "hot_probe":
        bk = np.concatenate([np.full(5, 3), rng.integers(10, 5000, 5000)])
        pk = np.full(300_000, 3)
    else:
        fan = rng.integers(0, 65, 3000) * (rng.random(3000) < 0.5)
        bk = np.repeat(np.arange(3000), fan)
        pk = rng.integers(0, 3200, 200_000)
    nb, n = len(bk), len(pk)
    bx = rng.integers(0, 3, nb)
    b = Batch(Schema([Field("bk", dt.INT64, False), Field("bx", dt.INT64, False),
                      Field("bg", dt.INT32, False),
                      Field("bd", dt.decimal(12, 2), True),
                      Field("bf", dt.FLOAT64, False)]),
              [Column(dt.INT64, bk.astype(np.int64)),
               Column(dt.INT64, bx),
               Column(dt.INT32, rng.integers(0, 40, nb).astype(np.int32)),
               Column(dt.decimal(12, 2), rng.integers(0, 10**5, nb),
                      rng.random(nb) > 0.1),
               Column(dt.FLOAT64, rng.choice(np.array(
                   [-0.0, 0.0, np.nan, 2.5, -1.0]), nb))], nb)
    p = Batch(Schema([Field("pk", dt.INT64, True), Field("px", dt.INT64, False),
                      Field("pf", dt.FLOAT64, False)]),
              [Column(dt.INT64, pk.astype(np.int64), rng.random(n) > 0.02),
               Column(dt.INT64, rng.integers(0, 3, n)),
               Column(dt.FLOAT64, rng.normal(size=n))], n)
    ctx = dft.SessionContext(device)
    ctx.register_table("b", dft.MemTable(b.schema, [[b]]))
    ctx.register_table("p", dft.MemTable(p.schema, [[p]]))
    return ctx


_EDGE_JOIN_DENSE = ("SELECT b.bg, count(*), sum(p.px * b.bd), min(b.bf), "
                    "max(b.bf), sum(p.pf), count(b.bd) FROM p JOIN b ON {on} "
                    "GROUP BY b.bg")
_EDGE_JOIN_HASH = ("SELECT b.bd, p.px, count(*), sum(p.pf * b.bf), "
                   "max(b.bg) FROM p JOIN b ON {on} GROUP BY b.bd, p.px")
EDGE_JOINS = [(case, q.format(on=on)) for case in
              ("hot_build", "hot_probe", "mixed", "two_keys")
              for on in (["p.pk = b.bk AND p.px = b.bx"] if case == "two_keys"
                         else ["p.pk = b.bk"])
              for q in (_EDGE_JOIN_DENSE, _EDGE_JOIN_HASH)]


@pytest.mark.parametrize("case,q", EDGE_JOINS)
def test_join_edges_match_plain(cuda, case, q):
    """The warp-cooperative probe on its edges, dense and hash folds: a
    probe key meeting 100,000 build rows, a build key met by every probe
    row, buckets of 0, 1 and many entries, and two key words; build
    payloads with NULLs, NaN and -0.0 in their records."""
    from datafusion_tpu_torch.device.groupby import AggregateSpec
    spec, table = _join_vs_plain(_join_edge_ctx(cuda, case), cuda, q)
    assert isinstance(spec, AggregateSpec) == (q.startswith(
        _EDGE_JOIN_DENSE[:20]))
    assert table.shape[1] > 0 and table[1].sum() > 0


def test_join_forced_overflow_matches_plain(cuda):
    """A hash fold sized for 4 groups (8 probed slots) that meets many:
    the kernel and its plain version both raise the overflow flag."""
    from datafusion_tpu_torch.device.join_agg import (
        JoinHashSpec, join_aggregate, join_aggregate_plain, join_build)
    from datafusion_tpu_torch.physical.plan.base import (collect_batch,
                                                         execute_stream)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        _PairView)
    ctx = _join_edge_ctx(cuda, "mixed")
    q = _EDGE_JOIN_HASH.format(on="p.pk = b.bk")
    ex = _join_exec(ctx, q)
    tctx = ctx.task_context()
    lowered = ex.lower()
    bb = collect_batch(ex.build_source, tctx)
    bspec, bcols, baux = ex.build_input(lowered, bb)
    table = join_build(bspec, bcols, baux, bb.num_rows)
    (pb,) = [b for b in execute_stream(ex.probe_source, tctx) if b.num_rows]
    view = _PairView(list(bb.columns) + list(pb.columns), pb.num_rows)
    spec, _plan, _names, _sm = ex.compile_join(lowered, table, [view])
    small = JoinHashSpec(spec.pools, spec.pred, [
        (p, o, 30) for p, o, _s in spec.keys], spec.lanes, 4, spec.join)
    assert not small.identity_slots and small.cap == 8
    cols, aux = ex.stage_pair(small, bb, pb, view)
    flags = []
    for fold in (join_aggregate, join_aggregate_plain):
        groups = small.new_table(cuda)
        overflow = torch.zeros(1, dtype=torch.int32, device=cuda)
        fold(small, cols, aux, pb.num_rows, groups, overflow)
        torch.cuda.synchronize()
        flags.append(int(overflow.item()))
    assert flags == [1, 1]


# ---- the mesh: K1 partition_rows, K2 merge_partials ------------------------

@pytest.mark.parametrize("n,n_dest,cap,salt", [
    (1, 4, 1, 1), (4097, 4, 700, 1), (300_000, 8, 1 << 20, 1),
    (300_000, 3, 9_000, 4), (70_000, 256, 100, 1)])
def test_partition_rows_matches_plain(cuda, n, n_dest, cap, salt):
    """K1 against its plain version (a stable sort on the destination):
    the same send buffer, splits and pending flags, round after round,
    keys with bit 63 set among them; lanes of 1, 4 and 8 bytes. A call
    counts its two launches: the count and one sweep."""
    from datafusion_tpu_torch.device.exchange import (
        partition_rows, partition_rows_kernel, partition_rows_plain)
    rng = np.random.default_rng(n + n_dest)
    keys = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    keys[rng.random(n) < 0.5] = rng.integers(0, 50, n)[:1]   # a hot key
    lanes = [torch.from_numpy(rng.integers(0, 2**62, n)),
             torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
             torch.from_numpy(rng.random(n) < 0.5)]
    pend = torch.from_numpy(rng.random(n) < 0.9)
    k = torch.from_numpy(keys)
    state = [(k.to(cuda), pend.clone().to(cuda), [x.to(cuda) for x in lanes]),
             (k.to(cuda), pend.clone().to(cuda), [x.to(cuda) for x in lanes])]
    for _round in range(4):
        before = partition_rows_kernel.launches
        a = partition_rows(*state[0][:2], n_dest, cap, state[0][2], salt)
        assert partition_rows_kernel.launches - before == 2
        b = partition_rows_plain(*state[1][:2], n_dest, cap, state[1][2],
                                 salt)
        assert a.splits == b.splits and a.left == b.left
        assert torch.equal(a.keys, b.keys)
        for x, y in zip(a.lanes, b.lanes):
            assert torch.equal(x, y)
        assert torch.equal(state[0][1], state[1][1])
        if not a.left:
            break


def _merge_entries(rng, m, n_keys):
    from datafusion_tpu_torch.device.groupby import (
        LANE_CNT, LANE_MAX_F64, LANE_MAX_I64, LANE_MIN_F64, LANE_MIN_I64,
        LANE_NANCNT, LANE_ROWS, LANE_SUM_F64, LANE_SUM_I64)
    kinds = [LANE_ROWS, LANE_CNT, LANE_SUM_I64, LANE_SUM_F64, LANE_MIN_I64,
             LANE_MAX_I64, LANE_MIN_F64, LANE_MAX_F64, LANE_NANCNT]
    keys = rng.integers(0, n_keys, m)
    keys[rng.random(m) < 0.05] = -1                       # EMPTY
    rows = [keys, rng.integers(1, 5, m), rng.integers(0, 9, m),
            rng.integers(0, 9, m), rng.integers(-2**40, 2**40, m),
            rng.normal(size=m).view(np.int64),
            rng.integers(-2**62, 2**62, m), rng.integers(-2**62, 2**62, m),
            (rng.normal(size=m) * 1e3).view(np.int64),
            (rng.normal(size=m) * 1e3).view(np.int64), rng.integers(0, 3, m)]
    return kinds, torch.from_numpy(np.stack(rows).astype(np.int64))


@pytest.mark.parametrize("m,n_keys,n_owner,limit", [
    (1, 5, 0, 16), (5000, 300, 0, 300), (300_000, 200_000, 4, 200_000),
    (300_000, 50, 8, 50), (20_000, 20_000, 0, 100)])
def test_merge_partials_matches_plain(cuda, m, n_keys, n_owner, limit):
    """K2 against its plain version: the same distinct-key count and
    overflow flag (the last case passes its limit and fills the table, and
    both count only the keys that found a slot); below the limit, the same
    groups (compacted, by key), counts, integer lanes and min/max exactly,
    float sums within rel 1e-12 (atomic adds change the order). Which keys
    win a full table's slots depends on the threads' order, so the groups
    of the overflow case are not compared."""
    from datafusion_tpu_torch.device.exchange import (
        MergeTable, merge_partials, merge_partials_kernel,
        merge_partials_plain)
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F64, compact_groups)
    rng = np.random.default_rng(m + n_keys)
    kinds, e = _merge_entries(rng, m, n_keys)
    t = MergeTable(kinds, limit, cuda)
    before = merge_partials_kernel.launches
    merge_partials(e[:, :0].contiguous().to(cuda), t)   # no entries: none
    merge_partials(e.to(cuda), t)
    assert merge_partials_kernel.launches - before == 1
    out = []
    for dev, fn in ((cuda, merge_partials), (cuda, merge_partials_plain)):
        t = MergeTable(kinds, limit, dev)
        for part in torch.chunk(e, 3, dim=1):        # three rounds
            fn(part.contiguous().to(dev), t, my=1, n_owner=n_owner)
        g = compact_groups(t.table).cpu()
        g = g[:, torch.argsort(g[0])]
        out.append((g, int(t.groups.item()), int(t.overflow.item())))
    (a, ga, oa), (b, gb, ob) = out
    assert oa == ob
    assert ga == gb
    if oa:
        return
    assert a.shape == b.shape
    for r in range(a.shape[0]):
        if r >= 2 and kinds[r - 2] == LANE_SUM_F64:
            np.testing.assert_allclose(a[r].view(torch.float64).numpy(),
                                       b[r].view(torch.float64).numpy(),
                                       rtol=1e-12)
        else:
            assert torch.equal(a[r], b[r])


MESH_QUERIES = [
    "SELECT g, count(*) c, sum(v) s, min(i) mn, max(d) mx FROM t GROUP BY g",
    "SELECT k, count(*) c, sum(d) s FROM t GROUP BY k",
    "SELECT day, count(*) c, sum(i) s FROM t GROUP BY day",
    "SELECT d, count(*) c, sum(i) s, max(v) mx FROM t GROUP BY d",
]


def test_cuda_mesh_end_to_end_matches_cpu(cuda):
    """A 4-shard mesh on the card against a 4-shard mesh on the CPU: the
    all_gather and shuffle aggregates, the broadcast and partitioned
    joins, the same rows, no fallback, K1 and K2 launched."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch import kernels
    batch = _table(200_000, 11)
    rng = np.random.default_rng(3)
    dim = {"dk": np.arange(15) % 3 - 1, "w": rng.integers(0, 9, 15)}
    qs = MESH_QUERIES + [
        "SELECT w, count(*) c, sum(i) s, min(v) mn FROM dim JOIN t ON dk = k "
        "GROUP BY w"]
    out = []
    for dev in (cuda, torch.device("cpu")):
        rows = []
        for thr in (131072, 4):
            ctx = dft.SessionContext(dev)
            ctx.config.set("datafusion.tpu.mesh_devices", 4)
            ctx.config.set("datafusion.optimizer."
                           "hash_join_single_partition_threshold_rows", thr)
            ctx.register_table("t", dft.MemTable(batch.schema, [[batch]]))
            ctx.register_arrays("dim", dim)
            kernels.reset_launch_counts()
            for q in qs:
                q = q + " ORDER BY 1"
                rows.append(ctx.sql(q).to_pydict())
                todo = [ctx.sql(q).create_physical_plan()]
                while todo:
                    n = todo.pop()
                    assert getattr(n, "fallbacks", 0) == 0, q
                    todo += n.children()
            if dev.type == "cuda":
                counts = kernels.launch_counts()
                assert counts["merge_partials"] > 0
                assert counts["partition_rows"] > 0
        out.append(rows)
    for got, want in zip(*out):
        assert list(got) == list(want)
        for k in got:
            for a, b in zip(got[k], want[k]):
                if isinstance(a, float):
                    assert a == pytest.approx(b, rel=1e-9, abs=1e-6,
                                              nan_ok=True)
                else:
                    assert a == b


# ---- the tile walk (chain_aggregate) and K1's sweep on shapes ----------------

def _walk_vs_plain(spec, cols, aux, rows, device):
    """`chain_aggregate` (one launch a pass of lanes) against its plain
    version: equal groups, counts and integer lanes, float sums within rel
    1e-9 (atomics add in another order)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F32, LANE_SUM_F64, AggregateSpec, compact_groups,
        dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        chain_aggregate, chain_aggregate_plain)
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(device)
        overflow = torch.zeros(1, dtype=torch.int32, device=device)
        dset = spec.distinct_set(rows, device)
        before = dft.launch_counts()["chain_aggregate"]
        fold(spec, cols, aux, rows, table, overflow, dset=dset)
        assert dft.launch_counts()["chain_aggregate"] - before == \
            (len(spec.metas) if fold is chain_aggregate else 0)
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        if isinstance(spec, AggregateSpec):
            table = dense_group_table(table)
        tables.append(compact_groups(table).cpu().numpy())
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in tables)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:2], want[:2])
    for (_p, kind), a, b in zip(spec.lanes, spec.lane_arrays(got, first=2),
                                spec.lane_arrays(want, first=2)):
        if kind in (LANE_SUM_F64, LANE_SUM_F32):
            np.testing.assert_allclose(a, b, rtol=1e-9)
        else:
            np.testing.assert_array_equal(a, b)
    return got.shape[1]


@pytest.mark.parametrize("compose", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("q", [2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 14, 16, 17,
                               18, 19, 21])
def test_tile_walk_tpch_matches_plain(cuda, q, compose):
    """Every TPC-H walk at SF 0.01, staged as the exec stages it and
    without composition or folding: the tile walk against its plain
    version."""
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES
    ctx = _tpch_ctx(cuda, 0.01)
    todo, walked = [ctx.sql(QUERIES[q]).create_physical_plan()], 0
    while todo:
        node = todo.pop()
        todo += node.children()
        if not isinstance(node, TorchJoinChainAggregateExec):
            continue
        spec, _p, _n, _s, inputs, _staged = node.prepare(
            ctx.task_context(), compose)
        for cols, aux, rows in inputs:
            _walk_vs_plain(spec, cols, aux, rows, cuda)
            walked += 1
    assert walked >= 1


def _run_ctx(device, n):
    """A spine whose rows 1,000 to 60,000 pass its predicate, a run of
    survivors across many tiles, each through an INNER hop and a SEMI
    hop."""
    import datafusion_tpu_torch as dft
    rng = np.random.default_rng(4)
    ctx = dft.SessionContext(device)
    ctx.register_arrays("f", {"r": np.arange(n), "k": rng.integers(0, 64, n),
                              "v": rng.integers(0, 1000, n)})
    ctx.register_arrays("d", {"id": np.arange(60), "w": rng.integers(0, 9,
                                                                     60)})
    ctx.register_arrays("m", {"k": np.arange(0, 64, 2)})
    return ctx


RUN_SQL = ("SELECT d.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
           "WHERE f.r >= 1000 AND f.r < 60000 AND f.k IN (SELECT k FROM m) "
           "GROUP BY d.w")


@pytest.mark.parametrize("list_cap", [64, 100, 128, 512])
def test_tile_walk_across_tile_boundaries(cuda, monkeypatch, list_cap):
    """A run of 59,000 surviving rows crosses the tiles of a warp's lists
    of 64 entries (a step of 64 rows: the list is walked before every
    step), 100, 128 and 512: the walk against its plain version."""
    from datafusion_tpu_torch.device import join_chain
    monkeypatch.setattr(join_chain, "LIST_CAP", list_cap)
    ctx = _run_ctx(cuda, 100_003)
    ex = _chain_exec(ctx, RUN_SQL)
    spec, _p, _n, _s, inputs, _staged = ex.prepare(ctx.task_context())
    ((cols, aux, rows),) = inputs
    assert _walk_vs_plain(spec, cols, aux, rows, cuda) > 0


def test_tile_walk_eight_hops(cuda):
    """A chain of eight hops: the walk against its plain version, and the
    query against the CPU's."""
    from test_torch_tile_walk import EIGHT_HOP_SQL, eight_hop_ctx
    ctx = eight_hop_ctx(cuda, 300_000)
    ex = _chain_exec(ctx, EIGHT_HOP_SQL)
    spec, _p, _n, _s, inputs, _staged = ex.prepare(ctx.task_context())
    assert len(spec.chain.hops) == 8
    ((cols, aux, rows),) = inputs
    assert _walk_vs_plain(spec, cols, aux, rows, cuda) == 5
    assert ctx.sql(EIGHT_HOP_SQL).to_pydict() == eight_hop_ctx(
        torch.device("cpu"), 300_000).sql(EIGHT_HOP_SQL).to_pydict()


@pytest.mark.parametrize("shape", ["skewed", "uniform", "empty", "none"])
@pytest.mark.parametrize("n_dest", [1, 3, 4, 5, 32, 256])
def test_partition_sweep_shapes_match_plain(cuda, shape, n_dest):
    """K1 against its plain version on a partition whose rows all share
    one key (skewed), on uniform keys, on no rows and on rows none of
    which is pending, with n_dest a power of two (ballots on the owner's
    bits) and not (matching), 34 lanes (two sweeps), round after round
    under a cap of a third of the rows."""
    from datafusion_tpu_torch.device.exchange import (
        partition_rows, partition_rows_kernel, partition_rows_plain)
    rng = np.random.default_rng(n_dest)
    n = 0 if shape == "empty" else 123_457
    keys = np.full(n, 99, np.int64) if shape == "skewed" else \
        rng.integers(-2**62, 2**62, n)
    pend = np.ones(n, bool) if shape != "none" else np.zeros(n, bool)
    lanes = [torch.from_numpy(rng.integers(0, 1 << 40, n))
             for _ in range(30)] + [
        torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 99, n).astype(np.int16)),
        torch.from_numpy(rng.random(n) < 0.5),
        torch.from_numpy(rng.integers(0, 99, n).astype(np.uint8))]
    cap = max(n // 3, 1)
    k = torch.from_numpy(keys)
    state = [(k.to(cuda), torch.from_numpy(pend).to(cuda),
              [x.to(cuda) for x in lanes]) for _ in range(2)]
    for _round in range(8):
        before = partition_rows_kernel.launches
        a = partition_rows(*state[0][:2], n_dest, cap, state[0][2])
        assert partition_rows_kernel.launches - before == 3
        b = partition_rows_plain(*state[1][:2], n_dest, cap, state[1][2])
        assert a.splits == b.splits and a.left == b.left
        assert torch.equal(a.keys, b.keys)
        for x, y in zip(a.lanes, b.lanes):
            assert torch.equal(x, y)
        assert torch.equal(state[0][1], state[1][1])
        if not a.left:
            break
    assert not bool(state[0][1].any())
