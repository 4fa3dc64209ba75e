"""Fanout-1 join chains through the port on the CPU, against the JAX
package.

`datafusion_tpu_torch.SessionContext(torch.device("cpu"))` runs the plain
PyTorch versions of `chain_build` and `chain_aggregate`; the JAX package
runs `DeviceJoinChainAggregateExec` on the CPU backend, as its own tests
do. Each package registers the same seeded numpy arrays with its own
classes. Rows must be equal (row order only under ORDER BY): integers,
decimals, dates and strings exactly, floats within rel 1e-9 (the two sum
in different orders).
"""
import datetime
import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.physical.expressions import ColumnExpr
from datafusion_tpu.physical.plan.device_join_chain import (
    ChainBuild, DeviceJoinChainAggregateExec, _unfiltered_lut)
from datafusion_tpu.tpch.queries import QUERIES as TPCH
from datafusion_tpu_torch.common.column import to_device
from datafusion_tpu_torch.device.join_chain import (
    TAB_DIRECT, TAB_EMPTY, TAB_HASH, BuildSpec, chain_build, splitmix64,
    table_layout)
from datafusion_tpu_torch.device.lower import Pools, compile_expr
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchJoinChainAggregateExec)
from torch_twin import register_tpch_both, twin

CPU = torch.device("cpu")


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _execs(ctx, q, cls):
    return [n for n in _walk(ctx.sql(q).create_physical_plan())
            if type(n) is cls]


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=1e-9, abs=1e-12, nan_ok=True)
    return a == b and type(a) is type(b)


def _same_rows(got, want, ordered):
    assert list(got) == list(want)
    g = list(zip(*got.values()))
    w = list(zip(*want.values()))
    assert len(g) == len(w)
    if not ordered:
        key = lambda r: tuple((x is None, str(x)) for x in r)  # noqa: E731
        g, w = sorted(g, key=key), sorted(w, key=key)
    for rg, rw in zip(g, w):
        assert all(_same_value(a, b) for a, b in zip(rg, rw)), (rg, rw)


# --- the build table against the reference's direct-address LUT -------------

@pytest.mark.parametrize("n,seed,keys", [(5_000, 0, 1), (20_000, 1, 1),
                                         (3_000, 2, 2)])
def test_build_table_matches_unfiltered_lut(n, seed, keys):
    """Unique non-null integer keys with a bounded span: the port's
    direct-address table maps each key to the same build row as the
    reference's `_unfiltered_lut` (`device_join_chain.py:177`)."""
    rng = np.random.default_rng(seed)
    cols = {"a": rng.permutation(n).astype(np.int64) * 3 - 50}
    if keys == 2:
        pairs = rng.permutation(n)
        cols = {"a": (pairs // 60).astype(np.int64),
                "b": (pairs % 60).astype(np.int64) + 7}
    ref = df.SessionContext()
    ref.register_arrays("b", cols)
    bb = ref.table("b").collect()[0]
    build = ChainBuild(None, [], [ColumnExpr(i, k, df.dt.INT64)
                                  for i, k in enumerate(cols)], [])
    lut = _unfiltered_lut(bb, list(range(keys)), build, jnp)
    assert lut is not None
    _cols, _dev, lut_np, offs, _his, bits = lut

    pb = twin(bb)
    pools = Pools()
    progs = [compile_expr(twin(k), pools) for k in build.build_keys]
    spec = BuildSpec(pools, None, progs)
    dev_cols = {i: to_device(pb.columns[i], CPU) for i in pools.columns}
    table = chain_build(spec, dev_cols, torch.zeros(0, dtype=torch.int64),
                        n, unique=True)
    assert table.kind == TAB_DIRECT and not table.duplicate
    assert table.live == n and table.los == list(offs)
    vals = [np.asarray(v) for v in cols.values()]
    ref_packed = np.zeros(n, np.int64)
    port_packed = np.zeros(n, np.int64)
    shift = 0
    for v, lo, w, s in zip(vals, offs, bits, table.shifts):
        ref_packed |= (v - lo) << shift
        port_packed |= (v - lo) << s
        shift += w
    rows = table.rows.numpy()
    np.testing.assert_array_equal(lut_np[ref_packed], np.arange(n))
    np.testing.assert_array_equal(rows[port_packed], np.arange(n))
    assert int((rows >= 0).sum()) == int((lut_np >= 0).sum()) == n


def test_build_layout_direct_hashed_and_empty():
    assert table_layout(0, [0], [-1])[0] == TAB_EMPTY
    # o_orderkey at SF10: 15M orders, keys 4i - 3, span 60M <= 2^26
    kind, shifts, size = table_layout(15_000_000, [1], [59_999_997])
    assert (kind, shifts, size) == (TAB_DIRECT, [0], 59_999_997)
    kind, _s, size = table_layout(1000, [0], [1 << 40])
    assert (kind, size) == (TAB_HASH, 2048)
    kind, shifts, size = table_layout(100, [0, 0], [7, 3])
    assert (kind, shifts, size) == (TAB_DIRECT, [0, 3], 32)


def test_splitmix64_matches_the_reference_hash():
    """The plain version's hash is splitmix64, bit for bit (the kernel's
    slot order)."""
    from datafusion_tpu.physical.hashing import _splitmix64 as ref_hash
    x = np.random.default_rng(3).integers(0, 1 << 62, 1000)
    got = splitmix64(torch.from_numpy(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, ref_hash(x.astype(np.uint64)))


def test_hashed_build_is_probed_as_a_direct_one():
    """Sparse keys take the hashed table; a spine probing it finds the same
    rows as the JAX package's chain."""
    rng = np.random.default_rng(4)
    n_d = 2_000
    ids = rng.choice(1 << 40, n_d, replace=False)
    data = {"f": {"k": rng.choice(ids, 30_000), "v": rng.integers(0, 9, 30_000)},
            "d": {"id": ids, "g": rng.integers(0, 300, n_d)},
            "e": {"id": np.arange(300), "w": rng.integers(0, 5, 300)}}
    sql = ("SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
           "JOIN e ON d.g = e.id GROUP BY e.w ORDER BY e.w")
    port, ref = _pair(data)
    _same_rows(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict(), True)
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0
    _spec, _p, _n, _s, _inputs, staged = ex.prepare(port.task_context())
    assert [s.table.kind for s in staged] == [TAB_HASH, TAB_DIRECT]


# --- counterparts of tests/test_device_join_chain.py -------------------------

def _pair(data):
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        for name, cols in data.items():
            c.register_arrays(name, cols)
    return port, ref


def _star(seed=7):
    rng = np.random.default_rng(seed)
    n_fact, n_d1, n_d2 = 5000, 300, 40
    return {
        "fact": {"k1": rng.integers(0, n_d1, n_fact),
                 "v": rng.normal(size=n_fact).round(3),
                 "tag": rng.integers(0, 5, n_fact)},
        "d1": {"id": np.arange(n_d1), "k2": rng.integers(0, n_d2, n_d1),
               "w": rng.integers(1, 100, n_d1)},
        "d2": {"id": np.arange(n_d2),
               "name": np.array([f"g{i % 7}" for i in range(n_d2)])},
    }


CHAIN_SQL = (
    "SELECT d2.name, count(*) AS c, sum(f.v * d1.w) AS s "
    "FROM fact f JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
    "WHERE f.tag < 4 GROUP BY d2.name ORDER BY d2.name")

STAR_CASES = {
    "inner_two_hop": CHAIN_SQL,
    "semi": ("SELECT d2.name, count(*) c FROM fact f "
             "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
             "WHERE f.k1 IN (SELECT id FROM d1 WHERE w > 50) "
             "GROUP BY d2.name ORDER BY d2.name"),
    "anti": ("SELECT count(*) c, sum(f.v) s FROM fact f "
             "JOIN d1 ON f.k1 = d1.id "
             "WHERE f.k1 NOT IN (SELECT id FROM d1 WHERE w > 50) "
             "AND f.tag = 1 GROUP BY f.tag"),
    "filtered_build": ("SELECT d2.name, count(*) c, sum(f.v) s FROM fact f "
                       "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
                       "WHERE d1.w > 30 AND d2.name <> 'g3' "
                       "GROUP BY d2.name ORDER BY d2.name"),
    "string_key_from_payload": ("SELECT d2.name, min(d1.w) mn, max(d1.w) mx "
                                "FROM fact f JOIN d1 ON f.k1 = d1.id "
                                "JOIN d2 ON d1.k2 = d2.id "
                                "GROUP BY d2.name ORDER BY d2.name"),
    "ungrouped_empty": ("SELECT count(*) c, sum(f.v) s FROM fact f "
                        "JOIN d1 ON f.k1 = d1.id WHERE d1.w > 1000"),
}


@pytest.mark.parametrize("case", sorted(STAR_CASES))
def test_star_chain_matches_jax_package(case):
    sql = STAR_CASES[case]
    port, ref = _pair(_star())
    assert _execs(ref, sql, DeviceJoinChainAggregateExec)
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    _same_rows(got, want, ordered="ORDER BY" in sql)
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0
    if case == "semi":
        assert "LEFTSEMI" in ex.display_line()
    if case == "ungrouped_empty":      # zero joined rows still give one row
        assert got == {"c": [0], "s": [None]}


def test_string_group_key_decodes_through_its_build_dictionary():
    """The group key is a dictionary string of the second build: its codes
    decode through that build batch's dictionary, not the spine's."""
    port, ref = _pair(_star())
    sql = STAR_CASES["string_key_from_payload"]
    got = port.sql(sql).to_pydict()
    assert got["name"] == sorted({f"g{i % 7}" for i in range(40)})
    _same_rows(got, ref.sql(sql).to_pydict(), True)


def test_nonunique_build_falls_back():
    """Duplicate build keys (fanout > 1) run the host plan, not a mis-join."""
    data = {"f": {"k": np.array([1, 2, 3, 1] * 500), "v": np.arange(2000.0)},
            "b1": {"id": np.array([1, 1, 2, 3]), "p": np.array([10, 11, 20, 30])},
            "b2": {"p": np.array([10, 11, 20, 30]),
                   "g": np.array(["x", "x", "y", "z"])}}
    sql = ("SELECT g, count(*) c FROM f JOIN b1 ON f.k = b1.id "
           "JOIN b2 ON b1.p = b2.p GROUP BY g ORDER BY g")
    port, ref = _pair(data)
    got = port.sql(sql).to_pydict()
    assert got == ref.sql(sql).to_pydict()
    assert got == {"g": ["x", "y", "z"], "c": [2000, 500, 500]}
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 1


def test_build_key_wider_than_62_bits_falls_back():
    """An int64 build key spanning more than 2^62 does not pack into a
    table key: the exec counts a fallback and the host plan's rows come
    back."""
    rng = np.random.default_rng(11)
    ids = np.array([-(1 << 62) - 5, -7, 0, 12345, (1 << 62) + 5], np.int64)
    k = rng.choice(np.concatenate([ids, [1, 2]]), 2000)
    data = {"f": {"k": k, "v": rng.integers(0, 10, 2000)},
            "b1": {"id": ids, "p": np.array([10, 11, 20, 30, 10])},
            "b2": {"p": np.array([10, 11, 20, 30]),
                   "g": np.array(["x", "x", "y", "z"])}}
    sql = ("SELECT g, count(*) c, sum(f.v) s FROM f JOIN b1 ON f.k = b1.id "
           "JOIN b2 ON b1.p = b2.p GROUP BY g ORDER BY g")
    port, ref = _pair(data)
    got = port.sql(sql).to_pydict()
    assert got == ref.sql(sql).to_pydict()
    assert got["c"] == [int(np.isin(k, ids[[0, 1, 4]]).sum()),
                        int((k == 0).sum()), int((k == 12345).sum())]
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 1


def test_null_keys_never_match():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.sql("CREATE TABLE f AS SELECT * FROM (VALUES "
              "(1, 10.0), (2, 20.0), (NULL, 30.0), (4, 40.0)) v(k, x)")
        c.sql("CREATE TABLE b AS SELECT * FROM (VALUES "
              "(1, 'a'), (2, 'b'), (NULL, 'n')) v(id, s)")
        c.sql("CREATE TABLE c AS SELECT * FROM (VALUES "
              "('a', 100), ('b', 200)) v(s, m)")
    sql = ("SELECT b.s, sum(f.x) t, sum(c.m) mm FROM f "
           "JOIN b ON f.k = b.id JOIN c ON b.s = c.s "
           "GROUP BY b.s ORDER BY b.s")
    got = port.sql(sql).to_pydict()
    assert got == ref.sql(sql).to_pydict()
    assert got == {"s": ["a", "b"], "t": [10.0, 20.0], "mm": [100, 200]}


def test_null_probe_and_build_keys_with_a_device_chain():
    """NULLs on both sides of an integer chain key: rows with a NULL key
    never join, and a build's NULL-key row is never inserted."""
    rng = np.random.default_rng(9)
    n = 3000
    k = rng.integers(0, 100, n).astype(float)
    k[rng.random(n) < 0.1] = np.nan
    bid = np.arange(100).astype(float)
    bid[[5, 17]] = np.nan
    data = {"f": {"k": k, "v": rng.integers(0, 10, n)},
            "b": {"id": bid, "g": rng.integers(0, 20, 100)},
            "c": {"id": np.arange(20), "w": rng.integers(0, 3, 20)}}
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        for name, cols in data.items():
            c.register_arrays(name, cols)
        # NaN is a value, not a NULL: make the NaNs NULL before the cast
        c.sql("CREATE TABLE fi AS SELECT CASE WHEN isnan(k) THEN NULL "
              "ELSE CAST(k AS BIGINT) END k, v FROM f")
        c.sql("CREATE TABLE bi AS SELECT CASE WHEN isnan(id) THEN NULL "
              "ELSE CAST(id AS BIGINT) END id, g FROM b")
    sql = ("SELECT c.w, count(*) n, sum(fi.v) s FROM fi JOIN bi "
           "ON fi.k = bi.id JOIN c ON bi.g = c.id GROUP BY c.w ORDER BY c.w")
    got = port.sql(sql).to_pydict()
    _same_rows(got, ref.sql(sql).to_pydict(), True)
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0
    kk = k[~np.isnan(k)]
    assert sum(got["n"]) == int(np.isin(kk, bid[~np.isnan(bid)]).sum())


def test_residual_cross_dimension_equality():
    """A second equality between two dimension payloads is a residual over
    the pair space (TPC-H Q5's c_nationkey = s_nationkey shape)."""
    rng = np.random.default_rng(3)
    n = 4000
    data = {"f": {"a": rng.integers(0, 50, n), "b": rng.integers(0, 30, n),
                  "v": rng.integers(0, 1000, n)},
            "da": {"id": np.arange(50), "region": rng.integers(0, 4, 50)},
            "db": {"id": np.arange(30), "region": rng.integers(0, 4, 30)}}
    sql = ("SELECT da.region, sum(f.v) s FROM f "
           "JOIN da ON f.a = da.id JOIN db ON f.b = db.id "
           "AND da.region = db.region GROUP BY da.region ORDER BY da.region")
    port, ref = _pair(data)
    got = port.sql(sql).to_pydict()
    assert got == ref.sql(sql).to_pydict() and got["region"]
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.predicate is not None and ex.fallbacks == 0


def test_sorted_spine_group_key():
    """A spine sorted on its join key; the dependent key `dt` packs beside
    the spine key (no functional-dependence reduction in the port)."""
    rng = np.random.default_rng(5)
    n_fact, n_d = 6000, 500
    data = {"fact": {"k": np.sort(rng.integers(0, n_d, n_fact)),
                     "v": rng.normal(size=n_fact).round(3)},
            "d": {"id": np.arange(n_d), "dt": rng.integers(8000, 9000, n_d),
                  "w": rng.integers(1, 9, n_d), "g": rng.integers(0, 40, n_d)},
            "d2": {"id": np.arange(40), "z": np.arange(40) * 10}}
    sql = ("SELECT f.k, d.dt, count(*) c, sum(f.v) s FROM fact f "
           "JOIN d ON f.k = d.id JOIN d2 ON d.g = d2.id WHERE d.w > 2 "
           "GROUP BY f.k, d.dt ORDER BY f.k LIMIT 50")
    port, ref = _pair(data)
    got = port.sql(sql).to_pydict()
    _same_rows(got, ref.sql(sql).to_pydict(), True)
    assert len(got["k"]) == 50
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0


def test_replaced_table_is_not_served_stale():
    """Re-registering a build table under its name changes the result:
    device copies are keyed by never-recycled column uids and dropped on
    any catalog change."""
    data = _star()
    port, _ref = _pair(data)
    base = port.sql(CHAIN_SQL).to_pydict()
    d1 = dict(data["d1"])
    d1["w"] = d1["w"] * 2
    port.register_arrays("d1", d1)
    doubled = port.sql(CHAIN_SQL).to_pydict()
    np.testing.assert_allclose(doubled["s"], [2 * x for x in base["s"]],
                               rtol=1e-9)


def test_with_children_keeps_the_chain():
    port, _ref = _pair(_star())
    (ex,) = _execs(port, STAR_CASES["semi"], TorchJoinChainAggregateExec)
    again = ex.with_children(ex.children())
    assert again.display_line() == ex.display_line()
    assert [b.join_type for b in again.builds] == \
        [b.join_type for b in ex.builds]


# --- all 22 TPC-H queries at SF 0.01 ------------------------------------------

# the queries whose chain the port's lowering covers (the others plan the
# chain exec too, and fall back to the host plan: CASE, scalar functions,
# keys wider than 62 bits, SEMI min/max, string IN over an expression)
ON_THE_PORT = {2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 14, 16, 17, 18, 19, 21}


@pytest.fixture(scope="module")
def tpch():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01, seed=1)
    return port, ref


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_matches_jax_package(tpch, q):
    port, ref = tpch
    sql = TPCH[q]
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    _same_rows(got, want, ordered="order by" in sql.lower())
    ref_chain = _execs(ref, sql, DeviceJoinChainAggregateExec)
    port_chain = _execs(port, sql, TorchJoinChainAggregateExec)
    assert len(port_chain) == len(ref_chain)
    if q in ON_THE_PORT:
        assert port_chain and all(e.fallbacks == 0 for e in port_chain)
    if q in (3, 4, 5):
        assert port_chain and all(e.fallbacks == 0 for e in port_chain)


def test_q5_snowflake_pair_space(tpch):
    """Q5's five hops: a later hop's probe key reads an earlier hop's
    payload (s_nationkey, then n_regionkey; o_custkey of the orders hop),
    and the residual compares two payloads (c_nationkey = s_nationkey)."""
    port, _ref = tpch
    (ex,) = _execs(port, TPCH[5], TorchJoinChainAggregateExec)
    line = ex.display_line()
    assert line.count("INNER[") == 5
    n_spine = ex.n_spine
    ranges = ex.payload_ranges()
    later = [k.index for b in ex.builds[1:] for k in b.probe_keys
             if type(k).__name__ == "ColumnExpr"]
    assert any(i >= n_spine for i in later)
    refs = set()

    def cols(e):
        if hasattr(e, "index") and type(e).__name__ == "ColumnExpr":
            refs.add(e.index)
        for c in e.children():
            cols(c)
    cols(ex.predicate)
    payload = {i for r in ranges for i in r}
    assert len(refs & payload) >= 2


def test_tpch_dates_and_decimals_are_exact(tpch):
    port, _ref = tpch
    got = port.sql(TPCH[3]).to_pydict()
    assert all(isinstance(v, decimal.Decimal) for v in got["revenue"])
    assert all(isinstance(v, datetime.date) for v in got["o_orderdate"])


# --- SEMI/ANTI min/max membership (TPC-H Q21's filtered EXISTS) ----------------

def _mmx_data(wide: bool, seed=13):
    """A spine `f` with an INNER dimension and a member table `m` keyed like
    the spine; member values `s` and the spine's `s` carry NULLs. With
    `wide` the keys spread past 2^26, so the min/max table is hashed."""
    rng = np.random.default_rng(seed)
    n_f, n_m, n_k = 4000, 6000, 700
    mult = (1 << 30) + 3 if wide else 1
    fs = rng.integers(0, 12, n_f).astype(float)
    fs[rng.random(n_f) < 0.08] = np.nan
    ms = rng.integers(0, 12, n_m).astype(float)
    ms[rng.random(n_m) < 0.1] = np.nan
    return {"f0": {"k": rng.integers(0, n_k, n_f) * mult, "s": fs,
                   "g": rng.integers(0, 6, n_f), "v": rng.integers(0, 50, n_f)},
            "m0": {"k": rng.integers(0, n_k + 100, n_m) * mult, "s": ms,
                   "w": rng.integers(0, 4, n_m)},
            "d": {"id": np.arange(6), "name": np.array(list("abcdef"))}}


def _mmx_pair(data):
    port, ref = _pair(data)
    for c in (port, ref):
        c.sql("CREATE TABLE f AS SELECT k, CASE WHEN isnan(s) THEN NULL "
              "ELSE CAST(s AS BIGINT) END s, g, v FROM f0")
        c.sql("CREATE TABLE m AS SELECT k, CASE WHEN isnan(s) THEN NULL "
              "ELSE CAST(s AS BIGINT) END s, w FROM m0")
    return port, ref


@pytest.mark.parametrize("wide", [False, True], ids=["direct", "hashed"])
@pytest.mark.parametrize("anti", [False, True], ids=["semi", "anti"])
@pytest.mark.parametrize("op", ["<>", "<", "<=", ">", ">="])
def test_semi_min_max_membership_matches_jax(op, anti, wide):
    """`[NOT] EXISTS (... m.k = f.k AND m.s OP f.s)` under a join chain:
    the member table keeps each key's min and max of `s` over the rows that
    pass `m.w > 0` with `s` valid; a NULL `f.s` satisfies nothing (so ANTI
    keeps its row). Rows equal the JAX package's chain."""
    sql = ("SELECT d.name, count(*) c, sum(f.v) s FROM f "
           "JOIN d ON f.g = d.id WHERE " + ("NOT " if anti else "") +
           f"EXISTS (SELECT 1 FROM m WHERE m.k = f.k AND m.s {op} f.s "
           "AND m.w > 0) GROUP BY d.name ORDER BY d.name")
    port, ref = _mmx_pair(_mmx_data(wide))
    assert _execs(ref, sql, DeviceJoinChainAggregateExec)
    got = port.sql(sql).to_pydict()
    _same_rows(got, ref.sql(sql).to_pydict(), True)
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0
    assert "filter=" in ex.display_line()
    _spec, _p, _n, _s, _inputs, staged = ex.prepare(port.task_context())
    (mm,) = [s.table for s in staged if s.table.mn is not None]
    assert mm.kind == (TAB_HASH if wide else TAB_DIRECT)
    assert sum(got["c"]) > 0


def test_min_max_table_holds_each_keys_extremes():
    """The staged min/max table: per key, the min and max of the member
    column over the live rows (predicate true, key and member valid);
    keys with no such row are absent."""
    data = _mmx_data(False)
    port, _ref = _mmx_pair(data)
    sql = ("SELECT count(*) c FROM f JOIN d ON f.g = d.id WHERE EXISTS "
           "(SELECT 1 FROM m WHERE m.k = f.k AND m.s < f.s AND m.w > 0)")
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    _spec, _p, _n, _s, _inputs, staged = ex.prepare(port.task_context())
    (t,) = [s.table for s in staged if s.table.mn is not None]
    m = port.sql("SELECT k, s FROM m WHERE w > 0 AND s IS NOT NULL"
                 ).to_pydict()
    want = {}
    for k, s in zip(m["k"], m["s"]):
        lo, hi = want.get(k, (s, s))
        want[k] = (min(lo, s), max(hi, s))
    rows = t.rows.numpy()
    present = np.flatnonzero(rows >= 0)
    assert sorted(int(p) + t.los[0] for p in present) == sorted(want)
    for p in present:
        assert (int(t.mn[p]), int(t.mx[p])) == want[int(p) + t.los[0]]


# --- functional-dependence key reduction (TPC-H Q10, Q18) ---------------------

def _fd_tables(seed=21):
    rng = np.random.default_rng(seed)
    n_l, n_o, n_c = 6000, 900, 120
    o_id = rng.permutation(4 * n_o)[:n_o] + 1
    return {
        "l": {"ok": rng.choice(o_id, n_l), "q": rng.integers(1, 50, n_l)},
        "o": {"id": o_id, "cid": rng.integers(0, n_c, n_o),
              "dt": rng.integers(9000, 10000, n_o),
              "price": rng.integers(100, 10**6, n_o)},
        "c": {"id": np.arange(n_c),
              "name": np.array([f"Customer#{i:09d}" for i in range(n_c)]),
              "bal": rng.integers(-999, 9999, n_c)}}


FD_SQL = ("SELECT c.name, c.id, o.id, o.dt, o.price, sum(l.q) qty "
          "FROM l JOIN o ON l.ok = o.id JOIN c ON o.cid = c.id "
          "GROUP BY c.name, c.id, o.id, o.dt, o.price")


@pytest.mark.parametrize("batches", [1, 2])
def test_functional_dependence_reduces_keys_of_one_batch(batches):
    """Q18's shape: with one spine batch the five keys reduce to the
    orders key, a representative-row lane rebuilds the others on the host;
    with two batches nothing is reduced. Rows equal the JAX package's in
    both."""
    data = _fd_tables()
    port, ref = _pair({k: v for k, v in data.items() if k != "l"})
    ref.register_arrays("l0", data["l"])
    whole = ref.table("l0").collect()[0]
    n = whole.num_rows
    parts = [whole] if batches == 1 else \
        [whole.slice_host(0, n // 3), whole.slice_host(n // 3, n - n // 3)]
    ref.register_table("l", df.MemTable(whole.schema, [parts]))
    port.register_table("l", dft.MemTable(twin(whole.schema),
                                          [[twin(b) for b in parts]]))
    got = port.sql(FD_SQL).to_pydict()
    _same_rows(got, ref.sql(FD_SQL).to_pydict(), False)
    (ex,) = _execs(port, FD_SQL, TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0
    _spec, plan, names, _s, _inputs, _st = ex.prepare(port.task_context())
    if batches == 1:
        assert plan.dropped and [ex.group_exprs[p][1] for p in plan.kept] \
            == ["id"] and "__rep#x" in names
        assert ex.group_exprs[plan.kept[0]][0].index >= ex.n_spine
    else:
        assert not plan.dropped and "__rep#x" not in names
    assert len(got["qty"]) == len(set(data["l"]["ok"]))


def test_tpch_q10_q18_keys_are_reduced(tpch):
    """TPC-H Q18's five keys reduce to o_orderkey and Q10's seven to
    c_custkey, as the reference's `_fd_reduce` gives them."""
    port, _ref = tpch
    for q, kept in ((18, ["o_orderkey"]), (10, ["c_custkey"])):
        (ex,) = _execs(port, TPCH[q], TorchJoinChainAggregateExec)
        _spec, plan, _n, _s, _i, _st = ex.prepare(port.task_context())
        assert [ex.group_exprs[p][1] for p in plan.kept] == kept
        assert len(plan.dropped) == len(ex.group_exprs) - 1


@pytest.mark.parametrize("q,full", [(3, False), (4, False), (5, False),
                                    (10, False), (18, False), (7, True),
                                    (8, True), (9, True), (12, True),
                                    (14, True), (21, True)])
def test_tpch_walk_picks_the_interpreter_variant(tpch, q, full):
    """A walk whose programs stay within the opcodes below FULL_OPS_FROM
    launches the lean interpreter: Q3, Q4, Q5, and Q10 and Q18 with their
    representative lane. date_part (Q7, Q8, Q9), CASE (Q8, Q12, Q14) and a
    min/max hop (Q21) need the full one. Every TPC-H build is lean."""
    port, _ref = tpch
    (ex,) = _execs(port, TPCH[q], TorchJoinChainAggregateExec)
    spec, _p, _n, _s, _i, staged = ex.prepare(port.task_context())
    assert spec.full == full
    assert not any(s.spec.full for s in staged)
