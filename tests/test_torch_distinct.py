"""count(DISTINCT x) on the port's device path against the JAX package.

The port folds a count(DISTINCT x) as a lane of its grouped fold: each new
(group, value) pair in a set adds 1 to the group's lane (`device/groupby.py`,
`DistinctSet`). The JAX package sorts (key, value) pairs on its device path,
which takes one batch of at most 2^21 rows. Same seeded tables, same SQL,
through both packages on the CPU (the port's kernels run their plain
versions): dense keys (<= 64 slots), hash keys and no keys; int32, int64,
date, decimal, float32 and float64 arguments with -0.0 and 0.0, NaN and
NULLs; a predicate; dictionary-coded strings; mixed with sum, avg and
count; ClickBench Q10 at 300,000 rows; Q5 with a distinct count at SF 0.01
through the join chain. Counts, keys, integer and decimal sums are exact;
float averages within rel 1e-12 (summation order). Several batches and a
real INT64_MIN value are held against the host paths of both packages and
numpy, since the JAX package's device path takes neither (one batch; its
NULL marker is INT64_MIN).
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu_torch.clickbench.workload import QUERIES as CB
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchGroupAggregateExec)
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchJoinChainAggregateExec)
from torch_twin import (register_both, register_hits_both,
                        register_tpch_both, twin)

CPU = torch.device("cpu")
I64_MIN = np.iinfo(np.int64).min

Q5D = """select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       count(distinct o_custkey) as customers
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1995-01-01'
group by n_name order by revenue desc"""


def table(n, seed, strings=None):
    """A JAX-package batch of every argument type count(DISTINCT x) takes:
    `g` (1,000 hash keys), `g8` (6 dense keys), `i32` (NULLs), `i64`,
    `day`, `dec`, `f32` (-0.0, 0.0, NaN), `f64` (-0.0, 0.0, NaN, NULLs),
    `xn` (NULL in every row of dense group 3), `s` (dictionary codes) and
    `v` for the sums."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1000, n).astype(np.int64)
    g8 = rng.integers(0, 6, n).astype(np.int32)
    i32 = rng.integers(-50, 50, n).astype(np.int32)
    i64 = rng.integers(-20, 20, n).astype(np.int64) * 10**15
    day = rng.integers(8000, 8060, n).astype(np.int32)
    dec = rng.integers(-300, 300, n).astype(np.int64)
    f32 = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, 3.0, np.nan],
                              np.float32), n)
    f64 = rng.choice(np.array([-0.0, 0.0, 0.1, 0.2, 1e300, -1e-300,
                               np.nan]), n)
    xn = rng.integers(0, 30, n).astype(np.int64)
    s = rng.integers(0, 10, n).astype(np.int32)
    v = rng.integers(0, 100, n).astype(np.int64)
    dic = strings if strings is not None else Dictionary(
        np.array([f"s{i:02d}" for i in range(10)], dtype=object))
    cols = [("g", dt.INT64, g, None), ("g8", dt.INT32, g8, None),
            ("i32", dt.INT32, i32, rng.random(n) > 0.1),
            ("i64", dt.INT64, i64, None), ("day", dt.DATE, day, None),
            ("dec", dt.decimal(12, 2), dec, None),
            ("f32", dt.FLOAT32, f32, None),
            ("f64", dt.FLOAT64, f64, rng.random(n) > 0.1),
            ("xn", dt.INT64, xn, g8 != 3), ("s", dt.STRING, s, None),
            ("v", dt.INT64, v, None)]
    schema = Schema([Field(nm, t, valid is not None)
                     for nm, t, _d, valid in cols])
    return Batch(schema, [Column(t, d, valid, dic if t == dt.STRING else None)
                          for _nm, t, d, valid in cols], n)


def execs(ctx, q, kind=TorchGroupAggregateExec):
    out = []

    def walk(node):
        if isinstance(node, kind):
            out.append(node)
        for c in node.children():
            walk(c)
    plan = ctx.sql(q).create_physical_plan()
    walk(plan)
    return plan, out


def run_port(port, q, kind=TorchGroupAggregateExec):
    """The port's rows of `q` and its device execs of `kind` (the plan is
    cached per SQL text, so they are the execs that ran)."""
    out = port.sql(q).to_pydict()
    return out, execs(port, q, kind)[1]


def same(got, want, rel=1e-12):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=rel, nan_ok=True), k
            else:
                assert a == b, (k, a, b)


@pytest.fixture(scope="module")
def ctxs():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "t", table(20_000, 1))
    return port, ref


ARGS = "i32, i64, day, dec, f32, f64, xn"


def _distincts(args=ARGS):
    return ", ".join(f"count(DISTINCT {a}) d_{a}" for a in args.split(", "))


QUERIES = {
    "dense": f"SELECT g8, {_distincts()} FROM t GROUP BY g8 ORDER BY g8",
    "hash": f"SELECT g, {_distincts()} FROM t GROUP BY g ORDER BY g",
    "ungrouped": f"SELECT {_distincts()}, count(*) c FROM t",
    "predicate": f"SELECT g8, {_distincts('i32, f64')} FROM t "
                 "WHERE v > 30 AND g < 500 GROUP BY g8 ORDER BY g8",
    "strings": "SELECT g8, count(DISTINCT s) d, count(*) c FROM t "
               "GROUP BY g8 ORDER BY g8",
    "strings_hash": "SELECT g, count(DISTINCT s) d, count(*) c FROM t "
                    "GROUP BY g ORDER BY g",
    "mixed": "SELECT g, sum(v) s, avg(v) a, count(*) c, "
             "count(DISTINCT i32) d, count(DISTINCT v) dv FROM t "
             "GROUP BY g ORDER BY g",
    "mixed_dense": "SELECT g8, sum(dec) s, avg(f64) a, min(f32) mn, "
                   "count(f64) c, count(DISTINCT f32) d FROM t "
                   "GROUP BY g8 ORDER BY g8",
    "having": "SELECT g, count(DISTINCT i32) d, count(*) c FROM t "
              "GROUP BY g HAVING count(DISTINCT i32) > 17 ORDER BY g",
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_distinct_matches_jax(ctxs, name):
    port, ref = ctxs
    q = QUERIES[name]
    got, ex = run_port(port, q)
    same(got, ref.sql(q).to_pydict())
    assert ex and all(e.fallbacks == 0 for e in ex)


def test_negative_zero_and_nulls(ctxs):
    """-0.0 and 0.0 are one value; NULLs are not counted, and a group whose
    values are all NULL counts 0; numpy says the same."""
    port, _ref = ctxs
    t = table(20_000, 1)
    g8 = t.columns[1].data_host()
    f64, fv = t.columns[7].data_host(), t.columns[7].validity_host()
    got, _ex = run_port(port, "SELECT g8, count(DISTINCT f64) d, "
                        "count(DISTINCT xn) x FROM t GROUP BY g8 ORDER BY g8")
    for k, d, x in zip(got["g8"], got["d"], got["x"]):
        vals = f64[(g8 == k) & fv] + 0.0        # -0.0 + 0.0 is 0.0
        want = len(np.unique(vals[~np.isnan(vals)])) + bool(
            np.isnan(vals).any())
        assert d == want
        assert x == (0 if k == 3 else 30)


def test_clickbench_q10(tmp_path):
    """ClickBench Q10 at 300,000 rows: 5,000 RegionIDs, count(DISTINCT
    UserID) beside a sum, an avg and the count that the fused top-k
    orders by. The ten rows' counts equal the JAX package's; every row
    equals the numpy oracle of its RegionID (the tenth count is tied)."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_hits_both(port, ref, n=300_000)
    q = CB[10]
    got, ex = run_port(port, q)
    want = ref.sql(q).to_pydict()
    assert ex and all(e.fallbacks == 0 for e in ex) and ex[0].topk
    cols = list(want)
    assert got[cols[2]] == want[cols[2]]
    from datafusion_tpu.clickbench.workload import generate_hits
    h = generate_hits(300_000, 0)
    reg, user = h["RegionID"], h["UserID"]
    for i, r in enumerate(got[cols[0]]):
        m = reg == r
        assert got[cols[1]][i] == int(h["AdvEngineID"][m].sum())
        assert got[cols[2]][i] == int(m.sum())
        assert got[cols[3]][i] == pytest.approx(
            h["ResolutionWidth"][m].mean(), rel=1e-12)
        assert got[cols[4]][i] == len(np.unique(user[m]))


def test_q5_with_a_distinct_count_through_the_chain():
    """TPC-H Q5 with count(DISTINCT o_custkey) at SF 0.01 plans a join
    chain in both packages; the port's runs on the device path."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01)
    got, ex = run_port(port, Q5D, TorchJoinChainAggregateExec)
    same(got, ref.sql(Q5D).to_pydict())
    assert len(ex) == 1 and ex[0].fallbacks == 0
    assert "DeviceJoinChainAggregateExec" in \
        ref.sql(Q5D).create_physical_plan().display_indent()


def _batches(parts):
    """Three batches of one table; `i64` holds a real INT64_MIN."""
    out = []
    for i, b in enumerate(parts):
        d = b.columns[3].data_host().copy()
        d[::97] = I64_MIN
        cols = list(b.columns)
        cols[3] = Column(dt.INT64, d, None)
        out.append(Batch(b.schema, cols, b.num_rows))
    return out


def test_several_batches_and_int64_min():
    """Three batches (the JAX package's device path takes one) and a real
    INT64_MIN value (its device path's NULL marker): the port's device
    path, its host path, the JAX package (which runs these on its host
    path) and numpy all agree."""
    dic = Dictionary(np.array([f"s{i:02d}" for i in range(10)],
                              dtype=object))
    parts = _batches([table(7_000, s, dic) for s in (2, 3, 4)])
    port, host, ref = (dft.SessionContext(CPU), dft.SessionContext(CPU),
                       df.SessionContext())
    host.sql("SET datafusion.tpu.device_aggregate = false")
    schema = parts[0].schema
    ref.register_table("t", df.MemTable(schema, [parts]))
    for c in (port, host):
        tw = twin(parts)
        c.register_table("t", dft.MemTable(tw[0].schema, [tw]))
    q = ("SELECT g8, count(DISTINCT i64) a, count(DISTINCT f64) b, "
         "count(DISTINCT s) c, count(*) n FROM t GROUP BY g8 ORDER BY g8")
    got, ex = run_port(port, q)
    assert ex and ex[0].fallbacks == 0
    same(got, run_port(host, q)[0])
    same(got, ref.sql(q).to_pydict())
    g8 = np.concatenate([b.columns[1].data_host() for b in parts])
    i64 = np.concatenate([b.columns[3].data_host() for b in parts])
    assert (i64 == I64_MIN).any()
    for k, a in zip(got["g8"], got["a"]):
        assert a == len(np.unique(i64[g8 == k]))


def test_string_batches_with_different_dictionaries_fall_back():
    """A dictionary-coded argument counts codes: batches with different
    dictionaries run the host plan, with the JAX package's rows."""
    d1 = Dictionary(np.array([f"s{i:02d}" for i in range(10)], dtype=object))
    d2 = Dictionary(np.array([f"s{i:02d}" for i in range(5, 15)],
                             dtype=object))
    parts = [table(5_000, 5, d1), table(5_000, 6, d2)]
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    ref.register_table("t", df.MemTable(parts[0].schema, [parts]))
    tw = twin(parts)
    port.register_table("t", dft.MemTable(tw[0].schema, [tw]))
    q = ("SELECT g8, count(DISTINCT s) d, count(*) c FROM t GROUP BY g8 "
         "ORDER BY g8")
    got, ex = run_port(port, q)
    same(got, ref.sql(q).to_pydict())
    assert ex and ex[0].fallbacks == 1


def test_a_distinct_set_too_large_falls_back(monkeypatch):
    """A distinct set that would exceed MAX_DISTINCT_ENTRIES (24 GiB at
    its real value; 1,024 entries here) is refused before anything is
    allocated: the host plan runs, with the JAX package's rows."""
    from datafusion_tpu_torch.device import groupby
    monkeypatch.setattr(groupby, "MAX_DISTINCT_ENTRIES", 1024)
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "t", table(5_000, 7))
    q = QUERIES["mixed"]
    got, ex = run_port(port, q)
    same(got, ref.sql(q).to_pydict())
    assert ex and ex[0].fallbacks == 1
