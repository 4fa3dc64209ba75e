"""High-cardinality grouped aggregation: SQL through the port on the CPU
against the JAX package's device path.

`datafusion_tpu_torch.SessionContext(torch.device("cpu"))` runs the hash
path's plain PyTorch versions (`hash_group_aggregate`, `compact_groups`,
`group_topk`); the JAX package runs its sort, row-space, unbounded and
top-k routes on the CPU backend. Same seeded tables (`register_tpch` at
SF 0.01, `register_hits` at 50,000 rows, each built with its own
package's classes by `torch_twin`), same SQL. Rows must be equal;
where a LIMIT cuts among groups tied at the k-th count, the counts must
be equal and so must the groups beyond the k-th count.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu_torch.clickbench.workload import QUERIES as CB
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu.tpch.queries import QUERIES as TPCH
from datafusion_tpu_torch.physical.plan.base import collect
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchGroupAggregateExec)
from torch_twin import register_both, register_hits_both, register_tpch_both

CPU = torch.device("cpu")
Q18_SUB = ("select l_orderkey from lineitem group by l_orderkey "
           "having sum(l_quantity) > 300")
Q15_SUB = """select l_suppkey as supplier_no,
       sum(l_extendedprice * (1 - l_discount)) as total_revenue
from lineitem
where l_shipdate >= date '1996-01-01'
  and l_shipdate < date '1996-04-01'
group by l_suppkey"""


@pytest.fixture(scope="module")
def tpch():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01)
    return port, ref


@pytest.fixture(scope="module")
def hits():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_hits_both(port, ref, n=50_000)
    return port, ref


def _execs(ctx, q):
    out = []

    def walk(node):
        if isinstance(node, TorchGroupAggregateExec):
            out.append(node)
        for c in node.children():
            walk(c)
    walk(ctx.sql(q).create_physical_plan())
    return out


def _assert_on_port(ctx, q):
    execs = _execs(ctx, q)
    assert execs and all(e.fallbacks == 0 for e in execs), \
        [(e.display_line(), e.fallbacks) for e in execs]


@pytest.mark.parametrize("q", [
    TPCH[15], TPCH[18],
    f"select * from ({Q18_SUB}) order by l_orderkey",
    f"select * from ({Q15_SUB}) order by supplier_no",
], ids=["q15", "q18", "q18_sub", "q15_sub"])
def test_tpch_matches_jax_package(tpch, q):
    port, ref = tpch
    got = port.sql(q).to_pydict()
    assert got == ref.sql(q).to_pydict()
    assert len(next(iter(got.values()))) > 0
    _assert_on_port(port, q)


def _same_top(got, want, keys, count):
    assert got[count] == want[count]
    kth = want[count][-1]

    def beyond(r):
        return {tuple(r[c][i] for c in keys)
                for i, n in enumerate(r[count]) if n > kth}
    assert beyond(got) == beyond(want)


@pytest.mark.parametrize("i,keys", [(16, ["UserID"]),
                                    (17, ["UserID", "SearchPhrase"])])
def test_clickbench_topk_matches_jax_package(hits, i, keys):
    port, ref = hits
    got, want = port.sql(CB[i]).to_pydict(), ref.sql(CB[i]).to_pydict()
    _same_top(got, want, keys, "count(*)")
    assert len(got["count(*)"]) == 10
    _assert_on_port(port, CB[i])
    (ex,) = _execs(port, CB[i])
    assert ex.topk == (0, False, 10)


def test_clickbench_q18_is_a_subset_of_the_group_table(hits):
    """Q18 has a LIMIT and no ORDER BY: any 10 groups, with their counts."""
    port, ref = hits
    got = port.sql(CB[18]).to_pydict()
    full = ref.sql('SELECT "UserID", "SearchPhrase", COUNT(*) FROM hits '
                   'GROUP BY "UserID", "SearchPhrase"').to_pydict()
    table = {(u, s): c for u, s, c in zip(full["UserID"],
                                         full["SearchPhrase"],
                                         full["count(*)"])}
    rows = list(zip(got["UserID"], got["SearchPhrase"], got["count(*)"]))
    assert len(rows) == 10
    assert all(table[(u, s)] == c for u, s, c in rows)
    _assert_on_port(port, CB[18])


def test_twenty_thousand_groups_run_on_the_port():
    """The shape of test_device.py's group-table overflow case: 20,000
    groups of sum/count/min/max, where the reference's fixed table
    overflows into its unbounded route."""
    rng = np.random.default_rng(0)
    n = 50_000
    data = {"g": rng.integers(0, 20_000, n), "v": rng.integers(0, 100, n)}
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.register_arrays("t", data)
    q = ("SELECT g, sum(v) s, count(*) c, min(v) mn, max(v) mx FROM t "
         "GROUP BY g ORDER BY g")
    got = port.sql(q).to_pydict()
    assert got == ref.sql(q).to_pydict()
    assert len(got["g"]) == len(np.unique(data["g"]))
    _assert_on_port(port, q)


def test_explain_shows_fused_having_and_topk(tpch, hits):
    q18 = "\n".join(tpch[0].sql("EXPLAIN " + Q18_SUB).to_pydict()["plan"])
    q16 = "\n".join(hits[0].sql("EXPLAIN " + CB[16]).to_pydict()["plan"])
    assert "TorchGroupAggregateExec: gby=[l_orderkey]" in q18
    assert "having=(sum(lineitem.l_quantity)@1 > Int64(300))" in q18
    assert "FilterExec" not in q18
    assert "topk=[count(*) DESC LIMIT 10]" in q16
    assert "DeviceGroupAggregateExec" not in q18 + q16


def test_with_children_keeps_topk_and_having(tpch, hits):
    sub = _execs(tpch[0], Q18_SUB)[0]
    top = _execs(hits[0], CB[16])[0]
    for ex in (sub, top):
        again = ex.with_children(ex.children())
        assert (again.topk, again.post_filter, again.max_groups) == \
            (ex.topk, ex.post_filter, ex.max_groups)
        assert again.display_line() == ex.display_line()


def test_having_survives_transform_up(tpch):
    """A rule that rebuilds every node must not drop the fused HAVING: the
    FilterExec is gone from the plan."""
    port, ref = tpch
    plan = port.sql(Q18_SUB).create_physical_plan().transform_up(
        lambda node: node)
    (ex,) = [n for n in _walk(plan) if isinstance(n, TorchGroupAggregateExec)]
    assert ex.post_filter is not None
    got = sorted(int(k) for b in collect(plan, port.task_context())
                 for k in b.columns[0].data_host())
    want = sorted(ref.sql(Q18_SUB).to_pydict()["l_orderkey"])
    assert got == want and got


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def test_count_distinct_still_falls_back():
    """count(DISTINCT x) beside a sum, which the port once refused (hence
    the name): the query now takes the device path's distinct lane with
    no fallback, and still equals the JAX package."""
    rng = np.random.default_rng(1)
    n = 5_000
    data = {"g": rng.integers(0, 1_000, n), "x": rng.integers(0, 50, n),
            "v": rng.integers(0, 100, n)}
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.register_arrays("t", data)
    q = ("SELECT g, count(DISTINCT x) d, sum(v) s FROM t GROUP BY g "
         "ORDER BY g")
    assert port.sql(q).to_pydict() == ref.sql(q).to_pydict()
    (ex,) = _execs(port, q)
    assert ex.fallbacks == 0


def test_float32_sum_keeps_a_float32_lane():
    """Float32 sums on the hash path add in float32 (the JAX sparse path's
    width). Both are held against float64 numpy sums within abs 1e-3 (the
    port's per-group adds) and 0.5 (the JAX package's differences of one
    float32 running sum)."""
    rng = np.random.default_rng(2)
    n = 30_000
    k = rng.integers(0, 5_000, n) * 7
    f = (rng.normal(size=n) * 10).astype(np.float32)
    schema = Schema([Field("k", dt.INT64, False), Field("f", dt.FLOAT32, False)])
    batch = Batch(schema, [Column(dt.INT64, k), Column(dt.FLOAT32, f)], n)
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "t", batch)
    q = "SELECT k, sum(f) s, count(*) c FROM t GROUP BY k ORDER BY k"
    got, want = port.sql(q).to_pydict(), ref.sql(q).to_pydict()
    uk, inv = np.unique(k, return_inverse=True)
    oracle = np.zeros(len(uk))
    np.add.at(oracle, inv, f.astype(np.float64))
    assert got["k"] == want["k"] == uk.tolist()
    assert got["c"] == want["c"]
    np.testing.assert_allclose(got["s"], oracle, rtol=0, atol=1e-3)
    np.testing.assert_allclose(want["s"], oracle, rtol=0, atol=0.5)
    (ex,) = _execs(port, q)
    assert ex.fallbacks == 0
