"""The fanout-N join-aggregate: the port's TorchJoinAggregateExec against
the JAX package's DeviceJoinAggregateExec on the CPU.

One INNER hash join whose build key is not unique, under an aggregate: the
JAX package expands the pairs and folds them; the port walks each probe
row's bucket of a build multi-map and folds each pair (`device/join_agg.py`,
here through its plain versions). Same seeded tables, same SQL: TPC-H's
lineitem x partsupp shapes J1 (fanout 4, the part key) and J2 (Q9's
composite key) at SF 0.01; a build with fanouts 0, 1 and 4 and one hot key
of 1,000 rows, NULL keys on both sides, string keys with a different
dictionary on each side, build, probe and join-filter residuals, dense and
hash group keys, decimal and float sums, count(*), min and max (with NaN),
several probe batches. Keys, counts, integer and decimal sums must be
equal; float sums within rel 1e-12 (summation order). The plan checks hold
that the port plans its exec exactly where the JAX package plans its own,
and falls back where the JAX package's exec refuses.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu_torch.physical.plan.device_join_agg import (
    TorchJoinAggregateExec)
from test_torch_distinct import execs, same
from torch_twin import register_tpch_both, twin

CPU = torch.device("cpu")

J1 = ("SELECT ps_suppkey, count(*) AS c, sum(ps_supplycost * l_quantity) "
      "AS cost FROM lineitem JOIN partsupp ON l_partkey = ps_partkey "
      "GROUP BY ps_suppkey ORDER BY ps_suppkey")
J2 = ("SELECT ps_suppkey, sum(l_extendedprice * (1 - l_discount) - "
      "ps_supplycost * l_quantity) AS profit FROM lineitem JOIN partsupp "
      "ON ps_partkey = l_partkey AND ps_suppkey = l_suppkey "
      "GROUP BY ps_suppkey ORDER BY ps_suppkey")


def _build(seed=1):
    """b: keys 0..209 with fanout 0, 1 or 4 by key % 3, a hot key 500 of
    1,000 rows, and 12 rows with a NULL key."""
    rng = np.random.default_rng(seed)
    keys = [k for k in range(210) for _ in range((0, 1, 4)[k % 3])]
    keys += [500] * 1000 + [7] * 12
    n = len(keys)
    bk = np.asarray(keys, np.int64)
    bkv = np.ones(n, bool)
    bkv[-12:] = False
    bs = rng.integers(0, 8, n).astype(np.int32)
    dic = Dictionary(np.array(["ant", "bee", "cat", "dog", "eel", "fox",
                               "gnu", "hen"], dtype=object))
    bf = rng.normal(size=n)
    bf[rng.random(n) < 0.01] = np.nan
    cols = [("bk", dt.INT64, bk, bkv),
            ("bg", dt.INT32, rng.integers(0, 5, n).astype(np.int32), None),
            ("bw", dt.INT32, rng.integers(0, 300, n).astype(np.int32), None),
            ("bs", dt.STRING, bs, None),
            ("bd", dt.decimal(12, 2), rng.integers(0, 10**5, n), None),
            ("bf", dt.FLOAT64, bf, None)]
    return _batch(cols, n, dic)


def _probe(n, seed):
    """p: keys over 0..219 and the hot key, 5% NULL; its strings in a
    dictionary that differs from b's (some of b's absent, some new)."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 220, n).astype(np.int64)
    pk[rng.random(n) < 0.02] = 500
    ps = rng.integers(0, 6, n).astype(np.int32)
    dic = Dictionary(np.array(["ape", "bee", "cat", "elk", "fox", "yak"],
                              dtype=object))
    pf = rng.normal(size=n).astype(np.float32)
    cols = [("pk", dt.INT64, pk, rng.random(n) > 0.05),
            ("px", dt.INT64, rng.integers(0, 1000, n), None),
            ("ps", dt.STRING, ps, None),
            ("pd", dt.decimal(12, 2), rng.integers(-10**4, 10**4, n), None),
            ("pf", dt.FLOAT32, pf, None)]
    return _batch(cols, n, dic)


def _head(b, n):
    """The first n rows of batch b."""
    return Batch(b.schema, [Column(c.dtype, c.data_host()[:n],
                                   None if c.validity_host() is None
                                   else c.validity_host()[:n], c.dictionary)
                            for c in b.columns], n)


def _batch(cols, n, dic):
    schema = Schema([Field(nm, t, v is not None) for nm, t, _d, v in cols])
    return Batch(schema, [Column(t, np.asarray(d), v,
                                 dic if t == dt.STRING else None)
                          for _nm, t, d, v in cols], n)


def _register(port, ref, name, parts):
    ref.register_table(name, df.MemTable(parts[0].schema, [parts]))
    tw = twin(parts)
    port.register_table(name, dft.MemTable(tw[0].schema, [tw]))


@pytest.fixture(scope="module")
def ctxs():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    _register(port, ref, "b", [_build()])
    _register(port, ref, "p", [_probe(6_000, 2)])
    _register(port, ref, "pm", [_probe(3_000, s) for s in (3, 4, 5)])
    _register(port, ref, "bsm", [_head(_build(), 40)])
    return port, ref


ON = "FROM p JOIN b ON p.pk = b.bk"
QUERIES = {
    "hash_keys": f"SELECT b.bw, count(*) c, sum(p.pd * b.bd) s, "
                 f"sum(p.pf) f, min(p.px) mn, max(b.bd) mx "
                 f"{ON} GROUP BY b.bw ORDER BY b.bw",
    "dense_keys": f"SELECT b.bg, count(*) c, sum(p.pd) s, avg(p.px) a, "
                  f"min(b.bd) mn, max(p.pd) mx {ON} GROUP BY b.bg "
                  "ORDER BY b.bg",
    "probe_key_group": f"SELECT p.pk, count(*) c, sum(b.bw) s {ON} "
                       "GROUP BY p.pk ORDER BY p.pk",
    "two_sides": f"SELECT b.bg, p.ps, count(*) c, sum(p.px * b.bw) s {ON} "
                 "GROUP BY b.bg, p.ps ORDER BY b.bg, p.ps",
    "ungrouped": f"SELECT count(*) c, sum(b.bd) s, sum(p.pf) f {ON}",
    "build_filter": f"SELECT b.bg, count(*) c, sum(p.px) s {ON} "
                    "WHERE b.bw > 100 GROUP BY b.bg ORDER BY b.bg",
    "probe_filter": f"SELECT b.bw, count(*) c {ON} WHERE p.px < 300 "
                    "GROUP BY b.bw ORDER BY b.bw",
    "join_filter": "SELECT b.bg, count(*) c, sum(p.pd) s FROM p JOIN b "
                   "ON p.pk = b.bk AND p.px > b.bw * 3 GROUP BY b.bg "
                   "ORDER BY b.bg",
    "residual": f"SELECT b.bg, count(*) c {ON} WHERE p.px + b.bw > 700 "
                "GROUP BY b.bg ORDER BY b.bg",
    "string_keys": "SELECT b.bg, count(*) c, sum(p.px) s FROM p JOIN b "
                   "ON p.ps = b.bs GROUP BY b.bg ORDER BY b.bg",
    "string_group_key": f"SELECT b.bs, count(*) c {ON} GROUP BY b.bs "
                        "ORDER BY b.bs",
    "composite_keys": "SELECT b.bg, count(*) c, sum(p.px) s FROM p JOIN b "
                      "ON p.pk = b.bk AND p.ps = b.bs GROUP BY b.bg "
                      "ORDER BY b.bg",
    "probe_batches": "SELECT b.bw, count(*) c, sum(pm.pd) s, sum(pm.pf) f "
                     "FROM pm JOIN b ON pm.pk = b.bk GROUP BY b.bw "
                     "ORDER BY b.bw",
    "nan_min_max_dense": f"SELECT b.bg, min(b.bf) mn, max(b.bf) mx {ON} "
                         "GROUP BY b.bg ORDER BY b.bg",
    "nan_min_max_hash": f"SELECT b.bw, min(b.bf) mn, max(b.bf) mx {ON} "
                        "GROUP BY b.bw ORDER BY b.bw",
}


def _ref_plans_join_agg(ref, q) -> bool:
    return "DeviceJoinAggregateExec" in \
        ref.sql(q).create_physical_plan().display_indent()


@pytest.mark.parametrize("name", list(QUERIES))
def test_join_aggregate_matches_jax(ctxs, name):
    port, ref = ctxs
    q = QUERIES[name]
    want = ref.sql(q).to_pydict()
    got = port.sql(q).to_pydict()
    same(got, want)
    _plan, ex = execs(port, q, TorchJoinAggregateExec)
    assert _ref_plans_join_agg(ref, q)
    assert len(ex) == 1 and ex[0].fallbacks == 0


@pytest.mark.parametrize("name,q", [("J1", J1), ("J2", J2)])
def test_tpch_fanout_shapes(name, q):
    """J1 (every lineitem row meets its part's 4 partsupp rows) and J2
    (Q9's composite key, fanout 1 through two keys) at SF 0.01."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01)
    same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
    _plan, ex = execs(port, q, TorchJoinAggregateExec)
    assert _ref_plans_join_agg(ref, q)
    assert len(ex) == 1 and ex[0].fallbacks == 0


REFUSED = {
    # the exec refuses these at run time in both packages
    "distinct": (f"SELECT b.bg, count(DISTINCT p.px) d, count(*) c {ON} "
                 "GROUP BY b.bg ORDER BY b.bg", True),
    "probe_string_key_batches": ("SELECT pm.ps, count(*) c FROM bsm JOIN "
                                 "pm ON pm.pk = bsm.bk GROUP BY pm.ps "
                                 "ORDER BY pm.ps", True),
    # the rule plans neither package's exec for these
    "string_min": (f"SELECT b.bg, min(b.bs) m {ON} GROUP BY b.bg "
                   "ORDER BY b.bg", False),
    "filter_clause": (f"SELECT b.bg, count(*) FILTER (WHERE p.px > 5) c "
                      f"{ON} GROUP BY b.bg ORDER BY b.bg", False),
    "left_join": ("SELECT b.bg, count(*) c FROM p LEFT JOIN b "
                  "ON p.pk = b.bk GROUP BY b.bg ORDER BY b.bg", False),
    "unique_build": ("SELECT b.bg, count(*) c FROM p JOIN "
                     "(SELECT bk, min(bg) bg FROM b GROUP BY bk) b "
                     "ON p.pk = b.bk GROUP BY b.bg ORDER BY b.bg", False),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_plans_and_refusals_match_jax(ctxs, name):
    """The port plans TorchJoinAggregateExec exactly where the JAX package
    plans DeviceJoinAggregateExec; where that exec refuses the shape, the
    port's falls back once, and the rows still agree."""
    port, ref = ctxs
    q, planned = REFUSED[name]
    same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
    _plan, ex = execs(port, q, TorchJoinAggregateExec)
    assert _ref_plans_join_agg(ref, q) == planned == bool(ex)
    if planned:
        assert ex[0].fallbacks == 1


def test_having_against_the_host_path(ctxs):
    """A HAVING fused into the exec (`compact_groups`). The JAX package
    fuses it into its join exec too and then fails there (its
    DeviceJoinAggregateExec has no `topk`), so the port is held to its own
    host path."""
    port, _ref = ctxs
    host = dft.SessionContext(CPU)
    host.sql("SET datafusion.tpu.device_aggregate = false")
    for name, part in (("b", _build()), ("p", _probe(6_000, 2))):
        tw = twin(part)
        host.register_table(name, dft.MemTable(tw.schema, [[tw]]))
    q = (f"SELECT b.bw, count(*) c, sum(p.px) s {ON} GROUP BY b.bw "
         "HAVING count(*) > 60 ORDER BY b.bw")
    got = port.sql(q).to_pydict()
    same(got, host.sql(q).to_pydict())
    assert got["c"] and min(got["c"]) > 60
    _plan, ex = execs(port, q, TorchJoinAggregateExec)
    assert len(ex) == 1 and ex[0].fallbacks == 0 and ex[0].post_filter


def test_empty_sides(ctxs):
    """A probe side or a build side that keeps no row: no groups, and one
    row of zeros and NULLs when ungrouped, as in the JAX package."""
    port, ref = ctxs
    for q in (f"SELECT b.bg, count(*) c {ON} WHERE p.px < 0 GROUP BY b.bg",
              f"SELECT count(*) c, sum(p.px) s {ON} WHERE b.bw < 0",
              f"SELECT count(*) c, sum(p.px) s {ON} WHERE p.px > 5000"):
        same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
        _plan, ex = execs(port, q, TorchJoinAggregateExec)
        assert len(ex) == 1 and ex[0].fallbacks == 0


def test_two_join_aggregates_in_one_query(ctxs):
    """Two join-aggregates that differ only in their build predicate, in
    one query: each stages its own build side, and EXPLAIN shows both
    predicates."""
    port, ref = ctxs
    q = (f"SELECT count(*) c, sum(p.px) s {ON} WHERE b.bw > 100 UNION ALL "
         f"SELECT count(*) c, sum(p.px) s {ON} WHERE b.bw > 200")
    got = port.sql(q).to_pydict()
    same(got, ref.sql(q).to_pydict())
    assert got["c"][0] != got["c"][1]
    _plan, ex = execs(port, q, TorchJoinAggregateExec)
    assert len(ex) == 2 and all(e.fallbacks == 0 for e in ex)
    shown = [e.display_line() for e in ex]
    assert any("100" in d for d in shown) and \
        any("200" in d for d in shown)
