"""The port's mesh execs against the JAX package's, through SQL on the CPU.

Every case of `tests/test_distributed_sql.py` runs the same seeded data
through both packages under `SET datafusion.tpu.mesh_devices = 8`: the
JAX package on its 8-device CPU mesh (`tests/conftest.py`), the port on
an 8-shard `LocalMesh` on the CPU (its kernels' plain versions). Each case
holds the port's rows to the reference's (and to pandas where the
reference's test does): keys, counts and integer or decimal sums exactly,
float sums and averages within rel 1e-9. A spy records which distributed
function ran in the JAX package (`distributed_group_aggregate`,
`distributed_shuffle_group_aggregate`, `distributed_join_group_aggregate`,
`distributed_partitioned_join_aggregate` with its salt) and the port's
execs record their routes; the two must agree.

Added here: the HAVING case (the port filters; the reference drops the
HAVING under a mesh, `ROADMAP.md` queue 3, so the port is held to its
own host path and to `mesh_devices = 0`), the automatic mesh on a CPU
session given an 8-shard mesh, a salted partitioned join, and TPC-H Q1
and a lineitem x partsupp join at SF 0.01 on each route.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.parallel import distributed as jd
from datafusion_tpu.parallel import exchange as jx
from datafusion_tpu_torch.parallel import LocalMesh
from datafusion_tpu_torch.physical.plan.distributed_aggregate import (
    TorchDistributedAggregateExec)
from torch_twin import register_both, register_tpch_both

CPU = torch.device("cpu")
_ROUTES = {jd: ("distributed_group_aggregate",
                "distributed_join_group_aggregate"),
           jx: ("distributed_shuffle_group_aggregate",
                "distributed_partitioned_join_aggregate")}


@pytest.fixture()
def both(monkeypatch):
    """(JAX-package context, port context, the JAX routes taken), both at
    mesh_devices = 8."""
    calls = []
    for mod, names in _ROUTES.items():
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **k):
                calls.append((_name, int(k.get("salt", 1))))
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    ref, port = df.SessionContext(), dft.SessionContext(CPU)
    for c in (ref, port):
        c.config.set("datafusion.tpu.mesh_devices", 8)
    return ref, port, calls


def _mesh_execs(port, sql):
    todo, out = [port.sql(sql).create_physical_plan()], []
    while todo:
        n = todo.pop()
        if isinstance(n, TorchDistributedAggregateExec):
            out.append(n)
        todo += n.children()
    return out


def _run(both, sql):
    """Both packages' rows of `sql`, after checking the routes agree and
    that the port's mesh execs did not fall back."""
    ref, port, calls = both
    calls.clear()
    want = ref.sql(sql).to_pydict()
    for ex in _mesh_execs(port, sql):
        ex.routes.clear()
    got = port.sql(sql).to_pydict()
    execs = _mesh_execs(port, sql)
    routes = [r for ex in execs for r in ex.routes]
    assert routes == calls, (routes, calls)
    # each exec that ran on the mesh took one route
    assert sum(ex.fallbacks == 0 for ex in execs) == len(routes)
    return got, want, routes


def _same(got, want, rel=1e-9):
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float) and b == b:
                assert a == pytest.approx(b, rel=rel, abs=1e-9), k
            else:
                assert a == b, k


def test_group_by_matches_jax_and_pandas(both):
    rng = np.random.default_rng(1)
    n = 50_000
    g = rng.integers(0, 30, n)
    v = rng.normal(5, 2, n)
    x = rng.integers(0, 500, n)
    s = rng.choice(["p", "q", "r"], n).astype(object)
    for c in both[:2]:
        c.register_arrays("t", {"g": g, "v": v, "x": x, "s": s})
    sql = ("SELECT g, s, count(*) c, sum(v) sv, avg(v) av, min(x) mn, "
           "max(x) mx FROM t WHERE x > 50 GROUP BY g, s ORDER BY g, s")
    got, want, routes = _run(both, sql)
    assert routes == [("distributed_group_aggregate", 1)]
    _same(got, want)
    pdf = pd.DataFrame({"g": g, "v": v, "x": x, "s": s})
    exp = pdf[pdf.x > 50].groupby(["g", "s"]).agg(
        c=("v", "size"), sv=("v", "sum")).reset_index()
    assert got["c"] == exp["c"].tolist()
    np.testing.assert_allclose(got["sv"], exp["sv"], rtol=1e-9)


def test_nullable_keys_and_args(both):
    g = np.array([1, 1, 2, 2, 3], np.int64)
    gv = np.array([True, True, True, False, True])
    v = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
    vv = np.array([True, False, True, True, True])
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    schema = Schema([Field("g", dt.INT64, True), Field("v", dt.FLOAT64, True)])
    batch = Batch(schema, [Column(dt.INT64, g, gv), Column(dt.FLOAT64, v, vv)])
    register_both(both[1], both[0], "t", batch)
    got, want, routes = _run(
        both, "SELECT g, count(v) c, sum(v) s FROM t GROUP BY g "
              "ORDER BY g NULLS FIRST")
    assert routes == [("distributed_group_aggregate", 1)]
    assert got == want == {"g": [None, 1, 2, 3], "c": [1, 1, 1, 1],
                           "s": [40.0, 10.0, 30.0, 50.0]}


def test_scalar_aggregate(both):
    for c in both[:2]:
        c.register_arrays("t", {"v": np.arange(10_001, dtype=np.float64)})
    got, want, routes = _run(both, "SELECT sum(v) s, count(*) c FROM t")
    assert routes == [("distributed_group_aggregate", 1)]
    assert got == want == {"s": [10_001 * 10_000 / 2], "c": [10_001]}


def test_falls_back_for_median(both):
    for c in both[:2]:
        c.register_arrays("t", {"g": [1, 1, 2], "v": [1.0, 3.0, 5.0]})
    got, want, routes = _run(
        both, "SELECT g, median(v) m FROM t GROUP BY g ORDER BY g")
    assert routes == []
    assert got == want == {"g": [1, 2], "m": [2.0, 5.0]}


@pytest.mark.parametrize("agg", ["count(DISTINCT v)", "sum(v) FILTER "
                                 "(WHERE v > 1)", "min(s)"])
def test_refused_shapes_take_the_host_plan(both, agg):
    """DISTINCT, FILTER and string min/max never run on the mesh: FILTER
    and string min/max are not planned there (`UseDeviceAggregate`'s
    admission, `physical_optimizer.py:42-61`), and the two-level plan of a
    DISTINCT groups by the float argument, which both packages refuse
    (`distributed_aggregate.py:240-243`) and run on the host."""
    for c in both[:2]:
        c.register_arrays("t", {"g": [1, 1, 2, 2], "v": [1.0, 3.0, 3.0, 5.0],
                                "s": ["a", "b", "c", "d"]})
    sql = f"SELECT g, {agg} a FROM t GROUP BY g ORDER BY g"
    got, want, _routes = _run(both, sql)
    assert got == want
    execs = _mesh_execs(both[1], sql)
    assert bool(execs) == agg.startswith("count")
    assert all(ex.fallbacks == 0 for ex in execs[:1])
    assert all(ex.fallbacks == 1 for ex in execs[1:])


def test_join_aggregate_matches_jax_and_pandas(both):
    rng = np.random.default_rng(7)
    n, nb = 20_000, 400
    bkey = np.concatenate([np.arange(nb), rng.integers(0, nb, 100)])
    btype = rng.choice(["A", "B", "C"], len(bkey)).astype(object)
    pkey = rng.integers(0, nb * 2, n)
    qty = rng.random(n) * 10
    flag = rng.choice(["x", "y"], n).astype(object)
    for c in both[:2]:
        c.register_arrays("part", {"p_partkey": bkey, "p_type": btype})
        c.register_arrays("li", {"l_partkey": pkey, "l_qty": qty,
                                 "l_flag": flag})
    sql = ("SELECT p_type, l_flag, count(*) c, sum(l_qty) s, avg(l_qty) a, "
           "min(l_qty) mn, max(l_qty) mx FROM li JOIN part ON p_partkey = "
           "l_partkey WHERE l_qty > 1.0 GROUP BY p_type, l_flag "
           "ORDER BY p_type, l_flag")
    got, want, routes = _run(both, sql)
    assert routes == [("distributed_join_group_aggregate", 1)]
    _same(got, want)
    li = pd.DataFrame({"l_partkey": pkey, "l_qty": qty, "l_flag": flag})
    part = pd.DataFrame({"p_partkey": bkey, "p_type": btype})
    j = li[li.l_qty > 1.0].merge(part, left_on="l_partkey",
                                 right_on="p_partkey")
    exp = j.groupby(["p_type", "l_flag"]).agg(c=("l_qty", "size"))
    assert got["c"] == exp["c"].tolist()


def test_join_build_side_group_and_arg(both):
    for c in both[:2]:
        c.register_arrays("d", {"k": [1, 2, 3], "grp": ["g1", "g2", "g1"],
                                "w": [100.0, 200.0, 300.0]})
        c.register_arrays("f", {"fk": [1, 1, 2, 3, 3, 3, 9]})
    got, want, routes = _run(
        both, "SELECT grp, count(*) c, sum(w) s FROM f JOIN d ON k = fk "
              "GROUP BY grp ORDER BY grp")
    assert routes == [("distributed_join_group_aggregate", 1)]
    assert got == want == {"grp": ["g1", "g2"], "c": [5, 1],
                           "s": [2 * 100.0 + 3 * 300.0, 200.0]}


def test_join_scalar_aggregate(both):
    for c in both[:2]:
        c.register_arrays("dim", {"k": np.arange(50)})
        c.register_arrays("fact", {"fk": np.arange(100) % 60,
                                   "v": np.ones(100)})
    got, want, routes = _run(
        both, "SELECT count(*) c, sum(v) s FROM fact JOIN dim ON k = fk")
    assert routes == [("distributed_join_group_aggregate", 1)]
    exp_c = int(np.sum((np.arange(100) % 60) < 50))
    assert got == want == {"c": [exp_c], "s": [float(exp_c)]}


@pytest.mark.parametrize("threshold", [131072, 1])
def test_join_null_keys_never_match(both, threshold):
    """NULL join keys match nothing on either join route."""
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    k = np.array([1, 2, 3], np.int64)
    kv = np.array([True, False, True])
    schema = Schema([Field("k", dt.INT64, True)])
    register_both(both[1], both[0], "d",
                  Batch(schema, [Column(dt.INT64, k, kv)]))
    fk = np.array([1, 2, 2, 3], np.int64)
    fkv = np.array([True, True, False, True])
    fschema = Schema([Field("fk", dt.INT64, True)])
    register_both(both[1], both[0], "f",
                  Batch(fschema, [Column(dt.INT64, fk, fkv)]))
    for c in both[:2]:
        c.config.set("datafusion.optimizer."
                     "hash_join_single_partition_threshold_rows", threshold)
    got, want, routes = _run(both, "SELECT count(*) c FROM f JOIN d "
                                   "ON k = fk")
    assert routes[0][0] == ("distributed_join_group_aggregate"
                            if threshold > 1 else
                            "distributed_partitioned_join_aggregate")
    assert got == want == {"c": [2]}


def test_high_cardinality_shuffle(both):
    rng = np.random.default_rng(9)
    n = 60_000
    g = rng.integers(0, 20_000, n)
    v = rng.integers(0, 100, n)
    for c in both[:2]:
        c.register_arrays("hc", {"g": g, "v": v})
    got, want, routes = _run(both, "SELECT g, count(*) c, sum(v) sv "
                                   "FROM hc GROUP BY g ORDER BY g")
    assert routes == [("distributed_shuffle_group_aggregate", 1)]
    assert got == want
    pdf = pd.DataFrame({"g": g, "v": v}).groupby("g").agg(
        sv=("v", "sum")).reset_index()
    assert got["sv"] == pdf["sv"].tolist()


@pytest.mark.parametrize("hot", [False, True])
def test_partitioned_join_by_stats(both, hot):
    """A build side above the threshold takes the partitioned join; a hot
    probe key salts it (the same salt in both packages)."""
    rng = np.random.default_rng(13)
    nb, n = 2_000, 40_000
    fk = rng.integers(0, 600, n)
    if hot:
        fk[rng.random(n) < 0.7] = 7
    for c in both[:2]:
        c.config.set("datafusion.optimizer."
                     "hash_join_single_partition_threshold_rows", 64)
        c.register_arrays("dim", {"k": np.arange(nb) % 500,
                                  "w": np.arange(nb) % 9})
        c.register_arrays("fact", {"fk": fk, "g": np.arange(n) % 16,
                                   "v": np.arange(n) % 9})
    got, want, routes = _run(both, "SELECT g, sum(v) s, sum(w) sw, "
                                   "count(*) c FROM fact JOIN dim ON k = fk "
                                   "GROUP BY g ORDER BY g")
    assert routes[0][0] == "distributed_partitioned_join_aggregate"
    assert (routes[0][1] > 1) == hot
    assert got == want
    f = pd.DataFrame({"fk": fk, "g": np.arange(n) % 16, "v": np.arange(n) % 9})
    d = pd.DataFrame({"k": np.arange(nb) % 500, "w": np.arange(nb) % 9})
    exp = f.merge(d, left_on="fk", right_on="k").groupby("g").agg(
        s=("v", "sum"), sw=("w", "sum")).reset_index()
    assert got["s"] == exp["s"].tolist() and got["sw"] == exp["sw"].tolist()


def test_having_under_a_mesh_filters():
    """The reference applies a fused HAVING only in `_emit`, which its
    mesh execs bypass, so under a mesh it returns every group; the port
    applies it. Held to the port's host path and to mesh_devices = 0."""
    sql = ("SELECT g, count(*) c, sum(v) s FROM t WHERE v < 995 GROUP BY g "
           "HAVING sum(v) > 49500 ORDER BY g")
    data = {"g": np.arange(1000) % 10, "v": np.arange(1000)}
    outs = []
    for mesh, device_agg in ((8, True), (0, True), (8, False)):
        ctx = dft.SessionContext(CPU)
        ctx.config.set("datafusion.tpu.mesh_devices", mesh)
        ctx.config.set("datafusion.tpu.device_aggregate", device_agg)
        ctx.register_arrays("t", data)
        outs.append(ctx.sql(sql).to_pydict())
        if mesh and device_agg:
            (ex,) = _mesh_execs(ctx, sql)
            assert ex.post_filter is not None and ex.fallbacks == 0
            assert ex.routes == [("distributed_group_aggregate", 1)]
    assert outs[0] == outs[1] == outs[2]
    assert outs[0]["g"] == [1, 2, 3, 4]


def test_auto_mesh_from_stats(monkeypatch):
    """No SET: the optimizer shards over the session's 8 devices because
    the source bytes pass `auto_mesh_min_bytes` (a CPU session counts the
    shards of the mesh it was given)."""
    rng = np.random.default_rng(7)
    n = 200_000
    data = {"g": rng.integers(0, 50, n), "v": rng.integers(0, 1000, n)}
    ref = df.SessionContext()
    port = dft.SessionContext(CPU, mesh=LocalMesh(8, CPU))
    calls = []
    orig = jd.distributed_group_aggregate

    def spy(*a, **k):
        calls.append("distributed_group_aggregate")
        return orig(*a, **k)
    monkeypatch.setattr(jd, "distributed_group_aggregate", spy)
    for c in (ref, port):
        c.config.set("datafusion.tpu.auto_mesh_min_bytes", 1 << 20)
        c.register_arrays("big", data)
    sql = "SELECT g, sum(v) s FROM big GROUP BY g ORDER BY g"
    (ex,) = _mesh_execs(port, sql)
    assert ex.mesh_devices == 8 and ex.the_mesh() is port.mesh
    want, got = ref.sql(sql).to_pydict(), port.sql(sql).to_pydict()
    assert got == want and len(got["g"]) == 50
    assert calls and ex.routes == [("distributed_group_aggregate", 1)]


@pytest.mark.parametrize("mesh", [None, 1, 8])
def test_auto_mesh_not_for_small_tables_or_one_device(mesh):
    """A small table never shards; nor does a big one on a session of one
    device (a CPU session without a mesh, or with a one-shard mesh)."""
    ctx = dft.SessionContext(CPU, mesh=None if mesh is None
                             else LocalMesh(mesh, CPU))
    ctx.register_arrays("small", {"g": np.arange(100) % 5,
                                  "v": np.arange(100)})
    ctx.register_arrays("big", {"g": np.arange(200_000) % 5,
                                "v": np.arange(200_000)})
    ctx.config.set("datafusion.tpu.auto_mesh_min_bytes", 1 << 20)
    assert not _mesh_execs(ctx, "SELECT g, sum(v) FROM small GROUP BY g")
    big = _mesh_execs(ctx, "SELECT g, sum(v) FROM big GROUP BY g")
    assert bool(big) == (mesh == 8)


@pytest.mark.parametrize("threshold", [131072, 64])
@pytest.mark.parametrize("q", ["q1", "join"])
def test_tpch_on_a_mesh(both, q, threshold):
    """TPC-H Q1 (string keys, decimal sums) and lineitem x partsupp on the
    part key (fanout 4) at SF 0.01, on each join route. The join sums one
    argument of each side: an argument over both sides (J1's
    `ps_supplycost * l_quantity`) is refused on the mesh by both packages
    (`distributed_aggregate.py:355`), which `test_join_spanning_argument_
    takes_the_host_plan` holds."""
    from datafusion_tpu.tpch.queries import QUERIES
    ref, port, _calls = both
    register_tpch_both(port, ref, sf=0.01, seed=0)
    for c in (ref, port):
        c.config.set("datafusion.optimizer."
                     "hash_join_single_partition_threshold_rows", threshold)
    sql = QUERIES[1] if q == "q1" else (
        "SELECT ps_suppkey, count(*) AS c, sum(l_quantity) AS qty, "
        "max(ps_supplycost) AS mx FROM lineitem JOIN partsupp ON "
        "l_partkey = ps_partkey GROUP BY ps_suppkey ORDER BY ps_suppkey")
    got, want, routes = _run(both, sql)
    assert routes
    if q == "join":
        assert routes[0][0] == ("distributed_join_group_aggregate"
                                if threshold > 64 else
                                "distributed_partitioned_join_aggregate")
    _same(got, want)


def test_join_spanning_argument_takes_the_host_plan(both):
    """J1's `sum(ps_supplycost * l_quantity)` reads both join sides: both
    packages refuse it on the mesh and run the host plan."""
    ref, port, _calls = both
    register_tpch_both(port, ref, sf=0.01, seed=0)
    sql = ("SELECT ps_suppkey, count(*) AS c, sum(ps_supplycost * "
           "l_quantity) AS cost FROM lineitem JOIN partsupp ON l_partkey = "
           "ps_partkey GROUP BY ps_suppkey ORDER BY ps_suppkey")
    got, want, routes = _run(both, sql)
    assert routes == []
    assert [ex.fallbacks for ex in _mesh_execs(port, sql)] == [1]
    _same(got, want)
