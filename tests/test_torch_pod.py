"""The port's multi-process pod (`datafusion_tpu_torch/parallel/pod.py`,
`pod_worker.py`) against the JAX package's: every case of `test_pod.py`
through `LocalPod(2, device="cpu")`, the wire format byte for byte, and
`_unfuse` on the port's device execs."""
import json

import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.parallel.pod import batch_to_wire as ref_batch_to_wire
from datafusion_tpu_torch.parallel.pod import (LocalPod, _unfuse,
                                               batch_from_wire, batch_to_wire)
from datafusion_tpu_torch.physical.plan.base import collect_batch
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchDeviceExec)
from datafusion_tpu_torch.proto.physical import phys_from_dict, phys_to_dict
from datafusion_tpu_torch.tpch.datagen import register_tpch
from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH

CPU = torch.device("cpu")
SQL = [
    "SELECT g, sum(v) sv, count(*) c, avg(f) af FROM t GROUP BY g "
    "ORDER BY g",
    "SELECT s, min(v) mn, max(v) mx FROM t WHERE v % 2 = 0 GROUP BY s "
    "ORDER BY s",
]


def _make_batch(pkg, n, seed=0):
    """`test_pod.py`'s table, through the session of `pkg`."""
    rng = np.random.default_rng(seed)
    ctx = pkg.SessionContext(CPU) if pkg is dft else pkg.SessionContext()
    ctx.register_arrays("t", {
        "g": rng.integers(0, 7, n),
        "s": np.array([f"k{i % 3}" for i in range(n)]),
        "v": rng.integers(0, 100, n).astype(np.int64),
        "f": rng.random(n),
    })
    return ctx, ctx.sql("SELECT * FROM t").collect_batch()


def test_pod_roundtrip_wire():
    _ctx, batch = _make_batch(dft, 100)
    meta, blobs = batch_to_wire(batch)
    back = batch_from_wire(meta, blobs)
    assert back.num_rows == batch.num_rows
    for a, b in zip(batch.columns, back.columns):
        assert a.to_pylist(batch.num_rows) == b.to_pylist(back.num_rows)


def test_wire_bytes_match_jax_package():
    _c, port = _make_batch(dft, 100, seed=4)
    _r, ref = _make_batch(df, 100, seed=4)
    meta, blobs = batch_to_wire(port)
    want_meta, want_blobs = ref_batch_to_wire(ref)
    assert json.dumps(meta) == json.dumps(want_meta)
    assert [bytes(b) for b in blobs] == [bytes(b) for b in want_blobs]


def test_physical_plan_json_roundtrip():
    ctx, _ = _make_batch(dft, 50)
    plan = ctx.sql(
        "SELECT g, sum(v) s, count(*) c FROM t WHERE v > 10 GROUP BY g"
    ).create_physical_plan()
    assert isinstance(plan, TorchDeviceExec) or any(
        isinstance(c, TorchDeviceExec) for c in plan.children())
    d = phys_to_dict(plan, {id(ctx.get_table("t")): "t"})
    back = phys_from_dict(d, ctx)
    r1 = collect_batch(plan, ctx.task_context())
    r2 = collect_batch(back, ctx.task_context())
    assert sorted(map(tuple, zip(*[c.to_pylist(r1.num_rows)
                                   for c in r1.columns]))) == \
        sorted(map(tuple, zip(*[c.to_pylist(r2.num_rows)
                                for c in r2.columns])))


@pytest.fixture(scope="module")
def pod():
    ctx, batch = _make_batch(dft, 5000, seed=3)
    with LocalPod(n_workers=2, device="cpu") as p:
        p.register_sharded("t", batch)
        yield p, ctx


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, e = got[k], want[k]
        if e and isinstance(e[0], float):
            # distributed float sums reassociate: last-ulp differences
            np.testing.assert_allclose(g, e, rtol=1e-12)
        else:
            assert g == e, k


@pytest.mark.parametrize("sql", SQL)
def test_pod_distributed_aggregate(pod, sql):
    """End to end: the coordinator plans, 2 worker processes execute the
    shipped fragments, shuffle over sockets; the answer is the
    single-process one, and the JAX package's."""
    p, ctx = pod
    expected = ctx.sql(sql).to_pydict()
    ref, _ = _make_batch(df, 5000, seed=3)
    _same(expected, ref.sql(sql).to_pydict())
    got = p.sql_distributed(ctx, sql)
    _same({f.name: c.to_pylist(got.num_rows)
           for f, c in zip(got.schema, got.columns)}, expected)


def test_pod_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default pod starts")
    with pytest.raises(RuntimeError, match="before it listened"):
        LocalPod(1)


def _execs(plan):
    yield plan
    for c in plan.children():
        yield from _execs(c)


@pytest.fixture(scope="module")
def tpch_plans():
    """The port's plans of TPC-H at SF 0.01, once as planned by default and
    once with the row-returning chains and a 4-shard mesh on."""
    plain = dft.SessionContext(CPU)
    register_tpch(plain, sf=0.01)
    wide = dft.SessionContext(CPU)
    wide.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
    wide.sql("SET datafusion.tpu.mesh_devices = 4")
    for name in plain.tables:
        wide.register_table(name, plain.get_table(name))
    return {q: [ctx.sql(TPCH[q]).create_physical_plan()
                for ctx in (plain, wide)] for q in TPCH}


@pytest.mark.parametrize("q", sorted(TPCH))
def test_unfuse_leaves_no_device_exec(tpch_plans, q):
    for plan in tpch_plans[q]:
        assert any(isinstance(n, TorchDeviceExec) for n in _execs(plan))
        names = [type(n).__name__ for n in _execs(_unfuse(plan))]
        assert not [n for n in names if n.startswith("Torch")], names


def test_unfuse_meets_every_kind_of_device_exec(tpch_plans):
    kinds = {type(n).__name__ for plans in tpch_plans.values()
             for plan in plans for n in _execs(plan)
             if isinstance(n, TorchDeviceExec)}
    assert kinds >= {"TorchGroupAggregateExec",
                     "TorchJoinChainAggregateExec",
                     "TorchJoinChainRowsExec",
                     "TorchDistributedAggregateExec"}, kinds
