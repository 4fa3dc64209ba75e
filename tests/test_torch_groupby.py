"""The port's dense group aggregate against the JAX package's.

The JAX side is the dense path's one jitted program:
`DeviceGroupAggregateExec._make_step` (`prepare`: filter, key packing,
value lanes) feeding `device.groupby._dense_group_aggregate`, run on the
CPU backend. The port side is `dense_group_aggregate` on CPU tensors,
which runs its plain PyTorch version. Both get the same numpy-seeded
keys (with NULLs) and lanes (with NULLs and NaNs). Counts, integer lanes
and min/max must be equal; float sums agree within rel 1e-12, since the
two sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.scalar import ScalarValue
from datafusion_tpu.device.lower import lower_expr
from datafusion_tpu.expr.operator import Op
from datafusion_tpu.physical.expressions import (BinaryPhysExpr, ColumnExpr,
                                                 IsNullExpr, LiteralExpr)
from datafusion_tpu.physical.plan.device_aggregate import (
    DeviceGroupAggregateExec, _PackPlan)
from datafusion_tpu_torch.common.column import to_device
from datafusion_tpu_torch.device.groupby import (
    LANE_SUM_F64, AggregateSpec, dense_group_aggregate, lane_kind)
from datafusion_tpu_torch.device.lower import Pools, compile_expr
from torch_twin import twin

K = ColumnExpr(0, "k", dt.INT64)            # int key in [-2, 2], NULLs
G = ColumnExpr(1, "g", dt.STRING)           # 3-value dictionary key
X = ColumnExpr(2, "x", dt.INT64)            # int lane, NULLs
V = ColumnExpr(3, "v", dt.FLOAT64)          # float lane, NULLs and NaNs
OFFSETS, BITS = [-2, 0], [3, 3]             # 64 dense slots
SLOTS = [("v0#c", "cnt", X), ("v1#s", "sum", X), ("v2#n", "min", X),
         ("v3#x", "max", X), ("v4#c", "cnt", V), ("v5#s", "sum", V),
         ("v6#n", "min", V), ("v7#x", "max", V), ("v8#nn", "nancnt", V),
         ("v9#c", "cnt", None)]


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * 1e3
    v[rng.random(n) < 0.05] = np.nan
    dic = Dictionary(np.array(["a", "b", "c"], dtype=object))
    return Batch(None, [
        Column(dt.INT64, rng.integers(-2, 3, n), rng.random(n) > 0.1),
        Column(dt.STRING, rng.integers(0, 3, n).astype(np.int32), None, dic),
        Column(dt.INT64, rng.integers(-10**12, 10**12, n),
               rng.random(n) > 0.2),
        Column(dt.FLOAT64, v, rng.random(n) > 0.1),
    ], n)


def _predicate(kind):
    if kind is None:
        return None
    zero = LiteralExpr(ScalarValue(dt.INT64, 0))
    gt = BinaryPhysExpr(X, Op.GT, zero, dt.BOOL)
    return BinaryPhysExpr(gt, Op.OR, IsNullExpr(V, negated=False), dt.BOOL)


def _jax(batch, pred):
    n = batch.num_rows
    pred_l = lower_expr(pred) if pred is not None else None
    key_l = [lower_expr(K), lower_expr(G)]
    slot_defs = {name: (cat, lower_expr(e) if e is not None else None)
                 for name, cat, e in SLOTS}
    plan = _PackPlan(OFFSETS, BITS, [K.out_type, G.out_type],
                     [None, batch.columns[1].dictionary])
    lowereds = ([pred_l] if pred_l is not None else []) + key_l + \
        [low for _c, low in slot_defs.values() if low is not None]
    aux_offset, off = {}, 0
    for low in lowereds:
        aux_offset[id(low)] = off
        off += len(low.aux)
    null_layout = tuple(c.has_nulls for c in batch.columns)
    step = DeviceGroupAggregateExec._make_step(
        None, pred_l, key_l, slot_defs, plan, jnp, 64, aux_offset, True,
        null_layout, n)
    cols = tuple(jnp.asarray(c.data_host()) for c in batch.columns)
    valids = tuple(jnp.asarray(c.validity_host()) for c in batch.columns
                   if c.has_nulls)
    keys, valid, out, _ng = step(cols, valids, np.int64(n), np.int64(0), ())
    return np.asarray(valid), {k: np.asarray(v) for k, v in out.items()}


def _port(batch, pred):
    """The port's side, on the twins (its own classes) of the JAX
    package's batch and expressions."""
    batch, pred = twin(batch), twin(pred)
    pools = Pools()
    pred_p = compile_expr(pred, pools) if pred is not None else None
    keys = [(compile_expr(twin(e), pools), o, b) for e, o, b in
            zip((K, G), OFFSETS, BITS)]
    lanes = []
    for _name, cat, e in SLOTS:
        prog = compile_expr(twin(e), pools) if e is not None else None
        lanes.append((prog, lane_kind(cat, prog)))
    spec = AggregateSpec(pools, pred_p, keys, lanes)
    cpu = torch.device("cpu")
    cols = {i: to_device(batch.columns[i], cpu) for i in pools.columns}
    aux = torch.from_numpy(pools.aux_buffer(batch))
    table = dense_group_aggregate(spec, cols, aux, batch.num_rows,
                                  spec.new_table(cpu))
    host = table.numpy()
    return spec, host[0], spec.lane_arrays(host)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pred", [None, "x > 0 OR v IS NULL"])
def test_dense_group_aggregate_matches_jax(seed, pred):
    batch = _batch(30_000, seed)
    p = _predicate(pred)
    jvalid, jout = _jax(batch, p)
    spec, counts, lanes = _port(batch, p)
    assert spec.groups == 64
    np.testing.assert_array_equal(counts > 0, jvalid)
    for (name, cat, _e), (_prog, kind), got in zip(SLOTS, spec.lanes, lanes):
        want = jout[name]
        if kind == LANE_SUM_F64:
            np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_batches_accumulate_into_one_table():
    """Two batches folded into one table equal one batch of both."""
    a, b = _batch(7_000, 5), _batch(9_000, 6)
    both = Batch(None, [Column(ca.dtype,
                               np.concatenate([ca.data_host(), cb.data_host()]),
                               np.concatenate([ca.validity_host(),
                                               cb.validity_host()])
                               if ca.has_nulls else None, ca.dictionary)
                        for ca, cb in zip(a.columns, b.columns)],
                 a.num_rows + b.num_rows)
    spec, counts, lanes = _port(both, None)
    cpu = torch.device("cpu")
    table = spec.new_table(cpu)
    for part in (a, b):
        cols = {i: to_device(part.columns[i], cpu) for i in spec.pools.columns}
        aux = torch.from_numpy(spec.pools.aux_buffer(part))
        dense_group_aggregate(spec, cols, aux, part.num_rows, table)
    host = table.numpy()
    np.testing.assert_array_equal(host[0], counts)
    for (_p, kind), got, want in zip(spec.lanes, spec.lane_arrays(host),
                                     lanes):
        if kind == LANE_SUM_F64:
            np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(got, want)


def test_wrapper_checks_its_inputs():
    batch = _batch(100, 0)
    spec, _c, _l = _port(batch, None)
    cpu = torch.device("cpu")
    cols = {i: to_device(batch.columns[i], cpu) for i in spec.pools.columns}
    aux = torch.from_numpy(spec.pools.aux_buffer(batch))
    bad = dict(cols)
    bad[2] = (cols[2][0].to(torch.int32), cols[2][1])
    with pytest.raises(ValueError):
        dense_group_aggregate(spec, bad, aux, 100, spec.new_table(cpu))
    with pytest.raises(ValueError):
        dense_group_aggregate(spec, cols, aux, 101, spec.new_table(cpu))
    with pytest.raises(ValueError):
        dense_group_aggregate(spec, cols, aux, 100,
                              torch.zeros(3, 64, dtype=torch.int64))


def test_ungrouped_q6_matches_device_filter_reduce():
    """TPC-H Q6 has no keys: the port runs it as a dense aggregate of one
    slot. It must equal the JAX package's `device_filter_reduce` (fused
    AND of predicates + scalar sum) over the same seeded columns."""
    import datetime

    import bench
    import datafusion_tpu_torch as dft
    from datafusion_tpu.device.groupby import device_filter_reduce
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    batch = bench.make_lineitem(40_000, seed=3)
    port_batch = twin(batch)
    ctx = dft.SessionContext(torch.device("cpu"))
    ctx.register_table("lineitem", dft.MemTable(port_batch.schema,
                                                [[port_batch]]))
    q6 = ("select sum(l_extendedprice * l_discount) as revenue "
          "from lineitem where l_shipdate >= date '1994-01-01' "
          "and l_shipdate < date '1995-01-01' "
          "and l_discount between 0.05 and 0.07 and l_quantity < 24")
    node = ctx.sql(q6).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    (src,) = node.input_batches(ctx.task_context())
    spec, _p, names, _s = node.compile([src])
    assert isinstance(spec, AggregateSpec) and spec.groups == 1
    cpu = torch.device("cpu")
    cols, aux = node.stage(spec, src)
    table = dense_group_aggregate(spec, cols, aux, src.num_rows,
                                  spec.new_table(cpu)).numpy()
    got = int(table[1 + names.index([n for n in names
                                     if n.endswith("#s")][0])][0])

    def day(y, m, d):
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    qty, price, disc, ship = (jnp.asarray(batch.columns[i].data_host())
                              for i in (0, 1, 2, 6))
    want = int(device_filter_reduce(
        [ship >= day(1994, 1, 1), ship < day(1995, 1, 1),
         disc / 100.0 >= 0.05, disc / 100.0 <= 0.07, qty < 2400],
        price * disc))
    assert got == want and got > 0
    assert ctx.sql(q6).collect_batch().columns[0].data_host()[0] == want
    assert node.fallbacks == 0
