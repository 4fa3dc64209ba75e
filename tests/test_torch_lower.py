"""Expression programs of the PyTorch port against the JAX package's
lowering.

For the predicate, group keys and aggregate arguments of TPC-H Q1 and of
the dense-path queries of `test_device.py`, the JAX package's
`lower_expr(e).trace` (on the CPU backend, as its own tests run it) and
the port's plain interpreter of `compile_expr(e)` evaluate the same
numpy-seeded batch (the port gets the expression and the batch as its own
classes, `torch_twin.twin`). Data and validity must be equal exactly: the
port reproduces JAX's dtypes with explicit wrap and float32 rounding steps.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])

import bench  # noqa: E402
import datafusion_tpu as df  # noqa: E402
from datafusion_tpu.common import dt  # noqa: E402
from datafusion_tpu.common.batch import Batch  # noqa: E402
from datafusion_tpu.common.column import Column, Dictionary  # noqa: E402
from datafusion_tpu.common.schema import Field, Schema  # noqa: E402
from datafusion_tpu.device.lower import lower_expr  # noqa: E402
from datafusion_tpu.physical.plan.base import execute_stream  # noqa: E402
from datafusion_tpu.physical.plan.device_aggregate import (  # noqa: E402
    DeviceGroupAggregateExec)
from datafusion_tpu_torch.common.column import to_device  # noqa: E402
from datafusion_tpu_torch.device.lower import (  # noqa: E402
    LoweringError, compile_expr, evaluate)
from torch_twin import twin  # noqa: E402


def _wide_batch(n=5_000, seed=11):
    """Every column kind the programs load, with NULLs and NaNs."""
    rng = np.random.default_rng(seed)
    dic = Dictionary(np.array(["ab", "ac", "b", "ca", "d"], dtype=object))
    sv = rng.random(n) > 0.1
    iv = rng.random(n) > 0.1
    f = rng.normal(size=n) * 100
    f[rng.random(n) < 0.05] = np.nan
    schema = Schema([
        Field("s", dt.STRING, True), Field("i", dt.INT32, True),
        Field("k", dt.INT64, False), Field("f", dt.FLOAT64, False),
        Field("h", dt.FLOAT32, False), Field("b", dt.BOOL, False),
        Field("d", dt.decimal(15, 2), False), Field("day", dt.DATE, False),
        Field("ts", dt.timestamp("us"), False)])
    cols = [
        Column(dt.STRING, rng.integers(0, 5, n).astype(np.int32), sv, dic),
        Column(dt.INT32, rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
               iv),
        Column(dt.INT64, rng.integers(-100, 100, n)),
        Column(dt.FLOAT64, f),
        Column(dt.FLOAT32, (rng.normal(size=n) * 10).astype(np.float32)),
        Column(dt.BOOL, rng.random(n) < 0.5),
        Column(dt.decimal(15, 2), rng.integers(-10**5, 10**5, n)),
        Column(dt.DATE, rng.integers(8000, 11000, n).astype(np.int32)),
        Column(dt.timestamp("us"),
               rng.integers(8000, 11000, n) * 86_400_000_000
               + rng.integers(0, 86_400_000_000, n)),
    ]
    return Batch(schema, cols, n)


def _test_device_table():
    from test_device import _two_ctxs
    on, _off = _two_ctxs()
    return on


def _lineitem_ctx():
    ctx = df.SessionContext()
    b = bench.make_lineitem(20_000, seed=5)
    ctx.register_table("lineitem", df.MemTable(b.schema, [[b]]))
    return ctx


def _wide_ctx():
    ctx = df.SessionContext()
    b = _wide_batch()
    ctx.register_table("w", df.MemTable(b.schema, [[b]]))
    return ctx


TEST_DEVICE_QUERIES = __import__("test_device").QUERIES

WIDE_QUERIES = [
    # six string comparisons, both operand orders, literals in and out of
    # the dictionary
    "SELECT s = 'b', s <> 'ca', s < 'b', s <= 'bb', 'c' > s, s >= 'ac', "
    "s <= 'ca', s > 'zz', s > 'bb', s > 'b', count(*) FROM w "
    "GROUP BY 1, 2, 3, 4, 5, 6, 7, 8, 9, 10",
    # Kleene AND/OR/NOT over NULLs, IS [NOT] NULL, IN over int and string
    "SELECT NOT (i > 0 AND s IN ('ab', 'd')), i IS NULL AND k IN (1, 2, 3), "
    "s IS NOT NULL, i > 0 OR s = 'b', s NOT IN ('b'), count(*) FROM w "
    "WHERE s IS NULL OR i < 0 OR NOT b GROUP BY 1, 2, 3, 4, 5",
    # int32 wraps, float32 rounds, bool loads, negation
    "SELECT sum(i + i), sum(h * h), sum(-k), min(h - 1) FROM w WHERE b",
    # decimal vs float literal thresholds, decimal arithmetic and compare
    "SELECT sum(d * (1 - d)), sum(d + 1.5) FROM w WHERE d >= 0.05 "
    "AND d < 500.25 AND d <> 3",
    # date literal, float lanes with NaN, LIKE
    "SELECT s, min(f), max(f), sum(f * 2) FROM w "
    "WHERE day <= DATE '1998-09-02' AND s LIKE '%a%' GROUP BY s",
    # timestamp against date and timestamp literals of other units
    "SELECT ts >= DATE '1995-01-01', ts < TIMESTAMP '1996-06-01 12:00:00', "
    "ts = day, count(*) FROM w GROUP BY 1, 2, 3",
    # decimal to float comparison and arithmetic, float IN list
    "SELECT sum(f + d) FROM w WHERE f > d AND f IN (1.5, 2.5) OR k = 3",
]

CASES = ([("lineitem", bench.Q1)] +
         [("test_device", q) for q in TEST_DEVICE_QUERIES] +
         [("wide", q) for q in WIDE_QUERIES])


def _exprs(ctx, q):
    plan = ctx.sql(q).create_physical_plan()
    node = plan
    while not isinstance(node, DeviceGroupAggregateExec):
        (node,) = node.children()
    (batch,) = [b for b in execute_stream(node.source, ctx.task_context())
                if b.num_rows]
    exprs = [node.predicate] if node.predicate is not None else []
    exprs += [e for e, _ in node.group_exprs]
    exprs += [a for agg in node.aggs for a in agg.args]
    return exprs, batch


def _jax_eval(e, batch):
    low = lower_expr(e)
    n = batch.num_rows
    cols = tuple(jnp.asarray(c.data_host()) for c in batch.columns)
    valids = tuple(jnp.asarray(c.validity_host()) if c.has_nulls
                   else jnp.ones(n, bool) for c in batch.columns)
    aux = [np.asarray(s.fn(batch)) for s in low.aux]
    d, v = low.trace(cols, valids, aux)
    d = np.broadcast_to(np.asarray(d), (n,))
    v = np.ones(n, bool) if v is None else np.broadcast_to(np.asarray(v), (n,))
    return d, v


def _port_eval(e, batch):
    e, batch = twin(e), twin(batch)
    prog = compile_expr(e)
    cols = {i: to_device(batch.columns[i], torch.device("cpu"))
            for i in prog.pools.columns}
    aux = torch.from_numpy(prog.pools.aux_buffer(batch))
    d, v = evaluate(prog, cols, aux, batch.num_rows)
    return prog, d.numpy(), v.numpy()


@pytest.mark.parametrize("table,q", CASES)
def test_program_matches_jax_lowering(table, q):
    ctx = {"lineitem": _lineitem_ctx, "test_device": _test_device_table,
           "wide": _wide_ctx}[table]()
    exprs, batch = _exprs(ctx, q)
    assert exprs
    for e in exprs:
        jd, jv = _jax_eval(e, batch)
        prog, pd, pv = _port_eval(e, batch)
        assert prog.out_dtype == jd.dtype, (str(e), prog.out_dtype, jd.dtype)
        np.testing.assert_array_equal(pv, jv, err_msg=str(e))
        want = jd.astype(np.float64 if jd.dtype.kind == "f" else np.int64)
        np.testing.assert_array_equal(pd, want, err_msg=str(e))


@pytest.mark.parametrize("q", [
    "SELECT sum(CASE WHEN k > 0 THEN k ELSE 0 END) FROM w",
    "SELECT sum(k / 2) FROM w",
    "SELECT sum(k % 3) FROM w",
    "SELECT count(*) FROM w WHERE date_part('year', day) = 1995",
])
def test_outside_the_slice_raises_lowering_error(q):
    exprs, _batch = _exprs(_wide_ctx(), q)
    with pytest.raises(LoweringError):
        for e in exprs:
            compile_expr(twin(e))
