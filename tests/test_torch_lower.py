"""Expression programs of the PyTorch port against the JAX package's
lowering.

For the predicate, group keys and aggregate arguments of TPC-H Q1 and of
the dense-path queries of `test_device.py`, the JAX package's
`lower_expr(e).trace` (on the CPU backend, as its own tests run it) and
the port's plain interpreter of `compile_expr(e)` evaluate the same
numpy-seeded batch (the port gets the expression and the batch as its own
classes, `torch_twin.twin`). Data and validity must be equal exactly: the
port reproduces JAX's dtypes with explicit wrap and float32 rounding steps.
The one tolerance: exp, ln, log2, log10, sin, cos and tan may differ by 4
ulp (rel 1e-15) between XLA's and PyTorch's float64 math; abs, sqrt,
floor and ceil are exact.

The cases cover searched CASE (NULL conditions, no ELSE), integer and
float `/` and `%` (negative operands, zero divisors, INT64_MIN / -1, the
int32 width), every `_MATH` function, every `date_part` part over Date32,
Date64 and timestamps of every unit (dates before 1970, 29 February, ISO
week edges), and scalar subqueries (`DeferredScalarExpr`, numeric and
decimal against a float subquery, NULL and not).
"""
import datetime
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
from datafusion_tpu.physical.expressions import (  # noqa: E402
    DeferredScalarExpr, ScalarFunctionExpr)
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


_I64_MIN, _I64_MAX = -2**63, 2**63 - 1
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _edge_batch():
    """Every pair of the interesting integer operands of `/` and `%`: 0,
    +-1, +-7, the width's extremes; int64 and int32 columns, with NULLs."""
    v64 = np.array([0, 1, -1, 7, -7, 13, -13, _I64_MIN, _I64_MAX,
                    _I64_MIN + 1], np.int64)
    v32 = np.array([0, 1, -1, 7, -7, 13, -13, _I32_MIN, _I32_MAX,
                    _I32_MIN + 1], np.int32)
    xi, yi = np.meshgrid(np.arange(len(v64)), np.arange(len(v64)))
    xi, yi = xi.ravel(), yi.ravel()
    n = len(xi)
    valid = np.arange(n) % 11 != 5
    schema = Schema([Field("x", dt.INT64, False), Field("y", dt.INT64, True),
                     Field("a", dt.INT32, False), Field("c", dt.INT32, False),
                     Field("f", dt.FLOAT64, False),
                     Field("g", dt.FLOAT64, False)])
    fv = np.array([0.0, 1.0, -1.0, 7.5, -7.5, 1e300, -0.0, np.inf, -np.inf,
                   np.nan])
    cols = [Column(dt.INT64, v64[xi]), Column(dt.INT64, v64[yi], valid),
            Column(dt.INT32, v32[xi]), Column(dt.INT32, v32[yi]),
            Column(dt.FLOAT64, fv[xi]), Column(dt.FLOAT64, fv[yi])]
    return Batch(schema, cols, n)


def _calendar_batch(n=4_000, seed=3):
    """Dates from 1423 to 2517 (before 1970 too), every 29 February and the
    year ends of 1896-2104 (ISO weeks 1, 52 and 53), as Date32, Date64 and
    timestamps of every unit, and one tz-aware timestamp."""
    rng = np.random.default_rng(seed)
    leap = [datetime.date(y, 2, 29) for y in range(1896, 2105, 4)
            if y != 1900 and y != 2100]
    ends = [datetime.date(y, m, d) for y in range(1896, 2105)
            for m, d in ((12, 28), (12, 31), (1, 1), (1, 4))]
    fixed = np.array([(x - datetime.date(1970, 1, 1)).days
                      for x in leap + ends], np.int64)
    days = np.concatenate([fixed, rng.integers(-200_000, 200_000,
                                               n - len(fixed))])
    sec = rng.integers(0, 86_400, n)
    ns = rng.integers(0, 10**9, n)
    t_ns = days * 86_400 * 10**9 + sec * 10**9 + ns
    schema = Schema([Field("d32", dt.DATE, False),
                     Field("d64", dt.DATE64, False),
                     Field("ts_s", dt.timestamp("s"), False),
                     Field("ts_ms", dt.timestamp("ms"), False),
                     Field("ts_us", dt.timestamp("us"), False),
                     Field("ts_ns", dt.timestamp("ns"), True),
                     Field("tz", dt.timestamp("us", "UTC"), False)])
    cols = [Column(dt.DATE, days.astype(np.int32)),
            Column(dt.DATE64, days * 86_400_000 + sec * 1000),
            Column(dt.timestamp("s"), t_ns // 10**9),
            Column(dt.timestamp("ms"), t_ns // 10**6),
            Column(dt.timestamp("us"), t_ns // 10**3),
            Column(dt.timestamp("ns"), t_ns, rng.random(n) > 0.05),
            Column(dt.timestamp("us", "UTC"), t_ns // 10**3)]
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
    for name, b in (("w", _wide_batch()), ("e", _edge_batch()),
                    ("cal", _calendar_batch())):
        ctx.register_table(name, df.MemTable(b.schema, [[b]]))
    return ctx


_PARTS = ("year", "quarter", "month", "day", "week", "doy", "dow", "epoch",
          "hour", "minute", "second", "millisecond", "microsecond",
          "nanosecond")
_TRANSCENDENTAL = {"exp", "ln", "log2", "log10", "sin", "cos", "tan"}


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
    # searched CASE, integer `/` and `%`, date_part in a predicate
    "SELECT sum(CASE WHEN k > 0 THEN k ELSE 0 END) FROM w",
    "SELECT sum(k / 2) FROM w",
    "SELECT sum(k % 3) FROM w",
    "SELECT count(*) FROM w WHERE date_part('year', day) = 1995",
    # CASE: NULL conditions count as false, no ELSE gives NULL, each
    # branch cast to the output type, the first true WHEN wins
    "SELECT sum(CASE WHEN i > 0 THEN f WHEN s = 'b' THEN h "
    "WHEN i IS NULL THEN -1.5 END), sum(CASE WHEN b THEN d ELSE d * 2 END), "
    "count(CASE WHEN f > 0 THEN 1 END), "
    "sum(CASE WHEN k > 50 THEN 1 WHEN k > 0 THEN 2 WHEN k > -50 THEN 3 "
    "ELSE i END) FROM w",
    # `/` and `%` over random operands: zero divisors, negatives, NaN
    "SELECT sum(k / (k % 7)), sum(i / (k - 3)), sum(k % (k / 10)), "
    "sum(i % k), sum(f / k), sum(f % (k / 20)), sum(h / h), "
    "sum(h % 2.5), sum(i / i), sum(i % (i / 1000000)) FROM w",
    # every _MATH function, integer and float32 arguments included
    "SELECT sum(abs(k)), sum(abs(f)), sum(sqrt(f)), sum(sqrt(h)), "
    "sum(exp(h / 10)), sum(ln(abs(f))), sum(log2(f)), sum(log10(abs(f)+1)), "
    "sum(sin(f)), sum(cos(f)), sum(tan(f)), sum(floor(f)), sum(ceil(h)), "
    "sum(floor(k)), sum(sqrt(k)), sum(abs(i)) FROM w",
    # `/` and `%` at the edges: INT64_MIN / -1 wraps, zero divisors count
    # as 1 and stay valid, the int32 width, IEEE inf and NaN
    "SELECT sum(x / y), sum(x % y), sum(a / c), sum(a % c), sum(f / g), "
    "sum(f % g), sum(x / 0), sum(a % 0), sum(f % 0) FROM e",
] + [
    # every date_part part over Date32, Date64 and timestamps of each unit
    "SELECT " + ", ".join(f"sum(date_part('{p}', {c}))" for p in _PARTS) +
    f" FROM cal WHERE {c} IS NOT NULL"
    for c in ("d32", "d64", "ts_s", "ts_ms", "ts_us", "ts_ns")
] + [
    # a date_part key packs as an integer; CASE inside a sum by key
    "SELECT date_part('year', d32), date_part('dow', ts_us), "
    "sum(CASE WHEN date_part('month', d64) = 2 THEN 1 ELSE 0 END) "
    "FROM cal GROUP BY 1, 2",
]

CASES = ([("lineitem", bench.Q1)] +
         [("test_device", q) for q in TEST_DEVICE_QUERIES] +
         [("wide", q) for q in WIDE_QUERIES])


def _exprs(ctx, q):
    plan = ctx.sql(q).create_physical_plan()
    node = plan
    while not isinstance(node, DeviceGroupAggregateExec):
        (node,) = node.children()
    tctx = ctx.task_context()
    (batch,) = [b for b in execute_stream(node.source, tctx) if b.num_rows]
    exprs = [node.predicate] if node.predicate is not None else []
    exprs += [e for e, _ in node.group_exprs]
    exprs += [a for agg in node.aggs for a in agg.args]
    for e in exprs:
        _memoize_scalars(e, tctx)
    return exprs, batch


def _memoize_scalars(e, tctx):
    """Run each scalar subquery of `e` once, so that its value is memoized
    in the expression (and so in its port twin) and the plan can go."""
    if isinstance(e, DeferredScalarExpr):
        e.bind_ctx(tctx)
        e.scalar()
        e.plan = e._ctx = None
    for c in e.children():
        _memoize_scalars(c, tctx)


def _has_function(e, names) -> bool:
    if isinstance(e, ScalarFunctionExpr) and e.name in names:
        return True
    return any(_has_function(c, names) for c in e.children())


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
        if _has_function(e, _TRANSCENDENTAL):
            # 4 ulp between XLA's and PyTorch's float64 libm
            np.testing.assert_allclose(pd, want, rtol=1e-15, atol=0,
                                       err_msg=str(e))
        else:
            np.testing.assert_array_equal(pd, want, err_msg=str(e))


SCALAR_QUERIES = [
    # a float subquery against an integer column
    "SELECT sum(k) FROM w WHERE k > (SELECT avg(k) FROM w)",
    # decimal against a float subquery: exact thresholds at execution
    "SELECT count(*) FROM w WHERE d > (SELECT avg(f) FROM w WHERE f > 0)",
    # an integer subquery in arithmetic; a NULL one
    "SELECT sum(k) FROM w WHERE k - (SELECT max(k) FROM w) < -50",
    "SELECT count(*) FROM w WHERE k < (SELECT max(k) FROM w WHERE k > 1000)",
]


@pytest.mark.parametrize("q", SCALAR_QUERIES)
def test_scalar_subquery_matches_jax_lowering(q):
    exprs, batch = _exprs(_wide_ctx(), q)
    found = []
    for e in exprs:
        _collect(e, DeferredScalarExpr, found)
        jd, jv = _jax_eval(e, batch)
        prog, pd, pv = _port_eval(e, batch)
        assert prog.out_dtype == jd.dtype, str(e)
        np.testing.assert_array_equal(pv, jv, err_msg=str(e))
        want = jd.astype(np.float64 if jd.dtype.kind == "f" else np.int64)
        np.testing.assert_array_equal(pd, want, err_msg=str(e))
    assert found


def _collect(e, cls, out):
    if isinstance(e, cls):
        out.append(e)
    for c in e.children():
        _collect(c, cls, out)


@pytest.mark.parametrize("q", [
    "SELECT sum(d / 3) FROM w",
    "SELECT sum(CASE k WHEN 1 THEN 2 ELSE 3 END) FROM w",
    "SELECT count(*) FROM w WHERE s > (SELECT min(s) FROM w)",
    "SELECT count(*) FROM cal WHERE date_part('hour', tz) = 3",
    "SELECT count(*) FROM w WHERE day + INTERVAL '1 day' > DATE '1995-01-01'",
])
def test_outside_the_slice_raises_lowering_error(q):
    exprs, _batch = _exprs(_wide_ctx(), q)
    with pytest.raises(LoweringError):
        for e in exprs:
            compile_expr(twin(e))


def test_having_over_a_date_part_key_stays_on_the_device():
    """A HAVING that reads a date_part (Float64) group key fuses into the
    port's aggregate and reads the key as float64, as the reference's
    `_apply_post_filter` does; rows equal the JAX package's."""
    import torch

    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    sql = ("SELECT date_part('year', d32) y, count(*) c FROM cal "
           "GROUP BY 1 HAVING date_part('year', d32) > 1990.5 AND "
           "count(*) > 2 ORDER BY y")
    ref = _wide_ctx()
    port = dft.SessionContext(torch.device("cpu"))
    b = twin(_calendar_batch())
    port.register_table("cal", dft.MemTable(b.schema, [[b]]))
    plan = port.sql(sql).create_physical_plan()
    node = plan
    while not isinstance(node, TorchGroupAggregateExec):
        (node,) = node.children()
    got = collect_batch(plan, port.task_context())
    assert node.post_filter is not None and node.fallbacks == 0
    want = ref.sql(sql).to_pydict()
    assert got.to_pydict() == want and want["y"]


def test_plain_sqrt_is_correctly_rounded():
    """The plain interpreter's sqrt (`_sqrt_rn`) rounds as IEEE, CUDA and
    XLA do. PyTorch's vectorised CPU sqrt (2.x, AVX-512) returns
    0.8838498187341434 for sqrt(0.7811905020763782), one ulp below the
    correctly rounded 0.8838498187341435, and misses so on about 0.7% of
    float64 inputs; `_sqrt_rn` moves each result to the neighbour whose
    square is nearer x. Held to Python's `math.sqrt` over seeded inputs of
    three magnitudes, the concrete input, zero, inf and NaN."""
    import math

    from datafusion_tpu_torch.device.lower import _sqrt_rn
    rng = np.random.default_rng(5)
    x = np.concatenate([[0.7811905020763782, 0.0, np.inf, np.nan],
                        rng.random(20_000), rng.random(20_000) * 1e6,
                        rng.random(20_000) * 1e-6])
    got = _sqrt_rn(torch.from_numpy(x)).numpy()
    want = np.array([math.sqrt(v) if not np.isnan(v) else np.nan
                     for v in x])
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.8838498187341435
