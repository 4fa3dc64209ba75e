"""Window functions through the port on the CPU against the JAX package.

The port's `device_window_eval` runs the plain PyTorch versions of its
three kernels (radix sort, lane gather, window scan) on CPU tensors; the
JAX package's runs its fused program on the CPU backend. Every spec kind
(five ranks, ntile, lag/lead with and without a default, sum_f, sum_i and
cnt over each bound kind) must agree exactly, but float64 frame sums,
which may differ in summation order, within rel 1e-9. Then SQL through
both packages with the thresholds at 1: `tests/test_device_window.py`'s
seven cases, NULLs and decimal averages, and the three window queries of
the smoke run (W1-W3) over TPC-H at SF 0.01. Each SQL case checks that
every window expression of the port took the device path.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.device import window as jax_window
from datafusion_tpu.physical.plan import device_sort as jax_sort
from datafusion_tpu_torch.device import window as port_window
from torch_twin import register_tpch_both

CPU = torch.device("cpu")
N = 5000
BOUNDS = [("part", 0, "part", 0), ("part", 0, "cur", 0),
          ("part", 0, "peer", 0), ("peer", 0, "peer", 0),
          ("rows", -2, "rows", 1), ("rows", -6, "cur", 0),
          ("cur", 0, "part", 0), ("rows", 3, "rows", 1)]
SPECS = ([("rank", f) for f in ("row_number", "rank", "dense_rank",
                                "percent_rank", "cume_dist")] +
         [("ntile", 4), ("ntile", 4999)] +
         [("shift", o) for o in (-1, 1, -3, 2)] +
         [("agg", a) + b for a in ("sum_f", "sum_i", "cnt") for b in BOUNDS])


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 7, N).astype(np.uint64)
    gr = (rng.random(N) < 0.05).astype(np.uint8)     # a NULL partition
    o = rng.integers(0, 300, N).astype(np.uint64)      # ties: peer groups
    orank = (rng.random(N) < 0.03).astype(np.uint8)
    return rng, [gr, g], [orank, o]


@pytest.mark.parametrize("spec,with_default", [(s, False) for s in SPECS] + [
    (s, True) for s in SPECS if s[0] == "shift"], ids=str)
def test_device_window_eval_matches_jax(spec, with_default):
    rng, part, order = _inputs()
    kw = {}
    if spec[0] == "shift":
        kw = {"arg": rng.integers(-1000, 1000, N).astype(np.int64),
              "arg_valid": rng.random(N) > 0.1}
        if with_default:
            kw["default"] = rng.integers(0, 9, N).astype(np.int64)
            kw["default_valid"] = rng.random(N) > 0.2
    elif spec[0] == "agg":
        kw = {"arg": rng.normal(size=N) if spec[1] == "sum_f" else
              rng.integers(-10**12, 10**12, N).astype(np.int64),
              "arg_valid": rng.random(N) > 0.1}
    want = jax_window.device_window_eval(part, order, N, spec, **kw)
    got = port_window.device_window_eval(part, order, N, spec, **kw,
                                         device=CPU)
    if spec[0] in ("rank", "ntile"):
        w = want["data"]
        np.testing.assert_array_equal(
            got["data"], w if w.dtype == np.float64 else w.astype(np.int64))
    elif spec[0] == "shift":
        np.testing.assert_array_equal(got["valid"], want["valid"])
        m = want["valid"]
        assert got["data"].dtype == want["data"].dtype
        np.testing.assert_array_equal(got["data"][m], want["data"][m])
    else:
        np.testing.assert_array_equal(got["cnt"], want["cnt"])
        if spec[1] == "sum_f":
            np.testing.assert_allclose(got["sum"], want["sum"], rtol=1e-9,
                                       atol=1e-12)
        elif spec[1] == "sum_i":
            np.testing.assert_array_equal(got["sum"], want["sum"])
        else:
            assert set(got) == {"cnt"}


def test_window_eval_just_above_a_power_of_two():
    """n = 2^12 + 1: the JAX program pads to a larger capacity, the port
    does not; the last row's partition and sums must come out the same."""
    n = 4097
    rng = np.random.default_rng(2)
    part = [np.zeros(n, np.uint8), rng.integers(0, 2, n).astype(np.uint64)]
    order = [np.zeros(n, np.uint8), rng.integers(0, 40, n).astype(np.uint64)]
    arg = rng.integers(0, 100, n).astype(np.int64)
    valid = np.ones(n, bool)
    for spec in (("agg", "sum_i", "part", 0, "part", 0),
                 ("agg", "cnt", "cur", 0, "part", 0), ("rank", "cume_dist"),
                 ("shift", 1)):
        kw = {} if spec[0] == "rank" else {"arg": arg, "arg_valid": valid}
        want = jax_window.device_window_eval(part, order, n, spec, **kw)
        got = port_window.device_window_eval(part, order, n, spec, **kw,
                                             device=CPU)
        for key in got:
            if key == "data" and spec[0] == "shift":
                m = want["valid"]
                np.testing.assert_array_equal(got[key][m], want[key][m])
            else:
                np.testing.assert_array_equal(got[key], want[key])


# ---- SQL ---------------------------------------------------------------------

def _pair(nulls=True):
    """The data of tests/test_device_window.py in both packages, device
    windows on (threshold 1)."""
    rng = np.random.default_rng(0)
    n = 4000
    data = {
        "g": rng.integers(0, 7, n),
        "s": np.array([f"p{i}" for i in rng.integers(0, 5, n)]),
        "v": rng.normal(size=n).round(3),
        "w": rng.integers(0, 100, n).astype(np.int64),
        "i": np.arange(n),
    }
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for ctx in (port, ref):
        ctx.sql("SET datafusion.tpu.device_window_min_rows = 1")
        ctx.register_arrays("t", dict(data))
        if nulls:
            ctx.sql("CREATE TABLE tn AS SELECT g, s, "
                    "CASE WHEN w % 11 = 3 THEN NULL ELSE v END v, w, i "
                    "FROM t")
    return port, ref


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture()
def device_windows(monkeypatch):
    """Counts the port's device window evaluations, and fails any that
    falls to the host."""
    from datafusion_tpu_torch.physical.plan import window as plan_window
    calls = []
    real_eval = port_window.device_window_eval
    real_try = plan_window._try_device_window

    def counted(*a, **kw):
        calls.append(a[3])
        return real_eval(*a, **kw)

    def must(*a, **kw):
        out = real_try(*a, **kw)
        assert out is not None, f"{a[0].name} fell to the host"
        return out
    monkeypatch.setattr(port_window, "device_window_eval", counted)
    monkeypatch.setattr(plan_window, "_try_device_window", must)
    monkeypatch.setattr(jax_sort, "DEFAULT_MIN_ROWS", 1)
    return calls


def _same(got, want, tag):
    assert list(got) == list(want), tag
    for k in want:
        a, b = got[k], want[k]
        assert len(a) == len(b), (tag, k)
        if any(isinstance(x, float) for x in b):
            assert [x is None for x in a] == [x is None for x in b], (tag, k)
            np.testing.assert_allclose(
                [x for x in a if x is not None],
                [x for x in b if x is not None], rtol=1e-9,
                err_msg=f"{tag}/{k}")
        else:
            assert a == b, (tag, k)


QUERIES = [
    ("ranks", "SELECT i, row_number() OVER (PARTITION BY g ORDER BY v, i) rn,"
     " rank() OVER (PARTITION BY g ORDER BY w) rk,"
     " dense_rank() OVER (PARTITION BY g ORDER BY w) dr"
     " FROM t ORDER BY i"),
    ("pct", "SELECT i, percent_rank() OVER (PARTITION BY s ORDER BY w) pr,"
     " cume_dist() OVER (PARTITION BY s ORDER BY w) cd,"
     " ntile(4) OVER (PARTITION BY s ORDER BY w, i) nt"
     " FROM t ORDER BY i"),
    ("shift", "SELECT i, lag(v) OVER (PARTITION BY g ORDER BY i) l1,"
     " lead(v, 2) OVER (PARTITION BY g ORDER BY i) l2,"
     " lag(v, 1, -1.0) OVER (PARTITION BY g ORDER BY i) l3"
     " FROM t ORDER BY i"),
    ("runsum", "SELECT i, sum(v) OVER (PARTITION BY g ORDER BY i) rs,"
     " count(v) OVER (PARTITION BY g ORDER BY i) rc,"
     " avg(v) OVER (PARTITION BY g ORDER BY i) ra"
     " FROM t ORDER BY i"),
    ("wholes", "SELECT i, sum(w) OVER (PARTITION BY s) ws,"
     " count(*) OVER (PARTITION BY s) wc"
     " FROM t ORDER BY i"),
    ("rows_frame", "SELECT i, sum(w) OVER (PARTITION BY g ORDER BY i "
     "ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) fs,"
     " count(w) OVER (ORDER BY i ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) fc"
     " FROM t ORDER BY i"),
    ("no_partition", "SELECT i, row_number() OVER (ORDER BY v, i) rn,"
     " sum(v) OVER (ORDER BY v, i) rs FROM t ORDER BY i"),
    ("nulls", "SELECT i, sum(v) OVER (PARTITION BY g ORDER BY i) rs,"
     " count(v) OVER (PARTITION BY g ORDER BY i) rc,"
     " lag(v) OVER (PARTITION BY g ORDER BY i) lg,"
     " rank() OVER (PARTITION BY g ORDER BY v NULLS FIRST) rk"
     " FROM tn ORDER BY i"),
]


@pytest.mark.parametrize("tag,sql", QUERIES)
def test_window_sql_matches_jax(pair, device_windows, tag, sql):
    port, ref = pair
    got = port.sql(sql).to_pydict()
    want = ref.sql(sql).to_pydict()
    _same(got, want, tag)
    assert device_windows, tag


def test_window_decimal_avg_matches_jax(device_windows):
    """Decimal frame sums and averages stay exact through the int64 lane,
    the average rounded as the host path rounds it."""
    out = []
    for ctx in (dft.SessionContext(CPU), df.SessionContext()):
        ctx.sql("SET datafusion.tpu.device_window_min_rows = 1")
        ctx.sql("CREATE TABLE d AS SELECT * FROM (VALUES "
                "(1, 10.25), (2, 0.50), (3, 99.99), (4, 2.00), (5, 3.75), "
                "(6, -7.33)) v(i, x)")
        ctx.sql("CREATE TABLE d2 AS SELECT i, CAST(x AS DECIMAL(10,2)) x "
                "FROM d")
        out.append(ctx.sql(
            "SELECT i, sum(x) OVER (ORDER BY i) s, avg(x) OVER (ORDER BY i "
            "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) a FROM d2 ORDER BY i"
        ).to_pydict())
    assert out[0] == out[1]
    assert len(device_windows) == 2


# the smoke run's window queries (chip_smoke.py), here at SF 0.01
W1 = ("SELECT l_suppkey, l_orderkey, l_extendedprice, rk, order_qty FROM "
      "(SELECT l_suppkey, l_orderkey, l_extendedprice, rank() OVER "
      "(PARTITION BY l_suppkey ORDER BY l_extendedprice DESC) AS rk, "
      "sum(l_quantity) OVER (PARTITION BY l_orderkey) AS order_qty "
      "FROM lineitem) WHERE rk <= 3")
W2 = ("SELECT l_orderkey, l_shipdate, l_extendedprice, row_number() OVER "
      "(ORDER BY l_shipdate, l_orderkey) AS rn, lag(l_extendedprice) OVER "
      "(ORDER BY l_shipdate, l_orderkey) AS prev_price FROM lineitem")
W3 = ("SELECT l_returnflag, l_shipdate, l_orderkey, sum(l_quantity) OVER "
      "(PARTITION BY l_returnflag ORDER BY l_shipdate, l_orderkey ROWS "
      "BETWEEN 6 PRECEDING AND CURRENT ROW) AS qty7 FROM lineitem")


@pytest.fixture(scope="module")
def tpch():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01)
    for ctx in (port, ref):
        ctx.sql("SET datafusion.tpu.device_window_min_rows = 1")
    port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    return port, ref


@pytest.mark.parametrize("label,sql,evals", [("W1", W1, 2), ("W2", W2, 2),
                                             ("W3", W3, 3)])
def test_smoke_window_queries_match_jax(tpch, device_windows, label, sql,
                                        evals):
    """W1: WindowExec over two PARTITION BYs under a filter; W2: a global
    row_number and lag; W3: BoundedWindowExec, one evaluation for each of
    the three l_returnflag runs."""
    port, ref = tpch
    got = port.sql(sql).to_pydict()
    want = ref.sql(sql).to_pydict()
    _same(got, want, label)
    assert len(device_windows) == evals, label
    assert len(next(iter(got.values()))) > 0
