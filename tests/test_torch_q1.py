"""The PyTorch port's SQL path against the JAX package, on the CPU.

`datafusion_tpu_torch.SessionContext(torch.device("cpu"))` runs each
kernel's plain PyTorch version; the JAX package runs its device path on
the CPU backend. Same numpy-seeded tables, same SQL, same rows: exact for
integers, decimals, keys and counts, rel 1e-9 for float aggregates (as
`test_device.py` compares the JAX package's two paths). The port gets the
tables as its own classes (`torch_twin`).
"""
import numpy as np
import pytest
import torch

import bench
import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchGroupAggregateExec)
from test_device import QUERIES
from torch_twin import register_both, twin

CPU = torch.device("cpu")


def _pair(register):
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register(port)
    register(ref)
    return port, ref


def _port_exec(ctx, q):
    node = ctx.sql(q).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        kids = node.children()
        if not kids:
            return None
        node = kids[0]
    return node


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            if isinstance(x, float):
                assert x == pytest.approx(y, rel=1e-9, nan_ok=True), k
            else:
                assert x == y, k


@pytest.mark.parametrize("seed", [0, 1])
def test_q1_matches_jax_package(seed):
    batch = bench.make_lineitem(50_000, seed=seed)
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "lineitem", batch)
    got = port.sql(bench.Q1).to_pydict()
    assert got == ref.sql(bench.Q1).to_pydict()
    assert len(got["l_returnflag"]) == 4
    ex = _port_exec(port, bench.Q1)
    assert ex is not None and ex.fallbacks == 0


# every test_device.py query runs on the port: the dense path up to 64
# slots, the hash path above


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_device_queries_match_jax_package(i):
    rng = np.random.default_rng(3)
    n = 20_000
    data = {
        "g": rng.choice(list("abcdefgh"), n).astype(object),
        "k": rng.integers(-50, 50, n),
        "v": rng.normal(size=n) * 100,
        "d": rng.integers(0, 11, n) / 100.0,
    }
    port, ref = _pair(lambda c: c.register_arrays("t", data))
    q = QUERIES[i]
    _assert_same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
    ex = _port_exec(port, q)
    assert ex is not None
    assert ex.fallbacks == 0


def test_null_keys_match_jax_package():
    g = Column(dt.INT64, np.array([1, 1, 2, 2, 0], np.int64),
               np.array([True, True, True, True, False]))
    v = Column(dt.FLOAT64, np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
               np.array([True, False, True, True, True]))
    b = Batch(Schema([Field("g", dt.INT64, True),
                      Field("v", dt.FLOAT64, True)]), [g, v])
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "t", b)
    q = ("SELECT g, count(*) c, count(v) cv, sum(v) s FROM t "
         "GROUP BY g ORDER BY g NULLS FIRST")
    out = port.sql(q).to_pydict()
    assert out == ref.sql(q).to_pydict()
    assert out["g"] == [None, 1, 2]
    assert out["c"] == [1, 2, 2]
    assert out["cv"] == [1, 1, 2]
    assert out["s"] == [5.0, 1.0, 7.0]
    assert _port_exec(port, q).fallbacks == 0


@pytest.mark.parametrize("where", ["v > 1e9", "FALSE"])
def test_ungrouped_aggregate_over_empty_input(where):
    rng = np.random.default_rng(4)
    data = {"v": rng.normal(size=1000), "k": rng.integers(0, 9, 1000)}
    port, ref = _pair(lambda c: c.register_arrays("t", data))
    q = (f"SELECT count(*) c, sum(v) s, avg(k) a, min(v) mn FROM t "
         f"WHERE {where}")
    out = port.sql(q).to_pydict()
    assert out == ref.sql(q).to_pydict()
    assert out == {"c": [0], "s": [None], "a": [None], "mn": [None]}


def test_explain_shows_the_port_exec():
    batch = twin(bench.make_lineitem(1_000, seed=0))
    port = dft.SessionContext(CPU)
    port.register_table("lineitem", dft.MemTable(batch.schema, [[batch]]))
    plan = "\n".join(port.sql("EXPLAIN " + bench.Q1).to_pydict()["plan"])
    assert "TorchGroupAggregateExec" in plan
    assert "DeviceGroupAggregateExec" not in plan


def test_count_distinct_matches_jax_package():
    """The logical optimizer turns count(DISTINCT x) into two aggregates
    (group by g, x; then count by g): the inner one's key space is too
    wide for dense slots and runs on the hash path, the outer one on the
    dense path."""
    rng = np.random.default_rng(5)
    data = {"g": rng.integers(0, 4, 500), "x": rng.integers(0, 50, 500)}
    port, ref = _pair(lambda c: c.register_arrays("t", data))
    q = "SELECT g, count(DISTINCT x) dx FROM t GROUP BY g ORDER BY g"
    assert port.sql(q).to_pydict() == ref.sql(q).to_pydict()
    outer = _port_exec(port, q)
    (inner,) = outer.children()
    assert (outer.fallbacks, inner.fallbacks) == (0, 0)


def test_device_copies_are_cached_until_the_catalog_changes():
    batch = twin(bench.make_lineitem(2_000, seed=0))
    port = dft.SessionContext(CPU)
    port.register_table("lineitem", dft.MemTable(batch.schema, [[batch]]))
    first = port.sql(bench.Q1).to_pydict()
    assert len(port.device_cache) == 7          # Q1 reads 7 columns
    port.sql(bench.Q1).to_pydict()
    assert len(port.device_cache) == 7
    port.register_arrays("other", {"x": np.arange(3)})
    assert len(port.device_cache) == 0
    assert port.sql(bench.Q1).to_pydict() == first


def test_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        assert dft.SessionContext(torch.device("cuda")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            dft.SessionContext(torch.device("cuda"))
