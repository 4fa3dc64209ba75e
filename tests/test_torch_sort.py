"""Sorting through the port on the CPU against the JAX package.

The port's `device_lexsort` runs `radix_sort`'s plain PyTorch version on
CPU tensors; the JAX package's `device_sort.device_lexsort` runs its
`lax.sort` program on the CPU backend. Both must give `np.lexsort`'s
permutation exactly, ties and limits included (the cases of
`tests/test_device_sort.py`, plus n = 4097 and the full uint64 range).
`reorder_rows` (kernel 8's wrapper) must equal numpy's fancy indexing on
every lane dtype. Then SQL: SortExec with DESC, NULLS FIRST/LAST, floats
with NaN, dictionary strings and a LIMIT over several batches, and
ClickBench Q25-Q27 at 400,000 rows, through both packages with their
device-sort thresholds at 1: equal rows, and the port's device path taken.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.clickbench.workload import QUERIES as CB
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu.physical.plan import device_sort as jax_sort
from datafusion_tpu_torch.device.groupby import reorder_rows
from datafusion_tpu_torch.physical.plan import device_sort as port_sort
from torch_twin import register_hits_both, twin

CPU = torch.device("cpu")
HITS_ROWS = 400_000


def _keys(n, seed):
    """Two sort expressions as [rank u8, key u64] x 2 with duplicates (ties
    keep row order), the second key over the whole uint64 range."""
    rng = np.random.default_rng(seed)
    k2 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    k2[rng.random(n) < 0.5] = np.uint64(7)
    k2[:1] = np.uint64(2**64 - 1)
    k2[1:2] = np.uint64(0)
    return [rng.integers(0, 2, n).astype(np.uint8),
            rng.integers(0, 50, n).astype(np.uint64),
            np.zeros(n, np.uint8), k2]


@pytest.mark.parametrize("n", [1, 7, 1000, 5000, 4097])
@pytest.mark.parametrize("limit", [None, 1, 10])
def test_lexsort_matches_jax_and_numpy(n, limit):
    keys = _keys(n, 42 + n)
    want = np.lexsort(tuple(reversed(keys)))[:limit]
    port = port_sort.device_lexsort(keys, n, limit, CPU)
    ref = jax_sort.device_lexsort(keys, n, limit=limit)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(ref, want)
    assert port.dtype == np.int64 and len(port) == min(n, limit or n)


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int16, np.int32,
                                   np.int64, np.float32, np.float64])
def test_reorder_rows_matches_numpy(dtype):
    rng = np.random.default_rng(8)
    n = 10_001
    lanes = [(rng.normal(size=n) * 100).astype(dtype) for _ in range(3)]
    for order in (rng.permutation(n), rng.integers(0, n, 777)):
        got = reorder_rows(torch.from_numpy(order),
                           [torch.from_numpy(a) for a in lanes])
        for g, a in zip(got, lanes):
            assert g.numpy().dtype == a.dtype
            np.testing.assert_array_equal(g.numpy(), a[order])


def _sort_table(n=60_000, seed=3, parts=4):
    """Ints with NULLs, floats with NaN and NULLs, dictionary strings with
    NULLs, in `parts` batches."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 100, n).astype(np.int64)
    av = rng.random(n) > 0.05
    x = rng.normal(size=n).round(2)
    x[rng.random(n) < 0.02] = np.nan
    xv = rng.random(n) > 0.05
    words = np.array(sorted(["apple", "b", "banana", "cherry", "date", "é"]),
                     dtype=object)
    s = rng.integers(0, len(words), n).astype(np.int32)
    sv = rng.random(n) > 0.1
    schema = Schema([Field("a", dt.INT64, True), Field("x", dt.FLOAT64, True),
                     Field("s", dt.STRING, True), Field("i", dt.INT64, False)])
    cuts = np.linspace(0, n, parts + 1).astype(int)
    batches = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sl = slice(lo, hi)
        batches.append(Batch(schema, [
            Column(dt.INT64, a[sl], av[sl]), Column(dt.FLOAT64, x[sl], xv[sl]),
            Column(dt.STRING, s[sl], sv[sl], Dictionary(words)),
            Column(dt.INT64, np.arange(lo, hi, dtype=np.int64))], hi - lo))
    return schema, batches


SORT_SQL = [
    "SELECT a, x, i FROM t ORDER BY a DESC, x LIMIT 500",
    "SELECT a, i FROM t ORDER BY a NULLS FIRST, i DESC",
    "SELECT x, i FROM t ORDER BY x DESC NULLS LAST, i LIMIT 2000",
    "SELECT x, i FROM t ORDER BY x NULLS FIRST LIMIT 300",
    "SELECT s, a, i FROM t ORDER BY s, a DESC NULLS LAST, i LIMIT 1000",
    "SELECT s, i FROM t ORDER BY s DESC NULLS FIRST, i",
]


@pytest.fixture(scope="module")
def sort_pair():
    schema, batches = _sort_table()
    ref = df.SessionContext()
    ref.register_table("t", df.MemTable(schema, [batches]))
    port = dft.SessionContext(CPU)
    pb = twin(batches)
    port.register_table("t", dft.MemTable(pb[0].schema, [pb]))
    port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    return port, ref


def _count_device_sorts(monkeypatch):
    calls = []
    real = port_sort.device_lexsort

    def counted(words, n, limit, device):
        calls.append(n)
        return real(words, n, limit, device)
    monkeypatch.setattr(port_sort, "device_lexsort", counted)
    return calls


@pytest.mark.parametrize("sql", SORT_SQL)
def test_sort_exec_matches_jax(sort_pair, sql, monkeypatch):
    port, ref = sort_pair
    monkeypatch.setattr(jax_sort, "DEFAULT_MIN_ROWS", 1)
    calls = _count_device_sorts(monkeypatch)
    got = port.sql(sql).to_pydict()
    want = ref.sql(sql).to_pydict()
    assert got.keys() == want.keys()
    for k in want:   # NaN != NaN: compare through repr
        assert [repr(v) for v in got[k]] == [repr(v) for v in want[k]], k
    # LIMIT over four batches sorts each batch, then the survivors
    assert len(calls) == (5 if "LIMIT" in sql else 1)


def test_sort_threshold_keeps_small_sorts_on_the_host(sort_pair, monkeypatch):
    port, _ref = sort_pair
    calls = _count_device_sorts(monkeypatch)
    port.sql("SET datafusion.tpu.device_sort_min_rows = 100000")
    try:
        port.sql("SELECT a FROM t ORDER BY a LIMIT 5").collect()
    finally:
        port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    assert calls == []


@pytest.fixture(scope="module")
def hits():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_hits_both(port, ref, n=HITS_ROWS)
    port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    return port, ref


@pytest.mark.parametrize("q", [25, 26, 27])
def test_clickbench_sorts_match_jax(hits, q, monkeypatch):
    """Q25-Q27: SortExec(fetch=10) over the host filter SearchPhrase <> '':
    one device sort over the filtered rows."""
    port, ref = hits
    monkeypatch.setattr(jax_sort, "DEFAULT_MIN_ROWS", 1)
    calls = _count_device_sorts(monkeypatch)
    got = port.sql(CB[q]).to_pydict()
    want = ref.sql(CB[q]).to_pydict()
    assert got == want
    assert len(got["SearchPhrase"]) == 10
    assert len(calls) == 1 and calls[0] > HITS_ROWS // 3
