"""Aggregates of more than 32 lanes: the kernels fold 32 lanes a pass and
run further passes over the same rows into further lane rows of one table
(`device/groupby.py`, `_ProgramSpec.passes`).

ClickBench Q30 (90 sums: 180 lanes, 6 passes) at 300,000 rows, and
queries of exactly 33, 64 and 65 lanes on the dense path (<= 64 slots)
and the hash path, through the port and the JAX package on the CPU (the
port's kernels run their plain versions). Integer sums and counts are
exact; float averages within rel 1e-12 (summation order).
"""
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu_torch.clickbench.workload import QUERIES as CB
from test_torch_distinct import execs, same, table
from torch_twin import register_both, register_hits_both

CPU = torch.device("cpu")


def _lanes_query(n_lanes: int, key: str) -> str:
    """A query of exactly n_lanes lanes: a sum of `v + i` is two (its sum
    and its count), count(*) one."""
    sums = [f"sum(v + {i}) s{i}" for i in range(n_lanes // 2)]
    star = ["count(*) c"] if n_lanes % 2 else []
    return (f"SELECT {key}, {', '.join(sums + star)} FROM t "
            f"GROUP BY {key} ORDER BY {key}")


@pytest.fixture(scope="module")
def ctxs():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_both(port, ref, "t", table(20_000, 1))
    return port, ref


def _spec(port, q):
    (ex,) = execs(port, q)[1]
    return ex, ex.compile(ex.input_batches(port.task_context()))[0]


@pytest.mark.parametrize("n_lanes", [33, 64, 65])
@pytest.mark.parametrize("key", ["g8", "g"], ids=["dense", "hash"])
def test_lanes_in_passes_match_jax(ctxs, n_lanes, key):
    port, ref = ctxs
    q = _lanes_query(n_lanes, key)
    same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
    ex, spec = _spec(port, q)
    assert ex.fallbacks == 0
    assert len(spec.lanes) == n_lanes
    assert [len(lanes) for _at, lanes in spec.passes] == \
        [32] * (n_lanes // 32) + ([n_lanes % 32] if n_lanes % 32 else [])
    assert len(spec.metas) == len(spec.passes)


def test_clickbench_q30():
    """ClickBench Q30: 90 sums of ResolutionWidth + i, no group key."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_hits_both(port, ref, n=300_000)
    q = CB[30]
    same(port.sql(q).to_pydict(), ref.sql(q).to_pydict())
    ex, spec = _spec(port, q)
    assert ex.fallbacks == 0 and len(spec.lanes) == 180
    assert len(spec.passes) == 6
