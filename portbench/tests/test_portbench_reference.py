"""Every query template of every cell: the plain reference against the
port on the CPU (its kernels' plain versions) at a tiny scale."""
import pytest

from portbench import check, harness, program
from portbench.reference.common import Arith
from portbench.tests.common import BIG_SEED, CELLS

# large enough that every query finds rows (Q21 needs SAUDI suppliers)
SCALE = {"tpch-sf10-chains": 1e-3, "tpch-sf10-scan": 1e-3,
         "clickbench-hits-sums": 1e-4}

CASES = [(c, q) for c in CELLS for q in harness.Cell(c).workload["queries"]]


@pytest.mark.parametrize("seed", [3, BIG_SEED])
@pytest.mark.parametrize("cell,query", CASES)
def test_reference_matches_the_port_on_the_cpu(cell, query, seed):
    c = harness.Cell(cell)
    tables = harness.to_host(c.tables(seed, "cpu", SCALE[cell]))
    ctx = program.session("cpu")
    program.register(ctx, tables)
    got = check.rows_of(ctx.sql(c.sql[query]).collect_batch())
    want = c.references[query](harness.to_device(tables, "cpu"), Arith())
    assert want, "the reference finds rows at this scale"
    numbers = check.judge([(query, got)], {query: want},
                          c.workload["limits"])
    assert check.passed(numbers), (numbers, got[:5], want[:5])
