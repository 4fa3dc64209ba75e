"""The harness drives a whole run on the CPU (all but its look for a card)
with the program broken underneath, and `correct` comes out false: an
answer altered where it is produced, and half of each table's rows left
out of the scan. The same run unbroken is correct."""
import pytest

from portbench import harness
from portbench.tests.common import BIG_SEED, CELLS, SCALE


def run(cell, seed=BIG_SEED):
    return harness.run(cell, seed, 0.5, False, "cpu", scale=SCALE[cell],
                       log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from datafusion_tpu_torch.api.dataframe import DataFrame
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.column import Column
    collect = DataFrame.collect_batch
    calls = []
    spec = harness.Cell(cell).workload
    # the first answer past the warm round: the window's first, which
    # comes however slow the host is
    nth = len(spec["queries"]) + 1

    def altered(self):
        b = collect(self)
        calls.append(1)
        if len(calls) != nth:
            return b
        c = b.columns[-1]
        data = c.data_host().copy()
        data[0] = data[0] * (1 + 1e-6) if data.dtype.kind == "f" \
            else data[0] + 1
        return Batch(b.schema, b.columns[:-1] + [
            Column(c.dtype, data, c.validity_host(), c.dictionary)],
            b.num_rows)
    monkeypatch.setattr(DataFrame, "collect_batch", altered)
    r = run(cell)
    assert len(calls) >= nth and not r["correct"]
    assert r["check"]["wrong_cells"]["value"] + \
        r["check"].get("float_rel_err", {"value": 0})["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_rows_left_out_of_the_scan(cell, monkeypatch):
    from datafusion_tpu_torch.datasource.memory import MemTable
    scan = MemTable.scan

    def half(self, projection, filters, limit, ctx):
        halved = MemTable(self.schema(), [
            [b.slice_host(0, b.num_rows // 2) for b in part]
            for part in self.partitions])
        return scan(halved, projection, filters, limit, ctx)
    monkeypatch.setattr(MemTable, "scan", half)
    r = run(cell)
    assert not r["correct"] and r["check"]["wrong_cells"]["value"] > 0
