"""UnnestExec — flatten list columns.

Reference parity: `unnest.rs:128`. List columns are host object arrays of
python lists (built by array_agg / make_array); unnest expands each row's
list and repeats the other columns (NULL/empty lists produce no row,
matching the reference's default)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from ...common.batch import Batch
from ...common.column import Column
from ...common.schema import Schema
from ...runtime import BaselineMetrics, TaskContext
from .base import ExecutionPlan, Partitioning


class UnnestExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, column_index: int,
                 schema: Schema):
        super().__init__()
        self.input = input
        self.column_index = column_index
        self._schema = schema

    def schema(self):
        return self._schema

    def children(self):
        return [self.input]

    def with_children(self, c):
        return UnnestExec(c[0], self.column_index, self._schema)

    def output_partitioning(self):
        return self.input.output_partitioning()

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        ci = self.column_index
        for b in self.input.execute(partition, ctx):
            with m.elapsed_compute:
                lists = b.columns[ci].data_host()
                valid = b.columns[ci].validity_host()
                counts = np.fromiter(
                    (len(lists[i]) if (valid is None or valid[i]) and
                     lists[i] is not None else 0
                     for i in range(b.num_rows)), dtype=np.int64,
                    count=b.num_rows)
                total = int(counts.sum())
                if total == 0:
                    continue
                rep = np.repeat(np.arange(b.num_rows), counts)
                flat = [v for i in range(b.num_rows)
                        if counts[i] for v in lists[i]]
                cols = []
                for j, c in enumerate(b.columns):
                    if j == ci:
                        arr = np.array(flat, dtype=object)
                        inner_t = self._schema.field(j).dtype
                        if inner_t.is_string:
                            cols.append(Column.from_numpy(arr))
                        else:
                            validity = np.array([v is not None for v in flat])
                            safe = np.array(
                                [v if v is not None else 0 for v in flat])
                            cols.append(Column(
                                inner_t, safe.astype(inner_t.device_dtype()),
                                None if validity.all() else validity))
                    else:
                        cols.append(c.take_host(rep))
                out = Batch(self._schema, cols, total)
            m.record_output(out.num_rows)
            yield out

    def display_line(self):
        return f"UnnestExec: column={self._schema.field(self.column_index).name}"
