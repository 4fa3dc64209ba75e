"""Leaf operators: in-memory scan, VALUES, empty relations.

Reference parity: MemoryExec (`physical-plan/src/memory.rs:105`),
ValuesExec (`values.rs:156`), EmptyExec (`empty.rs:103`),
PlaceholderRowExec (`placeholder_row.rs:121`).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ...common import dt
from ...common.batch import Batch
from ...common.column import Column
from ...common.schema import Field, Schema
from ...runtime import BaselineMetrics, TaskContext
from .base import ExecutionPlan, Partitioning


class MemoryExec(ExecutionPlan):
    """Scan over a MemTable's partitions of in-memory (possibly
    device-resident) batches — the 'tpch_mem' mode of the reference."""

    def __init__(self, table, projection: Optional[List[int]] = None,
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(max(1, len(self.table.partitions)))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        remaining = self.limit
        parts = self.table.partitions
        batches = parts[partition] if partition < len(parts) else []
        for b in batches:
            if self.projection is not None:
                b = b.project(self.projection)
            if remaining is not None:
                if remaining <= 0:
                    return
                if b.num_rows > remaining:
                    b = b.slice_host(0, remaining)
                remaining -= b.num_rows
            m.record_output(b.num_rows)
            yield b

    def display_line(self):
        proj = "" if self.projection is None else \
            f", projection=[{', '.join(self._schema.names())}]"
        return f"MemoryExec: partitions={len(self.table.partitions)}{proj}"


class ValuesExec(ExecutionPlan):
    """Literal VALUES rows (reference: values.rs:156). Rows are evaluated
    against a one-row placeholder batch so arbitrary expressions work."""

    def __init__(self, schema: Schema, rows):
        super().__init__()
        self._schema = schema
        self.rows = rows  # List[List[PhysicalExpr]]

    def schema(self):
        return self._schema

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from ...common.batch import concat_batches
        one = _placeholder_batch()
        row_batches = []
        for row in self.rows:
            cols = []
            for i, e in enumerate(row):
                c = e.evaluate(one)
                want = self._schema.field(i).dtype
                if c.dtype != want and not (c.dtype.is_string and want.is_string):
                    from .. import kernels as K
                    c = K.cast_column(c, want)
                cols.append(c)
            row_batches.append(Batch(self._schema, cols, 1))
        yield concat_batches(self._schema, row_batches)

    def display_line(self):
        return f"ValuesExec: rows={len(self.rows)}"


class EmptyExec(ExecutionPlan):
    def __init__(self, schema: Schema):
        super().__init__()
        self._schema = schema

    def schema(self):
        return self._schema

    def execute(self, partition, ctx):
        return iter(())

    def display_line(self):
        return "EmptyExec"


class PlaceholderRowExec(ExecutionPlan):
    """One row, zero columns — for SELECT <exprs> with no FROM
    (reference: placeholder_row.rs:121)."""

    def __init__(self, schema: Optional[Schema] = None):
        super().__init__()
        self._schema = schema or Schema.empty()

    def schema(self):
        return self._schema

    def execute(self, partition, ctx) -> Iterator[Batch]:
        yield _placeholder_batch(self._schema)

    def display_line(self):
        return "PlaceholderRowExec"


class WorkTableExec(ExecutionPlan):
    """Scan of the recursive-CTE work table
    (reference: physical-plan/src/work_table.rs:159)."""

    def __init__(self, provider, projection: Optional[List[int]] = None):
        super().__init__()
        self.provider = provider
        self.projection = projection
        base = provider.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self):
        return self._schema

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.provider.batches:
            if self.projection is not None:
                b = b.project(self.projection)
            yield b

    def display_line(self):
        return f"WorkTableExec: name={self.provider.name}"


def _placeholder_batch(schema: Optional[Schema] = None) -> Batch:
    schema = schema if schema is not None and len(schema) else \
        Schema([Field("__placeholder", dt.INT32, False)])
    cols = [Column(f.dtype, np.zeros(1, f.dtype.device_dtype())) for f in schema]
    return Batch(schema, cols, 1)


class StreamingTableExec(ExecutionPlan):
    """Scan over an unbounded / streaming source (reference:
    `physical-plan/src/streaming.rs:207`). Batches flow straight from the
    provider's iterator factory; `unbounded()` marks infinite sources for
    the PipelineChecker rule."""

    def __init__(self, table, projection: Optional[List[int]] = None,
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) \
            if projection is not None else base

    def schema(self) -> Schema:
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def unbounded(self) -> bool:
        return bool(getattr(self.table, "unbounded", False))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        remaining = self.limit
        for b in self.table.source():
            if self.projection is not None:
                b = b.project(self.projection)
            if remaining is not None:
                if remaining <= 0:
                    return
                if b.num_rows > remaining:
                    import numpy as np
                    b = b.take_host(np.arange(remaining))
                remaining -= b.num_rows
            m.record_output(b.num_rows)
            yield b

    def display_line(self):
        ub = ", unbounded" if self.unbounded() else ""
        return f"StreamingTableExec: projection={self._schema.names()}{ub}"
