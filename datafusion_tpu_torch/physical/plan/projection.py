"""ProjectionExec + FilterExec + LimitExec + UnionExec + coalesce ops.

Reference parity: projection.rs:52, filter.rs:56, limit.rs:113/323,
union.rs:185, coalesce_batches.rs:44, coalesce_partitions.rs:39.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ...common.batch import Batch, concat_batches
from ...common.schema import Field, Schema
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from ..expressions import PhysicalExpr
from .base import ExecutionPlan, Partitioning


class ProjectionExec(ExecutionPlan):
    def __init__(self, exprs: List[PhysicalExpr], names: List[str],
                 input: ExecutionPlan,
                 nullables: Optional[List[bool]] = None):
        super().__init__()
        self.exprs = exprs
        self.names = names
        self.input = input
        self.nullables = nullables
        in_schema = input.schema()
        fields = []
        for i, (e, name) in enumerate(zip(exprs, names)):
            qualifier = None
            nullable = True
            from ..expressions import ColumnExpr
            if isinstance(e, ColumnExpr):
                f_in = in_schema.field(e.index)
                qualifier = f_in.qualifier
                nullable = f_in.nullable
            if nullables is not None and i < len(nullables):
                nullable = nullables[i]
            fields.append(Field(name, e.out_type, nullable,
                                qualifier=qualifier))
        self._schema = Schema(fields)

    def schema(self):
        return self._schema

    def children(self):
        return [self.input]

    def with_children(self, c):
        return ProjectionExec(self.exprs, self.names, c[0], self.nullables)

    def output_partitioning(self):
        return self.input.output_partitioning()

    def maintains_input_order(self):
        return True

    def output_ordering(self):
        o = self.output_orderings()
        return o[0] if o else None

    def output_orderings(self):
        """Orderings re-expressed in the output column space
        (EquivalenceProperties::project, equivalence/projection.rs)."""
        if self.input is None:
            return []
        return self.equivalence_properties().orderings

    def equivalence_properties(self):
        """Child properties mapped through the projection: aliases of one
        input expression join an equivalence class; orderings/constants
        follow surviving columns (equivalence/projection.rs)."""
        pairs = [(str(e), f"{self.names[i]}@{i}")
                 for i, e in enumerate(self.exprs)]
        return self.input.equivalence_properties().project(pairs)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        for b in self.input.execute(partition, ctx):
            with m.elapsed_compute:
                cols = [e.evaluate(b) for e in self.exprs]
                out = Batch(self._schema, cols, b.num_rows)
            m.record_output(out.num_rows)
            yield out

    def display_line(self):
        items = [f"{e}" if str(e) == n else f"{e} as {n}"
                 for e, n in zip(self.exprs, self.names)]
        return f"ProjectionExec: expr=[{', '.join(items)}]"


class FilterExec(ExecutionPlan):
    def __init__(self, predicate: PhysicalExpr, input: ExecutionPlan):
        super().__init__()
        self.predicate = predicate
        self.input = input

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return FilterExec(self.predicate, c[0])

    def output_partitioning(self):
        return self.input.output_partitioning()

    def maintains_input_order(self):
        return True

    def equivalence_properties(self):
        """Child properties + `a = b` / `a = lit` conjuncts of the
        predicate (reference: FilterExec::equivalence_properties,
        filter.rs:180)."""
        from ..equivalence import properties_from_filter
        return properties_from_filter(self.input.equivalence_properties(),
                                      self.predicate)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        for b in self.input.execute(partition, ctx):
            with m.elapsed_compute:
                mask = K.true_mask(self.predicate.evaluate(b))
                out = b.filter_host(mask[: b.num_rows])
            m.record_output(out.num_rows)
            if out.num_rows:
                yield out

    def display_line(self):
        return f"FilterExec: {self.predicate}"


class GlobalLimitExec(ExecutionPlan):
    """skip/fetch over a single input partition (reference: limit.rs:323)."""

    def __init__(self, input: ExecutionPlan, skip: int = 0,
                 fetch: Optional[int] = None):
        super().__init__()
        self.input = input
        self.skip = skip
        self.fetch = fetch

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return GlobalLimitExec(c[0], self.skip, self.fetch)

    def maintains_input_order(self):
        return True

    def unbounded(self):
        return False

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        to_skip = self.skip
        remaining = self.fetch
        from .base import execute_stream
        for b in execute_stream(self.input, ctx) if partition == 0 else iter(()):
            if to_skip > 0:
                if b.num_rows <= to_skip:
                    to_skip -= b.num_rows
                    continue
                b = b.slice_host(to_skip, b.num_rows - to_skip)
                to_skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                if b.num_rows > remaining:
                    b = b.slice_host(0, remaining)
                remaining -= b.num_rows
            m.record_output(b.num_rows)
            yield b

    def display_line(self):
        f = "None" if self.fetch is None else str(self.fetch)
        return f"GlobalLimitExec: skip={self.skip}, fetch={f}"


class LocalLimitExec(ExecutionPlan):
    """Per-partition fetch (reference: limit.rs:113)."""

    def __init__(self, input: ExecutionPlan, fetch: int):
        super().__init__()
        self.input = input
        self.fetch = fetch

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return LocalLimitExec(c[0], self.fetch)

    def output_partitioning(self):
        return self.input.output_partitioning()

    def maintains_input_order(self):
        return True

    def unbounded(self):
        return False

    def execute(self, partition, ctx):
        remaining = self.fetch
        for b in self.input.execute(partition, ctx):
            if remaining <= 0:
                return
            if b.num_rows > remaining:
                b = b.slice_host(0, remaining)
            remaining -= b.num_rows
            yield b

    def display_line(self):
        return f"LocalLimitExec: fetch={self.fetch}"


class UnionExec(ExecutionPlan):
    """Partition concatenation (reference: union.rs:185)."""

    def __init__(self, inputs: List[ExecutionPlan]):
        super().__init__()
        self.inputs = inputs
        self._schema = inputs[0].schema()
        # partition p of the union maps to (input i, partition j)
        self._map = []
        for i, inp in enumerate(inputs):
            for j in range(inp.output_partitioning().n):
                self._map.append((i, j))

    def schema(self):
        return self._schema

    def children(self):
        return list(self.inputs)

    def with_children(self, c):
        return UnionExec(list(c))

    def output_partitioning(self):
        return Partitioning.unknown(len(self._map))

    def execute(self, partition, ctx):
        i, j = self._map[partition]
        schema = self._schema
        for b in self.inputs[i].execute(j, ctx):
            # re-stamp the union schema (names/qualifiers of the first input)
            yield Batch(schema, b.columns, b.num_rows)


class InterleaveExec(ExecutionPlan):
    """Partition-aligned union: output partition p streams partition p of
    EVERY input, keeping the partition count (and any shared hash
    partitioning) intact instead of multiplying partitions like UnionExec
    (reference: union.rs InterleaveExec)."""

    def __init__(self, inputs: List[ExecutionPlan]):
        super().__init__()
        self.inputs = inputs
        self._schema = inputs[0].schema()
        self._n = max(i.output_partitioning().n for i in inputs)

    def schema(self):
        return self._schema

    def children(self):
        return list(self.inputs)

    def with_children(self, c):
        return InterleaveExec(list(c))

    def output_partitioning(self):
        return self.inputs[0].output_partitioning()

    def execute(self, partition, ctx):
        schema = self._schema
        for inp in self.inputs:
            if partition < inp.output_partitioning().n:
                for b in inp.execute(partition, ctx):
                    yield Batch(schema, b.columns, b.num_rows)

    def display_line(self):
        return "UnionExec"


class CoalescePartitionsExec(ExecutionPlan):
    """N partitions -> 1 unordered (reference: coalesce_partitions.rs:39)."""

    def __init__(self, input: ExecutionPlan):
        super().__init__()
        self.input = input

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return CoalescePartitionsExec(c[0])

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition, ctx):
        assert partition == 0
        n = self.input.output_partitioning().n
        if n == 1:
            yield from self.input.execute(0, ctx)
            return
        # one puller per partition, results fan in through a queue in
        # arrival order (reference: RecordBatchReceiverStream,
        # stream.rs:212 — a spawned task per partition feeding a channel)
        from .base import parallel_partition_stream
        yield from parallel_partition_stream(self.input, ctx, ordered=False)

    def display_line(self):
        return "CoalescePartitionsExec"


class CoalesceBatchesExec(ExecutionPlan):
    """Concat small batches up to target size (reference:
    coalesce_batches.rs:44). On TPU this re-tiles ragged post-filter
    occupancy into full tiles."""

    def __init__(self, input: ExecutionPlan, target: int):
        super().__init__()
        self.input = input
        self.target = target

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return CoalesceBatchesExec(c[0], self.target)

    def output_partitioning(self):
        return self.input.output_partitioning()

    def maintains_input_order(self):
        return True

    def execute(self, partition, ctx):
        buf: List[Batch] = []
        buffered = 0
        for b in self.input.execute(partition, ctx):
            if b.num_rows == 0:
                continue
            buf.append(b)
            buffered += b.num_rows
            if buffered >= self.target:
                yield concat_batches(self.schema(), buf)
                buf, buffered = [], 0
        if buf:
            yield concat_batches(self.schema(), buf)

    def display_line(self):
        return f"CoalesceBatchesExec: target_batch_size={self.target}"
