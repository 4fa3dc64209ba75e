"""RepartitionExec — the exchange operator.

Reference parity: `repartition/mod.rs:391` (BatchPartitioner hash/round-robin
with the same fixed-seed hash as the join build, `mod.rs:211,244-274`).

Host path: each output partition's stream materializes the input once
(shared across output partitions) and re-buckets rows with the
deterministic `create_hashes % n`. The distributed path replaces this with
an on-device radix-bucket kernel + `jax.lax.all_to_all` over the mesh
(see `datafusion_tpu/parallel/exchange.py`); both use the identical hash so
placement agrees with the partitioned-join build.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ...common.batch import Batch
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import PhysicalExpr
from ..hashing import create_hashes
from .base import ExecutionPlan, Partitioning, PartitioningKind


class RepartitionExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, partitioning: Partitioning):
        super().__init__()
        self.input = input
        self.partitioning = partitioning
        self._buckets: Optional[List[List[Batch]]] = None

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return RepartitionExec(c[0], self.partitioning)

    def output_partitioning(self):
        return self.partitioning

    def _materialize(self, ctx: TaskContext) -> List[List[Batch]]:
        if self._buckets is not None:
            return self._buckets
        n = self.partitioning.n
        buckets: List[List[Batch]] = [[] for _ in range(n)]
        in_parts = self.input.output_partitioning().n
        if self.partitioning.kind == PartitioningKind.HASH:
            exprs: List[PhysicalExpr] = self.partitioning.exprs
            for p in range(in_parts):
                for b in self.input.execute(p, ctx):
                    keys = [e.evaluate(b) for e in exprs]
                    h = create_hashes(keys, b.num_rows)
                    dest = (h % np.uint64(n)).astype(np.int64)
                    for d in range(n):
                        mask = dest == d
                        if mask.any():
                            buckets[d].append(b.filter_host(mask))
        else:  # round robin over batches
            i = 0
            for p in range(in_parts):
                for b in self.input.execute(p, ctx):
                    buckets[i % n].append(b)
                    i += 1
        self._buckets = buckets
        return buckets

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        buckets = self._materialize(ctx)
        for b in buckets[partition]:
            m.record_output(b.num_rows)
            yield b

    def display_line(self):
        return f"RepartitionExec: partitioning={self.partitioning}"
