"""RecursiveQueryExec — recursive CTE iteration.

Reference parity: `recursive_query.rs:110` + `work_table.rs:159`: run the
static term, then iterate the recursive term against a work table holding
the previous iteration's rows until it produces nothing.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from ...common.batch import Batch, concat_batches
from ...common.errors import ExecutionError
from ...runtime import TaskContext
from .base import ExecutionPlan, Partitioning

_MAX_ITERATIONS = 10_000


class RecursiveQueryExec(ExecutionPlan):
    def __init__(self, name: str, static_term: ExecutionPlan,
                 recursive_term: ExecutionPlan, provider, is_distinct: bool):
        super().__init__()
        self.name = name
        self.static_term = static_term
        self.recursive_term = recursive_term
        self.provider = provider   # WorkTableProvider shared with the scan leaf
        self.is_distinct = is_distinct

    def schema(self):
        return self.static_term.schema()

    def children(self):
        return [self.static_term, self.recursive_term]

    def with_children(self, c):
        return RecursiveQueryExec(self.name, c[0], c[1], self.provider,
                                  self.is_distinct)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from .base import collect
        seen_keys = None
        batches = collect(self.static_term, ctx)
        if self.is_distinct:
            batches, seen_keys = self._dedup(batches, None)
        yield from batches
        self.provider.update(batches)
        for _ in range(_MAX_ITERATIONS):
            if not self.provider.batches:
                return
            # per-execution operator state (e.g. a join's CollectLeft build
            # over the work table) must not leak across iterations
            self.recursive_term.reset_state_recursive()
            new = collect(self.recursive_term, ctx)
            if self.is_distinct:
                new, seen_keys = self._dedup(new, seen_keys)
            new = [b for b in new if b.num_rows > 0]
            if not new:
                return
            yield from new
            self.provider.update(new)
        raise ExecutionError(
            f"recursive CTE '{self.name}' exceeded {_MAX_ITERATIONS} iterations")

    def _dedup(self, batches, seen_keys):
        """UNION (distinct) semantics: drop rows already produced."""
        from ..hashing import create_hashes
        out = []
        seen = seen_keys if seen_keys is not None else np.zeros(0, np.uint64)
        for b in batches:
            h = create_hashes(list(b.columns), b.num_rows)
            # dedup within batch then against history (hash-based; exact
            # comparison omitted — collision odds ~2^-64 per pair)
            _, first = np.unique(h, return_index=True)
            mask = np.zeros(b.num_rows, bool)
            mask[first] = True
            mask &= ~np.isin(h, seen)
            seen = np.concatenate([seen, h[mask]])
            if mask.any():
                out.append(b.filter_host(mask))
        return out, seen

    def display_line(self):
        return f"RecursiveQueryExec: name={self.name}, is_distinct={self.is_distinct}"
