"""TableProvider — the pluggable source interface.

Reference parity: `TableProvider` trait (`datafusion/core/src/datasource/
provider.rs:38,153,241,276`): `schema()`, `scan(projection, filters, limit)`,
`supports_filters_pushdown`, `statistics`, `insert_into`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..common.errors import NotImplementedError_
from ..common.schema import Schema
from ..common.stats import Statistics


class TableProvider:
    def schema(self) -> Schema:
        raise NotImplementedError_(type(self).__name__)

    def scan(self, projection: Optional[List[int]], filters: Sequence,
             limit: Optional[int], ctx):
        """Return an ExecutionPlan for reading this table."""
        raise NotImplementedError_(type(self).__name__)

    def supports_filters_pushdown(self, filters: Sequence) -> List[str]:
        """Per filter: 'exact' (fully applied by source), 'inexact'
        (best-effort, must be re-applied), or 'unsupported'."""
        return ["unsupported"] * len(filters)

    def column_ndv(self, index: int):
        """Number of distinct values in a column, or None when unknown.
        Used by join-order estimation (reference: ColumnStatistics
        distinct_count, stats.rs)."""
        return None

    def statistics(self) -> Statistics:
        return Statistics.unknown(len(self.schema()))

    def insert_into(self, batches, overwrite: bool = False) -> int:
        raise NotImplementedError_(f"{type(self).__name__} does not support INSERT")

    def logical_plan(self):
        """Views return their definition here; tables return None."""
        return None
