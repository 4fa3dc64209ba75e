"""Work table for recursive CTE iteration.

Reference parity: `WorkTable`/`WorkTableExec`
(`datafusion/physical-plan/src/work_table.rs:159`) and the cte_worktable
provider (`datafusion/core/src/datasource/cte_worktable.rs`).
"""
from __future__ import annotations

from typing import List, Optional

from ..common.batch import Batch
from ..common.schema import Schema
from .provider import TableProvider


class WorkTableProvider(TableProvider):
    """Holds the previous iteration's batches during recursive-CTE execution."""

    def __init__(self, name: str, schema: Schema):
        self.name = name
        self._schema = schema
        self.batches: List[Batch] = []

    def schema(self) -> Schema:
        return self._schema

    def update(self, batches: List[Batch]) -> None:
        self.batches = batches

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.scan import WorkTableExec
        return WorkTableExec(self, projection)
