"""View tables.

Reference parity: `datafusion/core/src/datasource/view.rs` — a table whose
scan inlines a stored LogicalPlan.
"""
from __future__ import annotations

from .provider import TableProvider


class ViewTable(TableProvider):
    def __init__(self, plan, definition: str = ""):
        self.plan = plan
        self.definition = definition

    def schema(self):
        return self.plan.schema

    def logical_plan(self):
        return self.plan

    def scan(self, projection, filters, limit, ctx):
        raise NotImplementedError("views are inlined during SQL planning")
