"""OptimizeProjections — prune unused columns at the scans.

Reference parity: `datafusion/optimizer/src/optimize_projections/` (the
reference prunes projections at every node; here we prune the TableScan
projection — where nearly all the win is: it shrinks host->device transfer
and scan decode width).

Safety rule: a scan column is kept if its *name* is referenced anywhere in
the plan's expressions or in the plan's output schema. Matching by bare
name over-retains on cross-table name collisions, which is safe.
"""
from __future__ import annotations

from typing import Set

from ..expr import expr as E
from ..expr import plan as L


def _collect_names(plan: L.LogicalPlan, out: Set[str]) -> None:
    for f in plan.schema.fields:
        pass  # output schema handled by caller at root
    for e in plan.expressions():
        _expr_names(e, out)
    for c in plan.inputs:
        _collect_names(c, out)


def _expr_names(e: E.Expr, out: Set[str]) -> None:
    if isinstance(e, E.Column):
        out.add(e.name)
    if isinstance(e, (E.ScalarSubquery, E.Exists, E.InSubquery)):
        _collect_names(e.subquery, out)
        for f in e.subquery.schema.fields:
            out.add(f.name)
    if isinstance(e, E.OuterRef):
        out.add(e.column.name)
    for c in e.children():
        _expr_names(c, out)


class OptimizeProjections:
    name = "optimize_projections"

    @staticmethod
    def _narrow_semi_inputs(plan: L.LogicalPlan) -> L.LogicalPlan:
        """SEMI/ANTI joins emit no right-side columns, so the right input
        needs only its join-key + join-filter columns. Decorrelated EXISTS
        subqueries arrive as `SELECT *` projections (all 16 lineitem
        columns for TPC-H Q4/Q21) — narrowing them here lets the scan
        pruning below cut the decode/transfer width (reference:
        optimize_projections/ required-columns propagation)."""
        def f(node):
            if not isinstance(node, L.Join) or \
                    node.join_type not in ("LEFTSEMI", "LEFTANTI"):
                return node
            need: Set[str] = set()
            for _l, r in node.on:
                _expr_names(r, need)
            if node.filter is not None:
                _expr_names(node.filter, need)
            right = node.right
            alias = None
            if isinstance(right, L.SubqueryAlias):
                alias, right = right, right.input
            if not isinstance(right, L.Projection):
                return node
            def out_name(e):
                if isinstance(e, E.Alias):
                    return e.name
                if isinstance(e, E.Column):
                    return e.name
                return e.display_name()
            keep = [e for e in right.exprs if out_name(e) in need]
            if not keep or len(keep) == len(right.exprs):
                return node
            new_right: L.LogicalPlan = L.Projection(keep, right.input)
            if alias is not None:
                new_right = L.SubqueryAlias(new_right, alias.alias)
            return L.Join(node.left, new_right, node.on, node.filter,
                          node.join_type, node.using_columns)
        return plan.transform_up(f)

    def rewrite(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        plan = self._narrow_semi_inputs(plan)
        required: Set[str] = set()
        _collect_names(plan, required)
        for f in plan.schema.fields:
            required.add(f.name)

        def f(node):
            if isinstance(node, L.TableScan) and node.projection is None:
                schema = node.source.schema()
                keep = [i for i, fld in enumerate(schema.fields)
                        if fld.name in required]
                if len(keep) < len(schema.fields):
                    return L.TableScan(node.name, node.source, keep,
                                       getattr(node, "filters", []) or [],
                                       getattr(node, "fetch", None))
            return node
        return plan.transform_up(f)
