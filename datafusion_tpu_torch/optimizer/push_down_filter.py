"""PushDownFilter — move predicates toward the scans.

Reference parity: `datafusion/optimizer/src/push_down_filter.rs` (the most
important single rule in the reference at 2.9k LoC; this is the TPU
engine's equivalent covering Projection/Filter/Join/SubqueryAlias/Union/
Aggregate/Sort/Limit hops).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..expr import expr as E
from ..expr import plan as L
from .predicate_utils import (columns_in_schema, conjunction, expr_columns,
                              has_subquery, has_volatile, split_conjunction)


def _substitute(pred: E.Expr, mapping: Dict[Tuple[Optional[str], str], E.Expr]):
    """Replace Column refs via mapping; returns None if any column is
    unmapped."""
    ok = [True]

    def rw(node: E.Expr) -> E.Expr:
        if isinstance(node, E.Column):
            key = (node.qualifier, node.name)
            if key in mapping:
                return mapping[key]
            key2 = (None, node.name)
            if key2 in mapping:
                return mapping[key2]
            # unqualified lookup across qualifiers
            for (q, n), v in mapping.items():
                if n == node.name:
                    return v
            ok[0] = False
        return node
    out = pred.transform_up(rw)
    return out if ok[0] else None


class PushDownFilter:
    name = "push_down_filter"

    def rewrite(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        return self._opt(plan)

    def _opt(self, node: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(node, L.Filter):
            node = self._push_filter(node)
            if isinstance(node, L.Filter):
                new_in = self._opt(node.input)
                if new_in is not node.input:
                    node = L.Filter(node.predicate, new_in)
                return node
            return self._opt(node)
        return node.with_inputs([self._opt(c) for c in node.inputs]) \
            if node.inputs else node

    # ------------------------------------------------------------------
    def _push_filter(self, f: L.Filter) -> L.LogicalPlan:
        child = f.input
        conjuncts = split_conjunction(f.predicate)
        blocked = [c for c in conjuncts if has_volatile(c) or has_subquery(c)]
        movable = [c for c in conjuncts if not (has_volatile(c) or has_subquery(c))]
        if not movable:
            return f

        def rebuild(pushed_child: L.LogicalPlan, kept: List[E.Expr]):
            kept = kept + blocked
            pred = conjunction(kept)
            return L.Filter(pred, pushed_child) if pred is not None else pushed_child

        if isinstance(child, L.Filter):
            merged = conjunction(movable + blocked +
                                 split_conjunction(child.predicate))
            return self._push_filter(L.Filter(merged, child.input))

        if isinstance(child, L.Projection):
            mapping: Dict[Tuple[Optional[str], str], E.Expr] = {}
            schema = child.schema
            for fld, expr in zip(schema.fields, child.exprs):
                base = expr.expr if isinstance(expr, E.Alias) else expr
                mapping[(fld.qualifier, fld.name)] = base
            pushed, kept = [], []
            for c in movable:
                # don't duplicate expensive/window exprs; only push when the
                # substituted predicate contains no window/aggregate calls
                sub = _substitute(c, mapping)
                if sub is not None and not sub.contains(
                        lambda n: isinstance(n, (E.WindowFunction,
                                                 E.AggregateFunction))):
                    pushed.append(sub)
                else:
                    kept.append(c)
            if not pushed:
                return f
            inner = L.Filter(conjunction(pushed), child.input)
            new_child = L.Projection(child.exprs, self._push_filter(inner))
            return rebuild(new_child, kept)

        if isinstance(child, L.SubqueryAlias):
            # strip the alias qualifier so columns resolve in the child
            def strip(c):
                def rw(n):
                    if isinstance(n, E.Column) and n.qualifier == child.alias:
                        return E.Column(n.name)
                    return n
                return c.transform_up(rw)
            inner = L.Filter(conjunction([strip(c) for c in movable]), child.input)
            return rebuild(L.SubqueryAlias(self._push_filter(inner), child.alias),
                           [])

        if isinstance(child, L.Join):
            return self._push_join(f, child, movable, blocked)

        if isinstance(child, L.CrossJoin):
            # handled by EliminateCrossJoin; avoid infinite loops here
            return f

        if isinstance(child, L.Union):
            new_inputs = []
            for inp in child.inputs:
                # rewrite by position: union output names map to each
                # input's column at the same index
                mapping = {}
                for uf, cf in zip(child.schema.fields, inp.schema.fields):
                    mapping[(uf.qualifier, uf.name)] = E.Column(cf.name, cf.qualifier)
                subs = [_substitute(c, mapping) for c in movable]
                if any(s is None for s in subs):
                    return f
                new_inputs.append(self._push_filter(
                    L.Filter(conjunction(subs), inp)))
            return rebuild(child.with_inputs(new_inputs), [])

        if isinstance(child, L.Aggregate):
            group_names = set()
            for i, g in enumerate(child.output_group_exprs()):
                group_names.add(child.schema.field(i).name)
            mapping = {}
            for i, g in enumerate(child.output_group_exprs()):
                base = g.expr if isinstance(g, E.Alias) else g
                fld = child.schema.field(i)
                mapping[(fld.qualifier, fld.name)] = base
            pushed, kept = [], []
            for c in movable:
                cols = expr_columns(c)
                if cols and all(col.name in group_names for col in cols):
                    sub = _substitute(c, mapping)
                    if sub is not None:
                        pushed.append(sub)
                        continue
                kept.append(c)
            if not pushed:
                return f
            inner = self._push_filter(L.Filter(conjunction(pushed), child.input))
            new_child = child.with_inputs([inner])
            return rebuild(new_child, kept)

        if isinstance(child, L.Sort):
            inner = self._push_filter(L.Filter(f.predicate, child.input))
            return child.with_inputs([inner])

        if isinstance(child, (L.Distinct,)) and child.on_exprs is None:
            inner = self._push_filter(L.Filter(f.predicate, child.input))
            return child.with_inputs([inner])

        if isinstance(child, L.TableScan):
            # copy (not move) scan-local predicates into the scan for
            # stats-based pruning (reference: supports_filters_pushdown
            # Inexact mode — the Filter stays for exact re-evaluation)
            local = [c for c in movable
                     if columns_in_schema(expr_columns(c), child.schema)]
            if local and tuple(local) != child.filters:
                import dataclasses as _dc  # noqa: F401
                new_scan = type(child)(child.name, child.source,
                                       child.projection, tuple(local),
                                       child.fetch)
                return L.Filter(f.predicate, new_scan)
            return f

        return f

    # ------------------------------------------------------------------
    def _push_join(self, f: L.Filter, j: L.Join, movable: List[E.Expr],
                   blocked: List[E.Expr]) -> L.LogicalPlan:
        lschema, rschema = j.left.schema, j.right.schema
        jt = j.join_type
        push_left_ok = jt in ("INNER", "LEFT", "LEFTSEMI", "LEFTANTI")
        push_right_ok = jt in ("INNER", "RIGHT", "RIGHTSEMI", "RIGHTANTI")
        # for LEFT join, predicates on the *left* side can go below; on the
        # right they cannot (they would drop padded NULL rows prematurely)
        to_left, to_right, kept = [], [], []
        for c in movable:
            cols = expr_columns(c)
            if not cols:
                kept.append(c)
                continue
            only_left = columns_in_schema(cols, lschema) and jt not in (
                "RIGHTSEMI", "RIGHTANTI")
            only_right = columns_in_schema(cols, rschema) and not only_left
            if only_left and push_left_ok and jt in ("INNER", "LEFT",
                                                     "LEFTSEMI", "LEFTANTI"):
                to_left.append(c)
            elif only_right and push_right_ok:
                to_right.append(c)
            else:
                kept.append(c)
        if not to_left and not to_right:
            return f
        left = j.left
        right = j.right
        if to_left:
            left = self._push_filter(L.Filter(conjunction(to_left), left))
        if to_right:
            right = self._push_filter(L.Filter(conjunction(to_right), right))
        new_join = L.Join(left, right, j.on, j.filter, jt, j.using_columns)
        pred = conjunction(kept + blocked)
        return L.Filter(pred, new_join) if pred is not None else new_join


class EliminateFilter:
    """Filter(true) -> input; Filter(false) -> empty
    (reference: eliminate_filter.rs)."""
    name = "eliminate_filter"

    def rewrite(self, plan):
        def fn(node):
            if isinstance(node, L.Filter) and isinstance(node.predicate, E.Literal):
                v = node.predicate.value.value
                if v is True:
                    return node.input
                return L.EmptyRelation(False, node.input.schema)
            return node
        return plan.transform_up(fn)


class EliminateLimit:
    """Limit(fetch=None, skip=0) -> input; Limit(fetch=0) -> empty
    (reference: eliminate_limit.rs)."""
    name = "eliminate_limit"

    def rewrite(self, plan):
        def fn(node):
            if isinstance(node, L.Limit):
                if node.fetch == 0:
                    return L.EmptyRelation(False, node.input.schema)
                if node.fetch is None and node.skip == 0:
                    return node.input
            return node
        return plan.transform_up(fn)


class PushDownLimit:
    """Push fetch into Sort (top-k) and through Projection
    (reference: push_down_limit.rs)."""
    name = "push_down_limit"

    def rewrite(self, plan):
        def fn(node):
            if not isinstance(node, L.Limit) or node.fetch is None:
                return node
            total = node.skip + node.fetch
            child = node.input
            if isinstance(child, L.Sort):
                if child.fetch is None or child.fetch > total:
                    new_sort = L.Sort(child.sort_exprs, child.input, fetch=total)
                    return L.Limit(new_sort, node.skip, node.fetch)
            if isinstance(child, L.Projection) and not (
                    isinstance(child.input, L.Limit)
                    and child.input.fetch is not None
                    and child.input.fetch <= total):
                inner = L.Limit(child.input, 0, total)
                return L.Limit(L.Projection(child.exprs, inner),
                               node.skip, node.fetch)
            return node
        return plan.transform_up(fn)
