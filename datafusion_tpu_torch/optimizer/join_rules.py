"""Join-shaping rules.

Reference parity:
* ExtractEquijoinPredicate (`optimizer/src/extract_equijoin_predicate.rs`)
  — pull `left_col = right_col` conjuncts out of a join filter into `on`.
* EliminateCrossJoin (`optimizer/src/eliminate_cross_join.rs`) — Filter over
  CrossJoin becomes an inner Join whose filter is the predicate (equijoin
  extraction then finds the keys).
* EliminateOuterJoin (`optimizer/src/eliminate_outer_join.rs`) — an outer
  join under a null-rejecting filter degrades to inner.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..expr import expr as E
from ..expr import plan as L
from ..expr.operator import Op
from .predicate_utils import (columns_in_schema, conjunction, expr_columns,
                              split_conjunction)


def _classify(e: E.Expr, lschema, rschema) -> str:
    cols = expr_columns(e)
    if not cols:
        return "either"
    in_l = columns_in_schema(cols, lschema)
    in_r = columns_in_schema(cols, rschema)
    if in_l and not in_r:
        return "left"
    if in_r and not in_l:
        return "right"
    if in_l and in_r:
        # ambiguous names resolve to left by Schema.index_of; treat as left
        return "left"
    return "both"


class ExtractEquijoinPredicate:
    name = "extract_equijoin_predicate"

    def rewrite(self, plan):
        def f(node):
            if not isinstance(node, L.Join) or node.filter is None:
                return node
            lschema, rschema = node.left.schema, node.right.schema
            on = list(node.on)
            rest: List[E.Expr] = []
            for c in split_conjunction(node.filter):
                pair = self._as_equi(c, lschema, rschema)
                if pair is not None:
                    on.append(pair)
                else:
                    rest.append(c)
            if len(on) == len(node.on):
                return node
            return L.Join(node.left, node.right, on, conjunction(rest),
                          node.join_type, node.using_columns)
        return plan.transform_up(f)

    @staticmethod
    def _as_equi(c: E.Expr, lschema, rschema) -> Optional[Tuple[E.Expr, E.Expr]]:
        if not (isinstance(c, E.BinaryExpr) and c.op == Op.EQ):
            return None
        a, b = c.left, c.right
        sa = _classify(a, lschema, rschema)
        sb = _classify(b, lschema, rschema)
        if sa == "left" and sb == "right":
            return (a, b)
        if sa == "right" and sb == "left":
            return (b, a)
        return None


class EliminateCrossJoin:
    """Flatten a Filter over a tree of CrossJoins/inner Joins into a
    connectivity-driven left-deep join tree (reference:
    eliminate_cross_join.rs — flatten_join_inputs + rebuild by extractable
    equi predicates; join-order-by-statistics is a later physical concern)."""

    name = "eliminate_cross_join"

    def rewrite(self, plan):
        def f(node):
            if not (isinstance(node, L.Filter) and
                    isinstance(node.input, (L.CrossJoin, L.Join))):
                return node
            flat = _flatten_inner_tree(node.input)
            if flat is None:
                return node
            inputs, conjuncts = flat
            if len(inputs) < 2:
                return node
            conjuncts = conjuncts + split_conjunction(node.predicate)
            return _build_join_tree(inputs, conjuncts)
        return plan.transform_up(f)


def _flatten_inner_tree(node):
    """Collect the leaf relations and join conjuncts of a CrossJoin /
    inner-Join tree. Returns None when there is nothing to rebuild (no
    CrossJoin anywhere)."""
    has_cross = [False]

    def walk(n):
        if isinstance(n, L.CrossJoin):
            has_cross[0] = True
            li, lc = walk(n.left)
            ri, rc = walk(n.right)
            return li + ri, lc + rc
        if isinstance(n, L.Join) and n.join_type == "INNER":
            li, lc = walk(n.left)
            ri, rc = walk(n.right)
            conj = lc + rc
            for l, r in n.on:
                conj.append(E.BinaryExpr(l, Op.EQ, r))
            if n.filter is not None:
                conj.extend(split_conjunction(n.filter))
            return li + ri, conj
        return [n], []

    inputs, conjuncts = walk(node)
    if not has_cross[0]:
        return None
    return inputs, conjuncts


def _refs_schema(e: E.Expr, schema) -> bool:
    return any(schema.maybe_index_of(c.name, c.qualifier) is not None
               for c in expr_columns(e))


def _column_ndv(plan, col: E.Column):
    """Distinct-count of a column, traced to its TableScan; damped by the
    plan's row estimate (post-filter ndv can't exceed rows)."""
    from ..physical.planner import _estimate_rows
    node = plan
    while True:
        if isinstance(node, L.TableScan):
            idx = node.schema.maybe_index_of(col.name, col.qualifier)
            if idx is None:
                return None
            base_idx = idx if node.projection is None else node.projection[idx]
            try:
                ndv = node.source.column_ndv(base_idx)
            except Exception:  # noqa: BLE001
                return None
            if ndv is None:
                return None
            rows = _estimate_rows(plan)
            return min(ndv, rows) if rows is not None else ndv
        if isinstance(node, (L.Filter, L.SubqueryAlias, L.Sort, L.Limit)):
            node = node.inputs[0]
            continue
        if isinstance(node, L.Projection):
            # follow plain column projections only
            idx = node.schema.maybe_index_of(col.name, col.qualifier)
            if idx is None:
                return None
            e = node.exprs[idx]
            e = e.expr if isinstance(e, E.Alias) else e
            if not isinstance(e, E.Column):
                return None
            col = e
            node = node.input
            continue
        if isinstance(node, (L.Join, L.CrossJoin)):
            for inp in node.inputs:
                if inp.schema.maybe_index_of(col.name, col.qualifier) is not None:
                    return _column_ndv(inp, col)
            return None
        return None


def _join_output_estimate(tree, tree_est, cand, cand_est, equis):
    """|T join C| ~= |T|*|C| / max(ndv over the equi keys) — the classic
    Selinger containment estimate."""
    best_ndv = 1.0
    for c in equis:
        a, b = c.left, c.right
        for side in (a, b):
            if isinstance(side, E.Column):
                src = tree if tree.schema.maybe_index_of(
                    side.name, side.qualifier) is not None else cand
                ndv = _column_ndv(src, side)
                if ndv:
                    best_ndv = max(best_ndv, float(ndv))
    return tree_est * cand_est / best_ndv


def _build_join_tree(inputs, conjuncts):
    """Greedy join ordering by estimated join-output size (Selinger-style
    containment estimate over column distinct counts); predicates not
    usable as join conditions stay in a Filter on top (PushDownFilter
    distributes them). The reference delegates this to JoinSelection +
    Statistics; low-cardinality-key edges between large tables (the Q5/Q7
    nationkey trap) are exactly what the ndv term avoids."""
    from ..physical.planner import _estimate_rows
    remaining = list(inputs)
    tree = remaining.pop(0)   # query order anchors the tree
    tree_est = _estimate_rows(tree) or 1e6
    unused = list(conjuncts)

    while remaining:
        candidates = []   # (est_out, idx, joinable conjuncts)
        for idx, cand in enumerate(remaining):
            joinable = []
            for c in unused:
                cols = expr_columns(c)
                if not cols:
                    continue
                in_tree = any(_refs_schema(E.Column(col.name, col.qualifier),
                                           tree.schema) for col in cols)
                in_cand = any(_refs_schema(E.Column(col.name, col.qualifier),
                                           cand.schema) for col in cols)
                covered = all(
                    tree.schema.maybe_index_of(col.name, col.qualifier) is not None
                    or cand.schema.maybe_index_of(col.name, col.qualifier) is not None
                    for col in cols)
                if in_tree and in_cand and covered:
                    joinable.append(c)
            equis = [c for c in joinable
                     if isinstance(c, E.BinaryExpr) and c.op == Op.EQ]
            if equis:
                cand_est = _estimate_rows(cand) or 1e6
                est_out = _join_output_estimate(tree, tree_est, cand,
                                                cand_est, equis)
                candidates.append((est_out, idx, joinable))
        if not candidates:
            est = [(_estimate_rows(i) or float("inf")) for i in remaining]
            k = int(min(range(len(remaining)), key=lambda i: est[i]))
            cand = remaining.pop(k)
            tree_est = tree_est * (_estimate_rows(cand) or 1e6)
            tree = L.CrossJoin(tree, cand)
            continue
        candidates.sort(key=lambda t: t[0])
        est_out, best_idx, best_conj = candidates[0]
        cand = remaining.pop(best_idx)
        for c in best_conj:
            unused.remove(c)
        tree = L.Join(tree, cand, [], conjunction(best_conj), "INNER")
        tree_est = max(est_out, 1.0)

    pred = conjunction(unused)
    return L.Filter(pred, tree) if pred is not None else tree


def _strict_columns(e: E.Expr) -> List[E.Column]:
    """Columns through which NULL strictly propagates to `e`'s value —
    i.e. NOT columns under null-tolerant constructs (CASE, COALESCE,
    IS [NOT] NULL, ...) whose result can be non-NULL for a NULL input."""
    tolerant_fns = {"coalesce", "ifnull", "nvl", "nvl2", "isnull",
                    "nullif", "arrow_typeof"}
    out: List[E.Column] = []

    def walk(n):
        if isinstance(n, (E.Case, E.IsNull, E.IsBool)):
            return
        if isinstance(n, E.ScalarFunction) and n.name in tolerant_fns:
            return
        if isinstance(n, E.Column):
            out.append(n)
            return
        for c in n.children():
            walk(c)
    walk(e)
    return out


def _null_rejecting_cols(pred: E.Expr) -> List[E.Column]:
    """Columns that, when NULL, make the predicate not-TRUE (conservative:
    comparisons and arithmetic propagate NULL — but not through CASE /
    COALESCE / IS NULL, which absorb NULLs)."""
    out: List[E.Column] = []
    for c in split_conjunction(pred):
        if isinstance(c, E.BinaryExpr) and (c.op.is_comparison if hasattr(c.op, "is_comparison") else False):
            out.extend(_strict_columns(c))
        elif isinstance(c, E.BinaryExpr) and c.op in (
                Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
            out.extend(_strict_columns(c))
        elif isinstance(c, (E.Like, E.Between, E.InList)) and not getattr(c, "negated", False):
            out.extend(_strict_columns(c))
        elif isinstance(c, E.IsNull) and c.negated:
            out.extend(_strict_columns(c.expr))
    return out


class EliminateOuterJoin:
    name = "eliminate_outer_join"

    def rewrite(self, plan):
        def f(node):
            if not (isinstance(node, L.Filter) and isinstance(node.input, L.Join)):
                return node
            j = node.input
            if j.join_type not in ("LEFT", "RIGHT", "FULL"):
                return node
            nr = _null_rejecting_cols(node.predicate)
            rej_left = any(j.left.schema.maybe_index_of(c.name, c.qualifier) is not None
                           for c in nr)
            rej_right = any(j.right.schema.maybe_index_of(c.name, c.qualifier) is not None
                            for c in nr)
            jt = j.join_type
            if jt == "LEFT" and rej_right:
                jt = "INNER"
            elif jt == "RIGHT" and rej_left:
                jt = "INNER"
            elif jt == "FULL" and rej_left and rej_right:
                jt = "INNER"
            elif jt == "FULL" and rej_left:
                # rejecting NULL left columns discards right-unmatched rows
                jt = "LEFT"
            elif jt == "FULL" and rej_right:
                jt = "RIGHT"
            if jt == j.join_type:
                return node
            return L.Filter(node.predicate,
                            L.Join(j.left, j.right, j.on, j.filter, jt,
                                   j.using_columns))
        return plan.transform_up(f)
