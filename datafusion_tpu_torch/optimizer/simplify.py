"""SimplifyExpressions — constant folding and boolean simplification.

Reference parity: `datafusion/optimizer/src/simplify_expressions/`
(ExprSimplifier). Evaluates literal-only subtrees via the physical kernels
on one-row batches (the reference uses the same trick: const evaluator over
a placeholder batch).
"""
from __future__ import annotations

import numpy as np

from ..common import dt
from ..common.scalar import ScalarValue
from ..expr import expr as E
from ..expr.operator import Op


def _is_lit(e) -> bool:
    return isinstance(e, E.Literal)


def _lit_bool(e):
    if isinstance(e, E.Literal) and e.value.dtype.is_boolean:
        return e.value.value
    return "not a literal"


def _try_const_fold(e: E.Expr):
    """Evaluate an expression with no column references to a Literal."""
    if e.contains(lambda n: isinstance(n, (E.Column, E.OuterRef, E.ScalarSubquery,
                                           E.Exists, E.InSubquery, E.Placeholder))):
        return None
    if isinstance(e, E.Literal):
        return None
    # volatile functions must not fold
    if e.contains(lambda n: isinstance(n, E.ScalarFunction) and
                  n.name in ("random", "uuid", "now", "current_date", "today")):
        return None
    try:
        from ..physical.expressions import compile_expr
        from ..physical.plan.scan import _placeholder_batch
        from ..common.schema import Schema
        pe = compile_expr(e, Schema.empty())
        batch = _placeholder_batch()
        col = pe.evaluate(batch)
        vals = col.to_pylist(1)
        v = vals[0]
        d = col.dtype
        if d.id.value == "timestamp" and v is not None:
            v = int(col.data_host()[0])
        if d.id.value == "interval" and v is not None:
            if (d.unit or "").startswith("rawdur"):
                v = int(col.data_host()[0])   # raw-ns Duration
            else:
                # ScalarValue interval payload is (months, days, nanos)
                from ..functions.datetime_helpers import unpack_interval_np
                m, days, nanos = unpack_interval_np(col.data_host()[:1])
                v = (int(m[0]), int(days[0]), int(nanos[0]))
            # Duration results (dur_*) must keep their display unit
            d = col.dtype
        if d.id.value == "time" and v is not None:
            v = int(col.data_host()[0])
        if d.id.value == "date" and v is not None and isinstance(v, str):
            # beyond datetime.date's range: keep the raw day count
            v = int(col.data_host()[0])
        return E.Literal(ScalarValue(d, v))
    except Exception:  # noqa: BLE001 — leave unfoldable exprs alone
        return None


def simplify_expr(e: E.Expr) -> E.Expr:
    def rewrite(node: E.Expr) -> E.Expr:
        if isinstance(node, (E.Alias, E.SortExpr)):
            return node   # never fold away output names / sort wrappers
        if isinstance(node, E.BinaryExpr):
            lb, rb = _lit_bool(node.left), _lit_bool(node.right)
            if node.op == Op.AND:
                if lb is True:
                    return node.right
                if rb is True:
                    return node.left
                if lb is False or rb is False:
                    return E.Literal(ScalarValue.boolean(False))
            elif node.op == Op.OR:
                if lb is False:
                    return node.right
                if rb is False:
                    return node.left
                if lb is True or rb is True:
                    return E.Literal(ScalarValue.boolean(True))
        if isinstance(node, E.Not):
            b = _lit_bool(node.expr)
            if b is True:
                return E.Literal(ScalarValue.boolean(False))
            if b is False:
                return E.Literal(ScalarValue.boolean(True))
            if isinstance(node.expr, E.Not):
                return node.expr.expr
        folded = _try_const_fold(node)
        if folded is not None:
            return folded
        return node
    return e.transform_up(rewrite)


def _split_disjunction(e: E.Expr):
    if isinstance(e, E.BinaryExpr) and e.op == Op.OR:
        return _split_disjunction(e.left) + _split_disjunction(e.right)
    return [e]


def factor_common_disjuncts(e: E.Expr) -> E.Expr:
    """(A AND X) OR (A AND Y) -> A AND (X OR Y).

    Reference parity: RewriteDisjunctivePredicate
    (`optimizer/src/rewrite_disjunctive_predicate.rs`). Critical for
    TPC-H Q19, where the join key equality is repeated in every OR branch
    — factoring exposes it to equijoin extraction.
    """
    from .predicate_utils import conjunction, split_conjunction

    def rw(node: E.Expr) -> E.Expr:
        branches = _split_disjunction(node)
        if len(branches) < 2:
            return node
        conj_sets = [split_conjunction(b) for b in branches]
        first_keys = {str(c): c for c in conj_sets[0]}
        common_keys = set(first_keys)
        for cs in conj_sets[1:]:
            common_keys &= {str(c) for c in cs}
        if not common_keys:
            return node
        common = [c for k, c in first_keys.items() if k in common_keys]
        rests = []
        for cs in conj_sets:
            rest = [c for c in cs if str(c) not in common_keys]
            rests.append(conjunction(rest))
        if any(r is None for r in rests):
            # one branch is exactly the common part: OR collapses to common
            return conjunction(common)
        disj = rests[0]
        for r in rests[1:]:
            disj = E.BinaryExpr(disj, Op.OR, r)
        return conjunction(common + [disj])

    return e.transform_up(rw)


class RewriteDisjunctivePredicate:
    name = "rewrite_disjunctive_predicate"

    def rewrite(self, plan):
        from ..expr import plan as L

        def f(node):
            if isinstance(node, L.Filter):
                new = factor_common_disjuncts(node.predicate)
                if new is not node.predicate:
                    return L.Filter(new, node.input)
            if isinstance(node, L.Join) and node.filter is not None:
                new = factor_common_disjuncts(node.filter)
                if new is not node.filter:
                    return L.Join(node.left, node.right, node.on, new,
                                  node.join_type, node.using_columns)
            return node
        return plan.transform_up(f)


class SimplifyExpressions:
    name = "simplify_expressions"

    def rewrite(self, plan):
        from ..expr import plan as L

        def f(node):
            exprs = node.expressions()
            if not exprs:
                return node
            new = [simplify_expr(x) for x in exprs]
            if all(a is b for a, b in zip(new, exprs)):
                return node
            if isinstance(node, (L.Projection, L.Aggregate, L.Window)):
                # folding must not change output field names: the reference
                # names fields from the PRE-optimization expression text
                # (e.g. "count(Int64(1) + Int64(1))" even after folding to
                # count(2)) — alias the rewrite to the original display name
                new = [nw if nw is old or isinstance(old, E.Alias)
                       or nw.display_name() == old.display_name()
                       else E.Alias(nw, old.display_name())
                       for old, nw in zip(exprs, new)]
            try:
                return node.with_expressions(new)
            except (AssertionError, NotImplementedError):
                return node   # node doesn't support expression rewriting
        return plan.transform_up(f)
