"""Shared predicate helpers: conjunction splitting, column collection,
side classification for join pushdown."""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ..common.schema import Schema
from ..expr import expr as E
from ..expr.operator import Op


def split_conjunction(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.BinaryExpr) and e.op == Op.AND:
        return split_conjunction(e.left) + split_conjunction(e.right)
    return [e]


def conjunction(parts: List[E.Expr]) -> Optional[E.Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = E.BinaryExpr(out, Op.AND, p)
    return out


def expr_columns(e: E.Expr) -> List[E.Column]:
    out: List[E.Column] = []

    def walk(node):
        if isinstance(node, E.Column):
            out.append(node)
        # do not descend into subquery plans
        for c in node.children():
            walk(c)
    walk(e)
    return out


def columns_in_schema(cols: List[E.Column], schema: Schema) -> bool:
    for c in cols:
        if schema.maybe_index_of(c.name, c.qualifier) is None:
            return False
    return True


def has_volatile(e: E.Expr) -> bool:
    return e.contains(lambda n: isinstance(n, E.ScalarFunction) and
                      n.name in ("random", "uuid"))


def has_subquery(e: E.Expr) -> bool:
    return e.contains(lambda n: isinstance(
        n, (E.ScalarSubquery, E.Exists, E.InSubquery)))
