"""LogicalPlan / Expr -> SQL text (the unparser).

Reference parity: `datafusion/sql/src/unparser/{expr,plan}.rs` — turns a
logical plan back into executable SQL.  Strategy mirrors the reference's
builder: peel the canonical operator stack
(Limit > Sort > Distinct > Projection > [HAVING Filter] > Window >
Aggregate > [WHERE Filter] > relation) into one SELECT; anything that
breaks the pattern is wrapped as a derived table.  Round-trip contract:
``plan(sql(plan))`` is semantically equal (same result rows), which is how
the reference tests it (unparser round-trip suites).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..common import dt
from ..common.datatypes import TypeId
from ..common.errors import NotImplementedError_
from ..expr import (
    Aggregate, AggregateFunction, Alias, Between, BinaryExpr, Case, Cast,
    Column, CrossJoin, Distinct, EmptyRelation, Except, Exists, Expr, Filter,
    GroupingSet, InList, InSubquery, Intersect, IsBool, IsNull, Join, Like,
    Limit, Literal, LogicalPlan, Negative, Not, Projection, ScalarFunction,
    ScalarSubquery, SimilarTo, Sort, SortExpr, SubqueryAlias, TableScan,
    Union, Unnest, Values, Window, WindowFunction,
)

_IDENT_OK = set("abcdefghijklmnopqrstuvwxyz0123456789_")


def ident(name: str) -> str:
    if name and name[0].isalpha() and all(c in _IDENT_OK for c in name):
        return name
    return '"' + name.replace('"', '""') + '"'


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

def scalar_to_sql(v) -> str:
    if v.value is None:
        return "NULL"
    t = v.dtype
    if t.is_string:
        return "'" + str(v.value).replace("'", "''") + "'"
    if t.id == TypeId.BOOL:
        return "TRUE" if v.value else "FALSE"
    if t.id == TypeId.DATE:
        return f"DATE '{v.value.isoformat()}'"
    if t.id == TypeId.TIMESTAMP:
        return f"TIMESTAMP '{v.value.isoformat(sep=' ')}'"
    if t.id == TypeId.TIME:
        return f"TIME '{v.value.isoformat()}'"
    if t.id == TypeId.INTERVAL:
        months, days, us = v.value
        parts = []
        if months:
            parts.append(f"{months} months")
        if days:
            parts.append(f"{days} days")
        if us or not parts:
            parts.append(f"{us} microseconds")
        return f"INTERVAL '{' '.join(parts)}'"
    if t.id == TypeId.BINARY:
        return "X'" + bytes(v.value).hex() + "'"
    if t.id == TypeId.LIST:
        return "[" + ", ".join(
            scalar_to_sql(x) if hasattr(x, "dtype") else repr(x)
            for x in v.value) + "]"
    return str(v.value)


def type_to_sql(t) -> str:
    m = {TypeId.INT8: "TINYINT", TypeId.INT16: "SMALLINT",
         TypeId.INT32: "INT", TypeId.INT64: "BIGINT",
         TypeId.UINT64: "BIGINT UNSIGNED", TypeId.FLOAT32: "REAL",
         TypeId.FLOAT64: "DOUBLE", TypeId.BOOL: "BOOLEAN",
         TypeId.DATE: "DATE", TypeId.TIME: "TIME",
         TypeId.INTERVAL: "INTERVAL", TypeId.BINARY: "BYTEA",
         TypeId.NULL: "NULL"}
    if t.is_string:
        return "VARCHAR"
    if t.is_decimal:
        return f"DECIMAL({t.precision}, {t.scale})"
    if t.id == TypeId.TIMESTAMP:
        return "TIMESTAMP"
    if t.id in m:
        return m[t.id]
    raise NotImplementedError_(f"unparse type {t}")


def expr_to_sql(e: Expr) -> str:
    E = expr_to_sql
    from ..expr import OuterRef
    if isinstance(e, Column):
        return f"{ident(e.qualifier)}.{ident(e.name)}" if e.qualifier \
            else ident(e.name)
    if isinstance(e, OuterRef):
        return E(e.column)   # re-resolves as a correlated reference
    if isinstance(e, Literal):
        return scalar_to_sql(e.value)
    if isinstance(e, Alias):
        return f"{E(e.expr)} AS {ident(e.name)}"
    if isinstance(e, BinaryExpr):
        return f"({E(e.left)} {e.op.value} {E(e.right)})"
    if isinstance(e, Not):
        return f"(NOT {E(e.expr)})"
    if isinstance(e, Negative):
        return f"(- {E(e.expr)})"
    if isinstance(e, IsNull):
        return f"{E(e.expr)} IS {'NOT ' if e.negated else ''}NULL"
    if isinstance(e, IsBool):
        return f"{E(e.expr)} IS {'NOT ' if e.negated else ''}" \
               f"{'UNKNOWN' if e.value is None else ('TRUE' if e.value else 'FALSE')}"
    if isinstance(e, Case):
        s = "CASE"
        if e.operand is not None:
            s += f" {E(e.operand)}"
        for w, t in e.whens:
            s += f" WHEN {E(w)} THEN {E(t)}"
        if e.else_ is not None:
            s += f" ELSE {E(e.else_)}"
        return s + " END"
    if isinstance(e, Cast):
        pre = "TRY_CAST" if getattr(e, "safe", False) else "CAST"
        return f"{pre}({E(e.expr)} AS {type_to_sql(e.dtype)})"
    if isinstance(e, Like):
        op = ("NOT " if e.negated else "") + \
             ("ILIKE" if e.case_insensitive else "LIKE")
        s = f"{E(e.expr)} {op} {E(e.pattern)}"
        if e.escape:
            s += f" ESCAPE '{e.escape}'"
        return s
    if isinstance(e, SimilarTo):
        return f"{E(e.expr)} {'NOT ' if e.negated else ''}SIMILAR TO {E(e.pattern)}"
    if isinstance(e, InList):
        items = ", ".join(E(x) for x in e.items)
        return f"{E(e.expr)} {'NOT ' if e.negated else ''}IN ({items})"
    if isinstance(e, Between):
        return (f"{E(e.expr)} {'NOT ' if e.negated else ''}BETWEEN "
                f"{E(e.low)} AND {E(e.high)}")
    if isinstance(e, ScalarFunction):
        return f"{e.name}({', '.join(E(a) for a in e.args)})"
    if isinstance(e, AggregateFunction):
        inner = "*" if not e.args else ", ".join(E(a) for a in e.args)
        s = f"{e.name}({'DISTINCT ' if e.distinct else ''}{inner})"
        if e.order_by:
            s = s[:-1] + " ORDER BY " + \
                ", ".join(sort_to_sql(o) for o in e.order_by) + ")"
        if e.filter is not None:
            s += f" FILTER (WHERE {E(e.filter)})"
        return s
    if isinstance(e, WindowFunction):
        s = f"{e.name}({', '.join(E(a) for a in e.args)}) OVER ("
        parts = []
        if e.partition_by:
            parts.append("PARTITION BY " +
                         ", ".join(E(p) for p in e.partition_by))
        if e.order_by:
            parts.append("ORDER BY " +
                         ", ".join(sort_to_sql(o) for o in e.order_by))
        return s + " ".join(parts) + ")"
    if isinstance(e, Exists):
        return f"{'NOT ' if e.negated else ''}EXISTS ({plan_to_sql(e.subquery)})"
    if isinstance(e, InSubquery):
        return (f"{E(e.expr)} {'NOT ' if e.negated else ''}IN "
                f"({plan_to_sql(e.subquery)})")
    if isinstance(e, ScalarSubquery):
        return f"({plan_to_sql(e.subquery)})"
    if isinstance(e, GroupingSet):
        return "GROUPING SETS (" + ", ".join(
            "(" + ", ".join(E(x) for x in s) + ")" for s in e.sets) + ")"
    raise NotImplementedError_(f"unparse expr {type(e).__name__}: {e}")


def sort_to_sql(s: SortExpr) -> str:
    out = f"{expr_to_sql(s.expr)} {'ASC' if s.asc else 'DESC'}"
    if s.nulls_first:
        out += " NULLS FIRST"
    elif not s.asc:
        out += " NULLS LAST"
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self.n = 0

    def fresh(self) -> str:
        self.n += 1
        return f"__derived_{self.n}"


def plan_to_sql(plan: LogicalPlan) -> str:
    return _query(plan, _Counter())


def _query(plan: LogicalPlan, c: _Counter) -> str:
    # set operations first — they compose whole queries
    if isinstance(plan, Union):
        # the planner models UNION (distinct) as Distinct(Union)
        return " UNION ALL ".join(_query(i, c) for i in plan.inputs)
    if isinstance(plan, Intersect):
        return f"{_query(plan.left, c)} INTERSECT {_query(plan.right, c)}"
    if isinstance(plan, Except):
        return f"{_query(plan.left, c)} EXCEPT {_query(plan.right, c)}"

    fetch: Optional[int] = None
    skip = 0
    if isinstance(plan, Limit):
        fetch, skip = plan.fetch, plan.skip
        plan = plan.input

    order: List[SortExpr] = []
    if isinstance(plan, Sort):
        order = plan.sort_exprs
        if plan.fetch is not None and fetch is None:
            fetch = plan.fetch
        plan = plan.input

    distinct = False
    if isinstance(plan, Distinct) and not plan.on_exprs:
        distinct = True
        plan = plan.input

    sel: Optional[List[Expr]] = None
    if isinstance(plan, Projection):
        sel = plan.exprs
        plan = plan.input

    having: Optional[Expr] = None
    if isinstance(plan, Filter) and isinstance(plan.input, Aggregate):
        having = plan.predicate
        plan = plan.input

    if isinstance(plan, Window):
        # window exprs are referenced by display name from the projection;
        # substitute them back in
        wmap = {w.display_name(): w for w in plan.window_exprs}
        if sel is not None:
            sel = [_substitute(e, wmap) for e in sel]
        plan = plan.input

    group: List[Expr] = []
    if isinstance(plan, Aggregate):
        group = plan.group_exprs
        amap = {a.display_name(): a for a in plan.aggr_exprs}
        for g in plan.output_group_exprs():
            amap.setdefault(g.display_name(), g)
        if sel is None:
            sel = plan.output_group_exprs() + plan.aggr_exprs
        else:
            sel = [_substitute(e, amap) for e in sel]
        if having is not None:
            having = _substitute(having, amap)
        plan = plan.input

    where: List[Expr] = []
    while isinstance(plan, Filter):
        where.insert(0, plan.predicate)
        plan = plan.input

    from_sql = _relation(plan, c)

    if sel is None:
        sel_sql = "*"
    else:
        sel_sql = ", ".join(expr_to_sql(e) for e in sel)
    s = "SELECT " + ("DISTINCT " if distinct else "") + sel_sql
    if from_sql:
        s += f" FROM {from_sql}"
    if where:
        s += " WHERE " + " AND ".join(expr_to_sql(w) for w in where)
    if group:
        s += " GROUP BY " + ", ".join(expr_to_sql(g) for g in group)
    if having is not None:
        s += f" HAVING {expr_to_sql(having)}"
    if order:
        s += " ORDER BY " + ", ".join(sort_to_sql(o) for o in order)
    if fetch is not None:
        s += f" LIMIT {fetch}"
    if skip:
        s += f" OFFSET {skip}"
    return s


def _substitute(e: Expr, mapping: dict) -> Expr:
    """Replace Column refs to aggregate/window outputs with the defining
    expression (post-aggregate projections reference them by display name)."""
    def rw(node: Expr):
        if isinstance(node, Column) and node.qualifier is None \
                and node.name in mapping:
            return mapping[node.name]
        return None
    return e.transform_up(rw)


def _relation(plan: LogicalPlan, c: _Counter) -> str:
    if isinstance(plan, TableScan):
        if plan.filters or plan.fetch is not None:
            inner = "SELECT * FROM " + ident(plan.name)
            if plan.filters:
                inner += " WHERE " + " AND ".join(
                    expr_to_sql(f) for f in plan.filters)
            if plan.fetch is not None:
                inner += f" LIMIT {plan.fetch}"
            return f"({inner}) AS {ident(plan.name)}"
        return ident(plan.name)
    if isinstance(plan, SubqueryAlias):
        return f"({_query(plan.input, c)}) AS {ident(plan.alias)}"
    if isinstance(plan, Join):
        jt = {"INNER": "JOIN", "LEFT": "LEFT JOIN", "RIGHT": "RIGHT JOIN",
              "FULL": "FULL JOIN", "LEFTSEMI": None, "RIGHTSEMI": None,
              "LEFTANTI": None, "RIGHTANTI": None}[plan.join_type]
        if jt is None:
            raise NotImplementedError_(
                f"unparse {plan.join_type} join (no SQL surface form)")
        conds = [f"{expr_to_sql(l)} = {expr_to_sql(r)}" for l, r in plan.on]
        if plan.filter is not None:
            conds.append(expr_to_sql(plan.filter))
        on = " AND ".join(conds) if conds else "TRUE"
        return f"{_relation(plan.left, c)} {jt} {_relation(plan.right, c)} ON {on}"
    if isinstance(plan, CrossJoin):
        return f"{_relation(plan.left, c)} CROSS JOIN {_relation(plan.right, c)}"
    if isinstance(plan, Values):
        rows = ", ".join(
            "(" + ", ".join(expr_to_sql(e) for e in row) + ")"
            for row in plan.rows)
        alias = c.fresh()
        cols = ", ".join(ident(f.name) for f in plan.schema.fields)
        return f"(VALUES {rows}) AS {ident(alias)}({cols})"
    if isinstance(plan, EmptyRelation):
        return ""   # SELECT without FROM
    if isinstance(plan, Unnest) or \
            (isinstance(plan, Distinct) and plan.on_exprs):
        # Unnest / DISTINCT ON have no direct table-factor form here
        raise NotImplementedError_(
            f"unparse {type(plan).__name__} as a relation")
    # generic: wrap as derived table
    return f"({_query(plan, c)}) AS {ident(c.fresh())}"
