"""LogicalPlan / Expr <-> JSON-able dicts.

Table sources serialize by *name*; deserialization resolves them against a
SessionContext (the reference does the same: TableScan nodes carry the
table name, the consumer resolves providers —
`proto/src/logical_plan/mod.rs`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from ..common import dt
from ..common.datatypes import DataType, TypeId
from ..common.errors import PlanError
from ..common.scalar import ScalarValue
from ..expr import expr as E
from ..expr import plan as L
from ..expr.operator import Op


# --------------------------------------------------------------------------
# types & scalars
# --------------------------------------------------------------------------

def dtype_to_dict(t: DataType) -> Dict[str, Any]:
    d = {"id": t.id.value}
    if t.id == TypeId.DECIMAL:
        d["precision"] = t.precision
        d["scale"] = t.scale
    if t.id == TypeId.TIMESTAMP:
        d["unit"] = t.unit
    if t.inner is not None:
        d["inner"] = dtype_to_dict(t.inner)
    return d


def dtype_from_dict(d: Dict[str, Any]) -> DataType:
    tid = TypeId(d["id"])
    if tid == TypeId.DECIMAL:
        return dt.decimal(d["precision"], d["scale"])
    if tid == TypeId.TIMESTAMP:
        return dt.timestamp(d.get("unit", "us"))
    if tid == TypeId.LIST:
        return dt.list_(dtype_from_dict(d["inner"]))
    return DataType(tid)


def scalar_to_dict(sv: ScalarValue) -> Dict[str, Any]:
    v = sv.value
    if v is not None:
        import datetime
        from decimal import Decimal
        if isinstance(v, Decimal):
            v = str(v)
        elif isinstance(v, datetime.datetime):
            v = {"$dt": v.isoformat()}
        elif isinstance(v, datetime.date):
            v = {"$d": v.isoformat()}
        elif isinstance(v, tuple):
            v = {"$tuple": list(v)}
        elif hasattr(v, "item"):
            v = v.item()
    return {"type": dtype_to_dict(sv.dtype), "value": v}


def scalar_from_dict(d: Dict[str, Any]) -> ScalarValue:
    t = dtype_from_dict(d["type"])
    v = d["value"]
    if isinstance(v, dict):
        import datetime
        if "$d" in v:
            v = datetime.date.fromisoformat(v["$d"])
        elif "$dt" in v:
            v = datetime.datetime.fromisoformat(v["$dt"])
        elif "$tuple" in v:
            v = tuple(v["$tuple"])
    elif t.is_decimal and isinstance(v, str):
        from decimal import Decimal
        v = Decimal(v)
    return ScalarValue(t, v)


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------

def expr_to_dict(e: E.Expr) -> Dict[str, Any]:
    if isinstance(e, E.Column):
        return {"node": "column", "name": e.name, "qualifier": e.qualifier}
    if isinstance(e, E.OuterRef):
        return {"node": "outer_ref", "column": expr_to_dict(e.column),
                "type": dtype_to_dict(e.dtype)}
    if isinstance(e, E.Literal):
        return {"node": "literal", "value": scalar_to_dict(e.value)}
    if isinstance(e, E.Alias):
        return {"node": "alias", "expr": expr_to_dict(e.expr), "name": e.name}
    if isinstance(e, E.BinaryExpr):
        return {"node": "binary", "op": e.op.name,
                "left": expr_to_dict(e.left), "right": expr_to_dict(e.right)}
    if isinstance(e, E.Not):
        return {"node": "not", "expr": expr_to_dict(e.expr)}
    if isinstance(e, E.Negative):
        return {"node": "negative", "expr": expr_to_dict(e.expr)}
    if isinstance(e, E.IsNull):
        return {"node": "is_null", "expr": expr_to_dict(e.expr),
                "negated": e.negated}
    if isinstance(e, E.IsBool):
        return {"node": "is_bool", "expr": expr_to_dict(e.expr),
                "value": e.value, "negated": e.negated}
    if isinstance(e, E.Cast):
        return {"node": "cast", "expr": expr_to_dict(e.expr),
                "to": dtype_to_dict(e.dtype), "safe": e.safe}
    if isinstance(e, E.Case):
        return {"node": "case",
                "operand": expr_to_dict(e.operand) if e.operand else None,
                "whens": [[expr_to_dict(w), expr_to_dict(t)]
                          for w, t in e.whens],
                "else": expr_to_dict(e.else_) if e.else_ is not None else None}
    if isinstance(e, E.Like):
        return {"node": "like", "expr": expr_to_dict(e.expr),
                "pattern": expr_to_dict(e.pattern), "negated": e.negated,
                "ci": e.case_insensitive, "escape": e.escape}
    if isinstance(e, E.InList):
        return {"node": "in_list", "expr": expr_to_dict(e.expr),
                "items": [expr_to_dict(i) for i in e.items],
                "negated": e.negated}
    if isinstance(e, E.Between):
        return {"node": "between", "expr": expr_to_dict(e.expr),
                "low": expr_to_dict(e.low), "high": expr_to_dict(e.high),
                "negated": e.negated}
    if isinstance(e, E.ScalarFunction):
        return {"node": "scalar_fn", "name": e.name,
                "args": [expr_to_dict(a) for a in e.args]}
    if isinstance(e, E.AggregateFunction):
        return {"node": "agg_fn", "name": e.name,
                "args": [expr_to_dict(a) for a in e.args],
                "distinct": e.distinct,
                "filter": expr_to_dict(e.filter) if e.filter is not None else None,
                "order_by": [sort_to_dict(s) for s in e.order_by]}
    if isinstance(e, E.WindowFunction):
        return {"node": "window_fn", "name": e.name,
                "args": [expr_to_dict(a) for a in e.args],
                "partition_by": [expr_to_dict(p) for p in e.partition_by],
                "order_by": [sort_to_dict(s) for s in e.order_by],
                "frame": {"units": e.frame.units,
                          "start": _bound_to_dict(e.frame.start),
                          "end": _bound_to_dict(e.frame.end)}}
    if isinstance(e, E.GroupingSet):
        return {"node": "grouping_set",
                "sets": [[expr_to_dict(x) for x in s] for s in e.sets]}
    raise PlanError(f"cannot serialize expression {type(e).__name__}")


def sort_to_dict(s: E.SortExpr) -> Dict[str, Any]:
    return {"expr": expr_to_dict(s.expr), "asc": s.asc,
            "nulls_first": s.nulls_first}


def sort_from_dict(d) -> E.SortExpr:
    return E.SortExpr(expr_from_dict(d["expr"]), d["asc"], d["nulls_first"])


def _bound_to_dict(b: E.WindowFrameBound):
    return {"kind": b.kind,
            "offset": scalar_to_dict(b.offset) if b.offset is not None else None}


def _bound_from_dict(d) -> E.WindowFrameBound:
    return E.WindowFrameBound(
        d["kind"], scalar_from_dict(d["offset"]) if d["offset"] else None)


def expr_from_dict(d: Dict[str, Any]) -> E.Expr:
    n = d["node"]
    if n == "column":
        return E.Column(d["name"], d.get("qualifier"))
    if n == "outer_ref":
        return E.OuterRef(expr_from_dict(d["column"]), dtype_from_dict(d["type"]))
    if n == "literal":
        return E.Literal(scalar_from_dict(d["value"]))
    if n == "alias":
        return E.Alias(expr_from_dict(d["expr"]), d["name"])
    if n == "binary":
        return E.BinaryExpr(expr_from_dict(d["left"]), Op[d["op"]],
                            expr_from_dict(d["right"]))
    if n == "not":
        return E.Not(expr_from_dict(d["expr"]))
    if n == "negative":
        return E.Negative(expr_from_dict(d["expr"]))
    if n == "is_null":
        return E.IsNull(expr_from_dict(d["expr"]), d["negated"])
    if n == "is_bool":
        return E.IsBool(expr_from_dict(d["expr"]), d["value"], d["negated"])
    if n == "cast":
        return E.Cast(expr_from_dict(d["expr"]), dtype_from_dict(d["to"]),
                      d["safe"])
    if n == "case":
        return E.Case(
            expr_from_dict(d["operand"]) if d["operand"] else None,
            tuple((expr_from_dict(w), expr_from_dict(t))
                  for w, t in d["whens"]),
            expr_from_dict(d["else"]) if d["else"] else None)
    if n == "like":
        return E.Like(expr_from_dict(d["expr"]), expr_from_dict(d["pattern"]),
                      d["negated"], d["ci"], d["escape"])
    if n == "in_list":
        return E.InList(expr_from_dict(d["expr"]),
                        tuple(expr_from_dict(i) for i in d["items"]),
                        d["negated"])
    if n == "between":
        return E.Between(expr_from_dict(d["expr"]), expr_from_dict(d["low"]),
                         expr_from_dict(d["high"]), d["negated"])
    if n == "scalar_fn":
        return E.ScalarFunction(d["name"],
                                tuple(expr_from_dict(a) for a in d["args"]))
    if n == "agg_fn":
        return E.AggregateFunction(
            d["name"], tuple(expr_from_dict(a) for a in d["args"]),
            d["distinct"],
            expr_from_dict(d["filter"]) if d["filter"] else None,
            tuple(sort_from_dict(s) for s in d["order_by"]))
    if n == "window_fn":
        return E.WindowFunction(
            d["name"], tuple(expr_from_dict(a) for a in d["args"]),
            tuple(expr_from_dict(p) for p in d["partition_by"]),
            tuple(sort_from_dict(s) for s in d["order_by"]),
            E.WindowFrame(d["frame"]["units"],
                          _bound_from_dict(d["frame"]["start"]),
                          _bound_from_dict(d["frame"]["end"])))
    if n == "grouping_set":
        return E.GroupingSet(tuple(tuple(expr_from_dict(x) for x in s)
                                   for s in d["sets"]))
    raise PlanError(f"cannot deserialize expression node '{n}'")


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

def plan_to_dict(p: L.LogicalPlan) -> Dict[str, Any]:
    if isinstance(p, L.TableScan):
        return {"node": "table_scan", "name": p.name,
                "projection": p.projection,
                "filters": [expr_to_dict(f) for f in p.filters],
                "fetch": p.fetch}
    if isinstance(p, L.EmptyRelation):
        from ..common.schema import Field
        return {"node": "empty", "one_row": p.produce_one_row,
                "schema": [[f.name, dtype_to_dict(f.dtype), f.nullable]
                           for f in p.schema.fields]}
    if isinstance(p, L.Projection):
        return {"node": "projection",
                "exprs": [expr_to_dict(e) for e in p.exprs],
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.Filter):
        return {"node": "filter", "predicate": expr_to_dict(p.predicate),
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.Aggregate):
        return {"node": "aggregate",
                "group": [expr_to_dict(e) for e in p.group_exprs],
                "aggr": [expr_to_dict(e) for e in p.aggr_exprs],
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.Sort):
        return {"node": "sort",
                "exprs": [sort_to_dict(s) for s in p.sort_exprs],
                "fetch": p.fetch, "input": plan_to_dict(p.input)}
    if isinstance(p, L.Join):
        return {"node": "join", "join_type": p.join_type,
                "on": [[expr_to_dict(l), expr_to_dict(r)] for l, r in p.on],
                "filter": expr_to_dict(p.filter) if p.filter is not None else None,
                "left": plan_to_dict(p.left), "right": plan_to_dict(p.right)}
    if isinstance(p, L.CrossJoin):
        return {"node": "cross_join", "left": plan_to_dict(p.left),
                "right": plan_to_dict(p.right)}
    if isinstance(p, L.Limit):
        return {"node": "limit", "skip": p.skip, "fetch": p.fetch,
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.Union):
        return {"node": "union",
                "inputs": [plan_to_dict(i) for i in p.inputs]}
    if isinstance(p, L.Intersect):
        return {"node": "intersect", "all": p.all,
                "left": plan_to_dict(p.left), "right": plan_to_dict(p.right)}
    if isinstance(p, L.Except):
        return {"node": "except", "all": p.all,
                "left": plan_to_dict(p.left), "right": plan_to_dict(p.right)}
    if isinstance(p, L.Distinct):
        return {"node": "distinct", "input": plan_to_dict(p.input),
                "on": [expr_to_dict(e) for e in p.on_exprs] if p.on_exprs else None,
                "select": [expr_to_dict(e) for e in p.select_exprs]
                if p.select_exprs else None,
                "sort": [sort_to_dict(s) for s in p.sort_exprs]
                if p.sort_exprs else None}
    if isinstance(p, L.Window):
        return {"node": "window",
                "exprs": [expr_to_dict(e) for e in p.window_exprs],
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.SubqueryAlias):
        return {"node": "subquery_alias", "alias": p.alias,
                "input": plan_to_dict(p.input)}
    if isinstance(p, L.Values):
        return {"node": "values",
                "rows": [[expr_to_dict(e) for e in row] for row in p.rows],
                "schema": [[f.name, dtype_to_dict(f.dtype), f.nullable]
                           for f in p.schema.fields]}
    raise PlanError(f"cannot serialize plan node {type(p).__name__}")


def plan_from_dict(d: Dict[str, Any], ctx) -> L.LogicalPlan:
    """`ctx` resolves table names (SessionContext or anything with
    get_table)."""
    from ..common.schema import Field, Schema
    n = d["node"]
    if n == "table_scan":
        source = ctx.get_table(d["name"])
        return L.TableScan(d["name"], source, d.get("projection"),
                           tuple(expr_from_dict(f) for f in d.get("filters", [])),
                           d.get("fetch"))
    if n == "empty":
        schema = Schema([Field(nm, dtype_from_dict(t), nl)
                         for nm, t, nl in d["schema"]])
        return L.EmptyRelation(d["one_row"], schema)
    if n == "projection":
        return L.Projection([expr_from_dict(e) for e in d["exprs"]],
                            plan_from_dict(d["input"], ctx))
    if n == "filter":
        return L.Filter(expr_from_dict(d["predicate"]),
                        plan_from_dict(d["input"], ctx))
    if n == "aggregate":
        return L.Aggregate([expr_from_dict(e) for e in d["group"]],
                           [expr_from_dict(e) for e in d["aggr"]],
                           plan_from_dict(d["input"], ctx))
    if n == "sort":
        return L.Sort([sort_from_dict(s) for s in d["exprs"]],
                      plan_from_dict(d["input"], ctx), fetch=d.get("fetch"))
    if n == "join":
        return L.Join(plan_from_dict(d["left"], ctx),
                      plan_from_dict(d["right"], ctx),
                      [(expr_from_dict(l), expr_from_dict(r))
                       for l, r in d["on"]],
                      expr_from_dict(d["filter"]) if d["filter"] else None,
                      d["join_type"])
    if n == "cross_join":
        return L.CrossJoin(plan_from_dict(d["left"], ctx),
                           plan_from_dict(d["right"], ctx))
    if n == "limit":
        return L.Limit(plan_from_dict(d["input"], ctx), d["skip"], d["fetch"])
    if n == "union":
        return L.Union([plan_from_dict(i, ctx) for i in d["inputs"]])
    if n == "intersect":
        return L.Intersect(plan_from_dict(d["left"], ctx),
                           plan_from_dict(d["right"], ctx), d["all"])
    if n == "except":
        return L.Except(plan_from_dict(d["left"], ctx),
                        plan_from_dict(d["right"], ctx), d["all"])
    if n == "distinct":
        return L.Distinct(
            plan_from_dict(d["input"], ctx),
            [expr_from_dict(e) for e in d["on"]] if d.get("on") else None,
            [expr_from_dict(e) for e in d["select"]] if d.get("select") else None,
            [sort_from_dict(s) for s in d["sort"]] if d.get("sort") else None)
    if n == "window":
        return L.Window([expr_from_dict(e) for e in d["exprs"]],
                        plan_from_dict(d["input"], ctx))
    if n == "subquery_alias":
        return L.SubqueryAlias(plan_from_dict(d["input"], ctx), d["alias"])
    if n == "values":
        schema = Schema([Field(nm, dtype_from_dict(t), nl)
                         for nm, t, nl in d["schema"]])
        return L.Values([[expr_from_dict(e) for e in row]
                         for row in d["rows"]], schema)
    raise PlanError(f"cannot deserialize plan node '{n}'")


def plan_to_json(p: L.LogicalPlan) -> str:
    return json.dumps(plan_to_dict(p))


def plan_from_json(s: str, ctx) -> L.LogicalPlan:
    return plan_from_dict(json.loads(s), ctx)
