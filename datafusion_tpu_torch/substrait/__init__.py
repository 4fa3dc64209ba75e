"""Substrait interchange (JSON encoding).

Reference parity: the `datafusion-substrait` crate — produce/consume
Substrait plans so other engines can exchange query plans with this one.
Scope mirrors the reference's supported subset: ReadRel (named table),
FilterRel, ProjectRel, AggregateRel, JoinRel, CrossRel, FetchRel, SortRel,
SetRel (union); expressions: field selections (direct references),
literals, scalar functions (anchored in the extension registry), casts,
IfThen.  The JSON form follows the substrait.io protobuf JSON mapping so
plans are portable; round-trip tests assert consumer(producer(plan))
returns the same rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..common import dt
from ..common.datatypes import DataType, TypeId
from ..common.errors import NotImplementedError_, PlanError
from ..common.scalar import ScalarValue
from ..expr import (
    Aggregate, AggregateFunction, Alias, BinaryExpr, Case, Cast, Column,
    CrossJoin, Distinct, Expr, Filter, Join, Limit, Literal, LogicalPlan,
    Not, Op, Projection, ScalarFunction, Sort, SortExpr, SubqueryAlias,
    TableScan, Union,
)

SUBSTRAIT_VERSION = {"minorNumber": 53, "producer": "datafusion-tpu"}

_OP_FN = {
    Op.EQ: "equal", Op.NEQ: "not_equal", Op.LT: "lt", Op.LTEQ: "lte",
    Op.GT: "gt", Op.GTEQ: "gte", Op.PLUS: "add", Op.MINUS: "subtract",
    Op.MULTIPLY: "multiply", Op.DIVIDE: "divide", Op.MODULO: "modulus",
    Op.AND: "and", Op.OR: "or", Op.STRING_CONCAT: "concat",
}
_FN_OP = {v: k for k, v in _OP_FN.items()}


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

def _type_to_substrait(t: DataType, nullable: bool = True) -> dict:
    nul = "NULLABILITY_NULLABLE" if nullable else "NULLABILITY_REQUIRED"
    if t.id == TypeId.BOOL:
        return {"bool": {"nullability": nul}}
    if t.id == TypeId.INT8:
        return {"i8": {"nullability": nul}}
    if t.id == TypeId.INT16:
        return {"i16": {"nullability": nul}}
    if t.id == TypeId.INT32:
        return {"i32": {"nullability": nul}}
    if t.id in (TypeId.INT64, TypeId.UINT64):
        return {"i64": {"nullability": nul}}
    if t.id == TypeId.FLOAT32:
        return {"fp32": {"nullability": nul}}
    if t.id in (TypeId.FLOAT64, TypeId.NULL):
        return {"fp64": {"nullability": nul}}
    if t.is_string:
        return {"string": {"nullability": nul}}
    if t.is_decimal:
        return {"decimal": {"precision": t.precision, "scale": t.scale,
                            "nullability": nul}}
    if t.id == TypeId.DATE:
        return {"date": {"nullability": nul}}
    if t.id == TypeId.TIMESTAMP:
        return {"timestamp": {"nullability": nul}}
    raise NotImplementedError_(f"substrait type for {t}")


def _type_from_substrait(d: dict) -> DataType:
    kind = next(iter(d))
    m = {"bool": dt.BOOL, "i8": dt.INT8, "i16": dt.INT16, "i32": dt.INT32,
         "i64": dt.INT64, "fp32": dt.FLOAT32, "fp64": dt.FLOAT64,
         "string": dt.STRING, "date": dt.DATE,
         "timestamp": dt.timestamp("us")}
    if kind in m:
        return m[kind]
    if kind == "decimal":
        return dt.decimal(d[kind].get("precision", 38),
                          d[kind].get("scale", 0))
    raise NotImplementedError_(f"substrait type {kind}")


# ---------------------------------------------------------------------------
# producer
# ---------------------------------------------------------------------------

class _Producer:
    def __init__(self):
        self.functions: Dict[str, int] = {}

    def anchor(self, name: str) -> int:
        if name not in self.functions:
            self.functions[name] = len(self.functions) + 1
        return self.functions[name]

    # -- expressions -------------------------------------------------------
    def expr(self, e: Expr, schema) -> dict:
        if isinstance(e, Alias):
            return self.expr(e.expr, schema)   # names live on the root rel
        if isinstance(e, Column):
            idx = schema.index_of(e.name, e.qualifier)
            return {"selection": {
                "directReference": {"structField": {"field": idx}},
                "rootReference": {}}}
        if isinstance(e, Literal):
            return {"literal": self.literal(e.value)}
        if isinstance(e, BinaryExpr):
            fn = _OP_FN.get(e.op)
            if fn is None:
                raise NotImplementedError_(f"substrait op {e.op}")
            return self.fn_call(fn, [self.expr(e.left, schema),
                                     self.expr(e.right, schema)])
        if isinstance(e, Not):
            return self.fn_call("not", [self.expr(e.expr, schema)])
        if isinstance(e, ScalarFunction):
            return self.fn_call(e.name,
                                [self.expr(a, schema) for a in e.args])
        if isinstance(e, Cast):
            return {"cast": {
                "type": _type_to_substrait(e.dtype),
                "input": self.expr(e.expr, schema),
                "failureBehavior": "FAILURE_BEHAVIOR_RETURN_NULL"
                if e.safe else "FAILURE_BEHAVIOR_THROW_EXCEPTION"}}
        if isinstance(e, Case):
            if e.operand is not None:
                raise NotImplementedError_("substrait CASE <operand>")
            return {"ifThen": {
                "ifs": [{"if": self.expr(w, schema),
                         "then": self.expr(t, schema)}
                        for w, t in e.whens],
                "else": self.expr(e.else_, schema) if e.else_ is not None
                else {"literal": {"null": _type_to_substrait(dt.NULL)}}}}
        from ..expr import Between, InList, IsNull, Like, Negative
        if isinstance(e, Like):
            fn = "ilike" if e.case_insensitive else "like"
            call = self.fn_call(fn, [self.expr(e.expr, schema),
                                     self.expr(e.pattern, schema)])
            return self.fn_call("not", [call]) if e.negated else call
        if isinstance(e, IsNull):
            call = self.fn_call("is_null", [self.expr(e.expr, schema)])
            return self.fn_call("not", [call]) if e.negated else call
        if isinstance(e, Negative):
            return self.fn_call("negate", [self.expr(e.expr, schema)])
        if isinstance(e, Between):
            low = self.fn_call(
                "gte", [self.expr(e.expr, schema), self.expr(e.low, schema)])
            high = self.fn_call(
                "lte", [self.expr(e.expr, schema), self.expr(e.high, schema)])
            call = self.fn_call("and", [low, high])
            return self.fn_call("not", [call]) if e.negated else call
        if isinstance(e, InList):
            cond = None
            for item in e.items:
                eq = self.fn_call("equal", [self.expr(e.expr, schema),
                                            self.expr(item, schema)])
                cond = eq if cond is None else self.fn_call("or", [cond, eq])
            return self.fn_call("not", [cond]) if e.negated else cond
        raise NotImplementedError_(f"substrait expr {type(e).__name__}")

    def fn_call(self, name: str, args: List[dict]) -> dict:
        return {"scalarFunction": {
            "functionReference": self.anchor(name),
            "arguments": [{"value": a} for a in args],
            "outputType": _type_to_substrait(dt.NULL)}}

    def literal(self, v: ScalarValue) -> dict:
        if v.value is None:
            return {"null": _type_to_substrait(v.dtype)}
        t = v.dtype
        if t.id == TypeId.BOOL:
            return {"boolean": bool(v.value)}
        if t.id in (TypeId.INT8, TypeId.INT16, TypeId.INT32):
            return {"i32": int(v.value)}
        if t.id in (TypeId.INT64, TypeId.UINT64):
            return {"i64": str(int(v.value))}
        if t.id == TypeId.FLOAT32:
            return {"fp32": float(v.value)}
        if t.id == TypeId.FLOAT64:
            return {"fp64": float(v.value)}
        if t.is_string:
            return {"string": str(v.value)}
        if t.is_decimal:
            from decimal import Decimal as PyDecimal
            unscaled = int(PyDecimal(str(v.value)).scaleb(t.scale))
            return {"decimal": {"value": str(unscaled),
                                "precision": t.precision, "scale": t.scale}}
        if t.id == TypeId.DATE:
            import datetime as _dt
            return {"date": (v.value - _dt.date(1970, 1, 1)).days}
        raise NotImplementedError_(f"substrait literal {t}")

    # -- relations -----------------------------------------------------------
    def rel(self, plan: LogicalPlan) -> dict:
        if isinstance(plan, TableScan):
            s = plan.source.schema()
            return {"read": {
                "baseSchema": {
                    "names": [f.name for f in s.fields],
                    "struct": {"types": [
                        _type_to_substrait(f.dtype, f.nullable)
                        for f in s.fields]}},
                "namedTable": {"names": [plan.name]}}}
        if isinstance(plan, SubqueryAlias):
            return self.rel(plan.input)   # alias is a naming concern
        if isinstance(plan, Filter):
            return {"filter": {
                "input": self.rel(plan.input),
                "condition": self.expr(plan.predicate, plan.input.schema)}}
        if isinstance(plan, Projection):
            n_in = len(plan.input.schema.fields)
            return {"project": {
                "input": self.rel(plan.input),
                "expressions": [self.expr(e, plan.input.schema)
                                for e in plan.exprs],
                # emit only the new expressions (drop the pass-through input)
                "common": {"emit": {"outputMapping": [
                    n_in + i for i in range(len(plan.exprs))]}}}}
        if isinstance(plan, Aggregate):
            ischema = plan.input.schema
            measures = []
            for a in plan.aggr_exprs:
                agg = a.expr if isinstance(a, Alias) else a
                if not isinstance(agg, AggregateFunction):
                    raise NotImplementedError_("substrait non-function measure")
                measures.append({"measure": {
                    "functionReference": self.anchor(agg.name),
                    "arguments": [{"value": self.expr(x, ischema)}
                                  for x in agg.args],
                    "invocation": "AGGREGATION_INVOCATION_DISTINCT"
                    if agg.distinct else "AGGREGATION_INVOCATION_ALL",
                    "phase": "AGGREGATION_PHASE_INITIAL_TO_RESULT",
                    "outputType": _type_to_substrait(dt.NULL)}})
            return {"aggregate": {
                "input": self.rel(plan.input),
                "groupings": [{"groupingExpressions": [
                    self.expr(g, ischema) for g in plan.group_exprs]}],
                "measures": measures}}
        if isinstance(plan, Join):
            jt = {"INNER": "JOIN_TYPE_INNER", "LEFT": "JOIN_TYPE_LEFT",
                  "RIGHT": "JOIN_TYPE_RIGHT", "FULL": "JOIN_TYPE_OUTER",
                  "LEFTSEMI": "JOIN_TYPE_LEFT_SEMI",
                  "LEFTANTI": "JOIN_TYPE_LEFT_ANTI"}.get(plan.join_type)
            if jt is None:
                raise NotImplementedError_(
                    f"substrait join {plan.join_type}")
            pair = plan.left.schema.merge(plan.right.schema)
            cond: Optional[Expr] = None
            for l, r in plan.on:
                eq = BinaryExpr(l, Op.EQ, r)
                cond = eq if cond is None else BinaryExpr(cond, Op.AND, eq)
            if plan.filter is not None:
                cond = plan.filter if cond is None else \
                    BinaryExpr(cond, Op.AND, plan.filter)
            out = {"join": {
                "left": self.rel(plan.left),
                "right": self.rel(plan.right),
                "type": jt}}
            if cond is not None:
                out["join"]["expression"] = self.expr(cond, pair)
            return out
        if isinstance(plan, CrossJoin):
            return {"cross": {"left": self.rel(plan.left),
                              "right": self.rel(plan.right)}}
        if isinstance(plan, Limit):
            return {"fetch": {"input": self.rel(plan.input),
                              "offset": str(plan.skip),
                              "count": str(plan.fetch if plan.fetch is not None
                                           else -1)}}
        if isinstance(plan, Sort):
            return {"sort": {
                "input": self.rel(plan.input),
                "sorts": [{
                    "expr": self.expr(s.expr, plan.input.schema),
                    "direction":
                        ("SORT_DIRECTION_ASC_NULLS_FIRST" if s.nulls_first
                         else "SORT_DIRECTION_ASC_NULLS_LAST") if s.asc else
                        ("SORT_DIRECTION_DESC_NULLS_FIRST" if s.nulls_first
                         else "SORT_DIRECTION_DESC_NULLS_LAST")}
                    for s in plan.sort_exprs]}}
        if isinstance(plan, Union):
            return {"set": {"inputs": [self.rel(i) for i in plan.inputs],
                            "op": "SET_OP_UNION_ALL"}}
        if isinstance(plan, Distinct) and not plan.on_exprs:
            # Distinct(Union) -> SET_OP_UNION_DISTINCT; else group-by-all
            if isinstance(plan.input, Union):
                return {"set": {"inputs": [self.rel(i)
                                           for i in plan.input.inputs],
                                "op": "SET_OP_UNION_DISTINCT"}}
            ischema = plan.input.schema
            return {"aggregate": {
                "input": self.rel(plan.input),
                "groupings": [{"groupingExpressions": [
                    self.expr(Column(f.name, f.qualifier), ischema)
                    for f in ischema.fields]}],
                "measures": []}}
        raise NotImplementedError_(
            f"substrait relation {type(plan).__name__}")


def plan_to_substrait(plan: LogicalPlan) -> dict:
    p = _Producer()
    rel = p.rel(plan)
    return {
        "version": SUBSTRAIT_VERSION,
        "extensionUris": [{"extensionUriAnchor": 1,
                           "uri": "/functions.yaml"}],
        "extensions": [
            {"extensionFunction": {"extensionUriReference": 1,
                                   "functionAnchor": a, "name": n}}
            for n, a in p.functions.items()],
        "relations": [{"root": {
            "input": rel,
            "names": [f.name for f in plan.schema.fields]}}],
    }


# ---------------------------------------------------------------------------
# consumer
# ---------------------------------------------------------------------------

class _Consumer:
    def __init__(self, ctx, functions: Dict[int, str]):
        self.ctx = ctx
        self.functions = functions

    # -- expressions ---------------------------------------------------------
    def expr(self, d: dict, schema) -> Expr:
        if "selection" in d:
            idx = d["selection"]["directReference"]["structField"] \
                .get("field", 0)
            f = schema.fields[idx]
            return Column(f.name, f.qualifier)
        if "literal" in d:
            return Literal(self.literal(d["literal"]))
        if "scalarFunction" in d:
            sf = d["scalarFunction"]
            name = self.functions[sf["functionReference"]]
            args = [self.expr(a["value"], schema)
                    for a in sf.get("arguments", [])]
            if name in _FN_OP and len(args) == 2:
                return BinaryExpr(args[0], _FN_OP[name], args[1])
            if name == "not":
                return Not(args[0])
            from ..expr import IsNull, Like, Negative
            if name in ("like", "ilike") and len(args) == 2:
                return Like(args[0], args[1],
                            case_insensitive=name == "ilike")
            if name == "is_null":
                return IsNull(args[0])
            if name == "negate":
                return Negative(args[0])
            return ScalarFunction(name, tuple(args))
        if "cast" in d:
            return Cast(self.expr(d["cast"]["input"], schema),
                        _type_from_substrait(d["cast"]["type"]),
                        d["cast"].get("failureBehavior", "").endswith(
                            "RETURN_NULL"))
        if "ifThen" in d:
            whens = tuple((self.expr(i["if"], schema),
                           self.expr(i["then"], schema))
                          for i in d["ifThen"]["ifs"])
            els = self.expr(d["ifThen"]["else"], schema) \
                if "else" in d["ifThen"] else None
            if isinstance(els, Literal) and els.value.is_null:
                els = None
            return Case(None, whens, els)
        raise NotImplementedError_(f"substrait expr {list(d)}")

    def literal(self, d: dict) -> ScalarValue:
        if "null" in d:
            return ScalarValue(_type_from_substrait(d["null"]), None)
        if "boolean" in d:
            return ScalarValue.boolean(bool(d["boolean"]))
        if "i32" in d:
            return ScalarValue(dt.INT32, int(d["i32"]))
        if "i64" in d:
            return ScalarValue.int64(int(d["i64"]))
        if "fp32" in d:
            return ScalarValue(dt.FLOAT32, float(d["fp32"]))
        if "fp64" in d:
            return ScalarValue.float64(float(d["fp64"]))
        if "string" in d:
            return ScalarValue.string(d["string"])
        if "decimal" in d:
            t = dt.decimal(d["decimal"].get("precision", 38),
                           d["decimal"].get("scale", 0))
            from decimal import Decimal as PyDecimal
            unscaled = PyDecimal(int(d["decimal"]["value"]))
            return ScalarValue(t, unscaled.scaleb(-t.scale))
        if "date" in d:
            import datetime as _dt
            return ScalarValue.date(
                _dt.date(1970, 1, 1) + _dt.timedelta(days=int(d["date"])))
        raise NotImplementedError_(f"substrait literal {list(d)}")

    # -- relations -----------------------------------------------------------
    def rel(self, d: dict) -> LogicalPlan:
        if "read" in d:
            names = d["read"]["namedTable"]["names"]
            name = ".".join(names).lower()
            provider = self.ctx.get_table(name)
            return TableScan(names[-1].lower(), provider)
        if "filter" in d:
            inp = self.rel(d["filter"]["input"])
            return Filter(self.expr(d["filter"]["condition"], inp.schema), inp)
        if "project" in d:
            inp = self.rel(d["project"]["input"])
            exprs = [self.expr(e, inp.schema)
                     for e in d["project"]["expressions"]]
            mapping = d["project"].get("common", {}).get("emit", {}) \
                .get("outputMapping")
            if mapping is not None:
                n_in = len(inp.schema.fields)
                all_out = [Column(f.name, f.qualifier)
                           for f in inp.schema.fields] + exprs
                exprs = [all_out[i] for i in mapping]
            return Projection(exprs, inp)
        if "aggregate" in d:
            inp = self.rel(d["aggregate"]["input"])
            groupings = d["aggregate"].get("groupings", [])
            groups = [self.expr(g, inp.schema)
                      for g in (groupings[0].get("groupingExpressions", [])
                                if groupings else [])]
            aggs = []
            for m_ in d["aggregate"].get("measures", []):
                mm = m_["measure"]
                name = self.functions[mm["functionReference"]]
                args = tuple(self.expr(a["value"], inp.schema)
                             for a in mm.get("arguments", []))
                distinct = mm.get("invocation", "").endswith("DISTINCT")
                aggs.append(AggregateFunction(name, args, distinct))
            return Aggregate(groups, aggs, inp)
        if "join" in d:
            left = self.rel(d["join"]["left"])
            right = self.rel(d["join"]["right"])
            jt = {"JOIN_TYPE_INNER": "INNER", "JOIN_TYPE_LEFT": "LEFT",
                  "JOIN_TYPE_RIGHT": "RIGHT", "JOIN_TYPE_OUTER": "FULL",
                  "JOIN_TYPE_LEFT_SEMI": "LEFTSEMI",
                  "JOIN_TYPE_LEFT_ANTI": "LEFTANTI"}[d["join"]["type"]]
            pair = left.schema.merge(right.schema)
            cond = self.expr(d["join"]["expression"], pair) \
                if "expression" in d["join"] else None
            on, residual = _split_equijoin(cond, left.schema, right.schema)
            return Join(left, right, on, residual, jt)
        if "cross" in d:
            return CrossJoin(self.rel(d["cross"]["left"]),
                             self.rel(d["cross"]["right"]))
        if "fetch" in d:
            inp = self.rel(d["fetch"]["input"])
            count = int(d["fetch"].get("count", -1))
            return Limit(inp, int(d["fetch"].get("offset", 0)),
                         None if count < 0 else count)
        if "sort" in d:
            inp = self.rel(d["sort"]["input"])
            ses = []
            for s in d["sort"]["sorts"]:
                direction = s.get("direction", "SORT_DIRECTION_ASC_NULLS_LAST")
                ses.append(SortExpr(self.expr(s["expr"], inp.schema),
                                    "ASC" in direction,
                                    "NULLS_FIRST" in direction))
            return Sort(ses, inp)
        if "set" in d:
            inputs = [self.rel(i) for i in d["set"]["inputs"]]
            u = Union(inputs)
            if d["set"]["op"] == "SET_OP_UNION_DISTINCT":
                return Distinct(u)
            return u
        raise NotImplementedError_(f"substrait relation {list(d)}")


def _split_equijoin(cond: Optional[Expr], lschema, rschema):
    """AND-tree of equalities between sides -> on pairs + residual."""
    if cond is None:
        return [], None
    on: List[Tuple[Expr, Expr]] = []
    residual: Optional[Expr] = None
    lnames = {f.name for f in lschema.fields}

    def side(e: Expr) -> Optional[str]:
        if isinstance(e, Column):
            return "l" if e.name in lnames else "r"
        return None

    def walk(e: Expr):
        nonlocal residual
        if isinstance(e, BinaryExpr) and e.op == Op.AND:
            walk(e.left)
            walk(e.right)
            return
        if isinstance(e, BinaryExpr) and e.op == Op.EQ and \
                side(e.left) == "l" and side(e.right) == "r":
            on.append((e.left, e.right))
            return
        residual = e if residual is None else \
            BinaryExpr(residual, Op.AND, e)

    walk(cond)
    return on, residual


def substrait_to_plan(d: dict, ctx) -> LogicalPlan:
    functions = {}
    for ext in d.get("extensions", []):
        ef = ext.get("extensionFunction")
        if ef:
            functions[ef["functionAnchor"]] = ef["name"]
    root = d["relations"][0]["root"]
    plan = _Consumer(ctx, functions).rel(root["input"])
    names = root.get("names", [])
    if names and names != [f.name for f in plan.schema.fields] and \
            len(names) == len(plan.schema.fields):
        plan = Projection(
            [Alias(Column(f.name, f.qualifier), n)
             for f, n in zip(plan.schema.fields, names)], plan)
    return plan
