"""Logical expression IR.

Reference parity: `Expr` (`datafusion/expr/src/expr.rs:220-323`, 34 variants).
Backend-agnostic dataclasses — planning is not hot, so this layer stays pure
Python; the physical layer lowers each node to a jittable columnar kernel.

Every node supports:
  children() / with_children()  — tree rewriting (the TreeNode analog,
                                  `datafusion/common/src/tree_node.rs:94`)
  data_type(schema) / nullable(schema)
  display name (the output column name, matching reference naming like
  ``sum(lineitem.l_quantity)``)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..common import dt
from ..common.datatypes import DataType, TypeId
from ..common.errors import PlanError, internal
from ..common.scalar import ScalarValue
from ..common.schema import Schema
from .operator import Op

# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def with_children(self, children: Sequence["Expr"]) -> "Expr":
        assert not children
        return self

    # -- tree rewriting ------------------------------------------------------
    def transform_up(self, f) -> "Expr":
        new_children = tuple(c.transform_up(f) for c in self.children())
        node = self.with_children(new_children) if new_children != self.children() else self
        out = f(node)
        return node if out is None else out

    def transform_down(self, f) -> "Expr":
        out = f(self)
        node = self if out is None else out
        new_children = tuple(c.transform_down(f) for c in node.children())
        return node.with_children(new_children) if new_children != node.children() else node

    def visit(self, f) -> None:
        f(self)
        for c in self.children():
            c.visit(f)

    def collect(self, pred) -> List["Expr"]:
        out: List[Expr] = []
        self.visit(lambda e: out.append(e) if pred(e) else None)
        return out

    def contains(self, pred) -> bool:
        return bool(self.collect(pred))

    # -- typing ---------------------------------------------------------------
    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError(type(self).__name__)

    def nullable(self, schema: Schema) -> bool:
        return True

    # -- naming ----------------------------------------------------------------
    def display_name(self) -> str:
        return str(self)

    # -- sugar ------------------------------------------------------------------
    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def eq(self, other: "Expr") -> "BinaryExpr":
        return BinaryExpr(self, Op.EQ, other)

    def __and__(self, other):
        return BinaryExpr(self, Op.AND, other)

    def __or__(self, other):
        return BinaryExpr(self, Op.OR, other)


# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    name: str
    qualifier: Optional[str] = None

    def data_type(self, schema: Schema) -> DataType:
        return schema.field_by_name(self.name, self.qualifier).dtype

    def nullable(self, schema: Schema) -> bool:
        return schema.field_by_name(self.name, self.qualifier).nullable

    def __str__(self):
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name

    def flat_name(self) -> str:
        return str(self)


@dataclasses.dataclass(frozen=True)
class OuterRef(Expr):
    """A column resolved against an *outer* query schema (correlated
    subquery). Reference: Expr::OuterReferenceColumn (`expr.rs:234`)."""
    column: Column
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def __str__(self):
        return f"outer_ref({self.column})"


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: ScalarValue

    def data_type(self, schema: Schema) -> DataType:
        return self.value.dtype

    def nullable(self, schema: Schema) -> bool:
        return self.value.is_null

    def __str__(self):
        # matches the reference's ScalarValue Display used in auto-generated
        # schema names (expr/src/expr.rs Display): Int64(1), Utf8("x"), …
        v = self.value
        if v.dtype.is_string and v.value is not None:
            return f"Utf8(\"{v.value}\")"
        if v.is_null:
            return "NULL"
        tid = v.dtype.id
        if tid == TypeId.INT64:
            return f"Int64({v.value})"
        if tid == TypeId.INT32:
            return f"Int32({v.value})"
        if tid == TypeId.FLOAT64:
            return f"Float64({v.value})"
        if tid == TypeId.FLOAT32:
            return f"Float32({v.value})"
        if tid == TypeId.BOOL:
            return f"Boolean({'true' if v.value else 'false'})"
        return str(v.value)


@dataclasses.dataclass(frozen=True)
class Alias(Expr):
    expr: Expr
    name: str

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return Alias(c[0], self.name)

    def data_type(self, schema):
        return self.expr.data_type(schema)

    def nullable(self, schema):
        return self.expr.nullable(schema)

    def display_name(self):
        return self.name

    def __str__(self):
        return f"{self.expr} AS {self.name}"


@dataclasses.dataclass(frozen=True)
class BinaryExpr(Expr):
    left: Expr
    op: Op
    right: Expr

    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return BinaryExpr(c[0], self.op, c[1])

    def data_type(self, schema):
        if self.op.is_comparison or self.op.is_logic:
            return dt.BOOL
        lt, rt = self.left.data_type(schema), self.right.data_type(schema)
        if self.op == Op.STRING_CONCAT:
            return dt.STRING
        # temporal arithmetic
        if lt.is_temporal or rt.is_temporal:
            if self.op == Op.MINUS and lt.is_temporal and rt.is_temporal:
                return dt.INTERVAL
            return lt if lt.is_temporal else rt
        if lt.is_interval:
            return rt if rt.is_temporal else dt.INTERVAL
        if (lt.is_decimal or rt.is_decimal) and self.op.is_arithmetic \
                and not (lt.is_float or rt.is_float):
            # reference decimal arithmetic typing (binary.rs / arrow-rs)
            return dt.decimal_arith_type(self.op.value, lt, rt)
        return dt.common_numeric_type(lt, rt)

    def nullable(self, schema):
        return self.left.nullable(schema) or self.right.nullable(schema)

    def __str__(self):
        return f"{self.left} {self.op} {self.right}"


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    expr: Expr

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return Not(c[0])

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return self.expr.nullable(schema)

    def __str__(self):
        return f"NOT {self.expr}"


@dataclasses.dataclass(frozen=True)
class Negative(Expr):
    expr: Expr

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return Negative(c[0])

    def data_type(self, schema):
        return self.expr.data_type(schema)

    def nullable(self, schema):
        return self.expr.nullable(schema)

    def __str__(self):
        return f"(- {self.expr})"


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return IsNull(c[0], self.negated)

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return False

    def __str__(self):
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclasses.dataclass(frozen=True)
class IsBool(Expr):
    """IS [NOT] TRUE / FALSE / UNKNOWN."""
    expr: Expr
    value: Optional[bool]
    negated: bool = False

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return IsBool(c[0], self.value, self.negated)

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return False

    def __str__(self):
        v = "UNKNOWN" if self.value is None else str(self.value).upper()
        return f"{self.expr} IS {'NOT ' if self.negated else ''}{v}"


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    operand: Optional[Expr]
    whens: Tuple[Tuple[Expr, Expr], ...]
    else_: Optional[Expr]

    def children(self):
        out = []
        if self.operand is not None:
            out.append(self.operand)
        for w, t in self.whens:
            out.extend((w, t))
        if self.else_ is not None:
            out.append(self.else_)
        return tuple(out)

    def with_children(self, c):
        c = list(c)
        operand = c.pop(0) if self.operand is not None else None
        whens = []
        for _ in self.whens:
            w = c.pop(0)
            t = c.pop(0)
            whens.append((w, t))
        else_ = c.pop(0) if self.else_ is not None else None
        return Case(operand, tuple(whens), else_)

    def data_type(self, schema):
        types = [t.data_type(schema) for _, t in self.whens]
        if self.else_ is not None:
            types.append(self.else_.data_type(schema))
        out = types[0]
        for t in types[1:]:
            if t == out or t.is_null:
                continue
            if out.is_null:
                out = t
            elif out.is_numeric and t.is_numeric:
                out = dt.common_numeric_type(out, t)
            else:
                out = t
        return out

    def nullable(self, schema):
        if self.else_ is None:
            return True
        return any(t.nullable(schema) for _, t in self.whens) or self.else_.nullable(schema)

    def __str__(self):
        parts = ["CASE"]
        if self.operand is not None:
            parts.append(str(self.operand))
        for w, t in self.whens:
            parts.append(f"WHEN {w} THEN {t}")
        if self.else_ is not None:
            parts.append(f"ELSE {self.else_}")
        parts.append("END")
        return " ".join(parts)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    dtype: DataType
    safe: bool = False   # TRY_CAST returns NULL on failure

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return Cast(c[0], self.dtype, self.safe)

    def data_type(self, schema):
        return self.dtype

    def nullable(self, schema):
        return self.expr.nullable(schema) or self.safe

    def __str__(self):
        return f"CAST({self.expr} AS {self.dtype})"

    def display_name(self):
        # reference: cast keeps the inner expr's display name
        return self.expr.display_name()


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False
    escape: Optional[str] = None

    def children(self):
        return (self.expr, self.pattern)

    def with_children(self, c):
        return Like(c[0], c[1], self.negated, self.case_insensitive, self.escape)

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return self.expr.nullable(schema) or self.pattern.nullable(schema)

    def __str__(self):
        op = "ILIKE" if self.case_insensitive else "LIKE"
        return f"{self.expr} {'NOT ' if self.negated else ''}{op} {self.pattern}"


@dataclasses.dataclass(frozen=True)
class SimilarTo(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False

    def children(self):
        return (self.expr, self.pattern)

    def with_children(self, c):
        return SimilarTo(c[0], c[1], self.negated)

    def data_type(self, schema):
        return dt.BOOL

    def __str__(self):
        return f"{self.expr} SIMILAR TO {self.pattern}"


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: Tuple[Expr, ...]
    negated: bool = False

    def children(self):
        return (self.expr,) + self.items

    def with_children(self, c):
        return InList(c[0], tuple(c[1:]), self.negated)

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return self.expr.nullable(schema) or any(i.nullable(schema) for i in self.items)

    def __str__(self):
        return f"{self.expr} {'NOT ' if self.negated else ''}IN ({', '.join(map(str, self.items))})"


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def children(self):
        return (self.expr, self.low, self.high)

    def with_children(self, c):
        return Between(c[0], c[1], c[2], self.negated)

    def data_type(self, schema):
        return dt.BOOL

    def __str__(self):
        return f"{self.expr} {'NOT ' if self.negated else ''}BETWEEN {self.low} AND {self.high}"


@dataclasses.dataclass(frozen=True)
class ScalarFunction(Expr):
    name: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    def with_children(self, c):
        return ScalarFunction(self.name, tuple(c))

    def data_type(self, schema):
        from ..functions.registry import scalar_return_type
        arg_types = [a.data_type(schema) for a in self.args]
        # struct-family functions need argument *values* (field names), not
        # just types (reference: functions/src/core/{struct,getfield}.rs)
        if self.name in ("struct", "row"):
            return dt.struct((f"c{i}", t) for i, t in enumerate(arg_types))
        if self.name == "named_struct":
            names = [a.value.value if isinstance(a, Literal) else f"c{i // 2}"
                     for i, a in enumerate(self.args) if i % 2 == 0]
            return dt.struct(zip(names, arg_types[1::2]))
        if self.name == "get_field":
            st = arg_types[0]
            if st.fields and isinstance(self.args[1], Literal):
                key = self.args[1].value.value
                for fname, ftype in st.fields:
                    if fname == key:
                        return ftype
            return dt.NULL
        return scalar_return_type(self.name, arg_types)

    def nullable(self, schema):
        return True

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class AggregateFunction(Expr):
    name: str
    args: Tuple[Expr, ...]
    distinct: bool = False
    filter: Optional[Expr] = None
    order_by: Tuple["SortExpr", ...] = ()
    ignore_nulls: bool = False

    def children(self):
        out = list(self.args)
        if self.filter is not None:
            out.append(self.filter)
        out.extend(s.expr for s in self.order_by)
        return tuple(out)

    def with_children(self, c):
        c = list(c)
        nargs = tuple(c[:len(self.args)])
        k = len(self.args)
        filt = None
        if self.filter is not None:
            filt = c[k]
            k += 1
        nob = tuple(dataclasses.replace(s, expr=e)
                    for s, e in zip(self.order_by, c[k:]))
        return AggregateFunction(self.name, nargs, self.distinct, filt,
                                 nob, self.ignore_nulls)

    def data_type(self, schema):
        from ..functions.registry import aggregate_return_type
        return aggregate_return_type(
            self.name, [a.data_type(schema) for a in self.args])

    def nullable(self, schema):
        return self.name not in ("count",)

    def __str__(self):
        inner = "*" if not self.args else ", ".join(map(str, self.args))
        d = "DISTINCT " if self.distinct else ""
        s = f"{self.name}({d}{inner})"
        if self.order_by:
            # the reference's schema name includes the ordering, which also
            # keeps two same-arg aggregates with different ORDER BY distinct
            # (aggregate_function display_name)
            s += " ORDER BY [" + ", ".join(
                f"{o.expr} {'ASC' if o.asc else 'DESC'} "
                f"{'NULLS FIRST' if o.nulls_first else 'NULLS LAST'}"
                for o in self.order_by) + "]"
        if self.filter is not None:
            s += f" FILTER (WHERE {self.filter})"
        return s


@dataclasses.dataclass(frozen=True)
class WindowFrameBound:
    kind: str  # UNBOUNDED_PRECEDING | PRECEDING | CURRENT | FOLLOWING | UNBOUNDED_FOLLOWING
    offset: Optional[ScalarValue] = None


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    units: str = "RANGE"  # ROWS | RANGE | GROUPS
    start: WindowFrameBound = WindowFrameBound("UNBOUNDED_PRECEDING")
    end: WindowFrameBound = WindowFrameBound("CURRENT")

    def __str__(self):
        def b(x):
            k = x.kind
            if k == "UNBOUNDED_PRECEDING":
                return "UNBOUNDED PRECEDING"
            if k == "UNBOUNDED_FOLLOWING":
                return "UNBOUNDED FOLLOWING"
            if k == "CURRENT":
                return "CURRENT ROW"
            return f"{x.offset} {k}"
        return f"{self.units} BETWEEN {b(self.start)} AND {b(self.end)}"


@dataclasses.dataclass(frozen=True)
class WindowFunction(Expr):
    name: str                      # rank/row_number/... or aggregate name
    args: Tuple[Expr, ...]
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple["SortExpr", ...] = ()
    frame: WindowFrame = WindowFrame()
    ignore_nulls: bool = False

    def children(self):
        return self.args + self.partition_by + tuple(s.expr for s in self.order_by)

    def with_children(self, c):
        c = list(c)
        na = tuple(c[:len(self.args)])
        npb = tuple(c[len(self.args):len(self.args) + len(self.partition_by)])
        rest = c[len(self.args) + len(self.partition_by):]
        nob = tuple(dataclasses.replace(s, expr=e) for s, e in zip(self.order_by, rest))
        return WindowFunction(self.name, na, npb, nob, self.frame,
                              self.ignore_nulls)

    def data_type(self, schema):
        from ..functions.registry import window_return_type
        return window_return_type(self.name, [a.data_type(schema) for a in self.args])

    def __str__(self):
        inner = ", ".join(map(str, self.args))
        s = f"{self.name}({inner})"
        if self.ignore_nulls:
            s += " IGNORE NULLS"
        s += " OVER ("
        if self.partition_by:
            s += "PARTITION BY " + ", ".join(map(str, self.partition_by)) + " "
        if self.order_by:
            s += "ORDER BY " + ", ".join(map(str, self.order_by)) + " "
        # the frame is part of the expression's identity: two windows that
        # differ only in frame must not dedup together (reference: the
        # display includes the frame, expr/src/expr.rs WindowFunction)
        s += str(self.frame)
        return s.rstrip() + ")"


@dataclasses.dataclass(frozen=True)
class Exists(Expr):
    subquery: object             # LogicalPlan
    negated: bool = False
    outer_refs: Tuple[Column, ...] = ()

    def data_type(self, schema):
        return dt.BOOL

    def nullable(self, schema):
        return False

    def __str__(self):
        return f"{'NOT ' if self.negated else ''}EXISTS (<subquery>)"


@dataclasses.dataclass(frozen=True)
class InSubquery(Expr):
    expr: Expr
    subquery: object             # LogicalPlan
    negated: bool = False
    outer_refs: Tuple[Column, ...] = ()

    def children(self):
        return (self.expr,)

    def with_children(self, c):
        return InSubquery(c[0], self.subquery, self.negated, self.outer_refs)

    def data_type(self, schema):
        return dt.BOOL

    def __str__(self):
        return f"{self.expr} {'NOT ' if self.negated else ''}IN (<subquery>)"


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Expr):
    subquery: object             # LogicalPlan
    outer_refs: Tuple[Column, ...] = ()

    def data_type(self, schema):
        return self.subquery.schema.fields[0].dtype

    def __str__(self):
        return "(<scalar subquery>)"


@dataclasses.dataclass(frozen=True)
class Placeholder(Expr):
    index: int
    dtype: DataType = dt.NULL

    def data_type(self, schema):
        return self.dtype

    def __str__(self):
        return f"${self.index}"


@dataclasses.dataclass(frozen=True)
class SortExpr:
    """Not an Expr itself (matches reference's separate SortExpr)."""
    expr: Expr
    asc: bool = True
    nulls_first: bool = False

    def __str__(self):
        return f"{self.expr} {'ASC' if self.asc else 'DESC'}" + \
               (" NULLS FIRST" if self.nulls_first else "")


@dataclasses.dataclass(frozen=True)
class GroupingSet(Expr):
    """GROUPING SETS / ROLLUP / CUBE container (Expr::GroupingSet,
    `expr.rs:312-314`)."""
    sets: Tuple[Tuple[Expr, ...], ...]

    def children(self):
        return tuple(e for s in self.sets for e in s)

    def data_type(self, schema):
        raise internal("GroupingSet has no single type")

    def distinct_exprs(self) -> List[Expr]:
        seen = []
        for s in self.sets:
            for e in s:
                if e not in seen:
                    seen.append(e)
        return seen

    def __str__(self):
        return "GROUPING SETS (" + ", ".join(
            "(" + ", ".join(map(str, s)) + ")" for s in self.sets) + ")"


# --------------------------------------------------------------------------
# helpers


def col(name: str) -> Column:
    if "." in name:
        q, n = name.rsplit(".", 1)
        return Column(n, q)
    return Column(name)


def lit(v) -> Literal:
    if isinstance(v, ScalarValue):
        return Literal(v)
    if isinstance(v, bool):
        return Literal(ScalarValue.boolean(v))
    if isinstance(v, int):
        return Literal(ScalarValue.int64(v))
    if isinstance(v, float):
        return Literal(ScalarValue.float64(v))
    if isinstance(v, str):
        return Literal(ScalarValue.string(v))
    if v is None:
        return Literal(ScalarValue.null())
    raise PlanError(f"cannot make literal from {type(v)}")


def conjunction(exprs: Sequence[Expr]) -> Optional[Expr]:
    exprs = list(exprs)
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryExpr(out, Op.AND, e)
    return out


def split_conjunction(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, BinaryExpr) and e.op == Op.AND:
        return split_conjunction(e.left) + split_conjunction(e.right)
    if isinstance(e, Alias):
        return split_conjunction(e.expr)
    return [e]


def expr_to_columns(e: Expr) -> List[Column]:
    return [c for c in e.collect(lambda x: isinstance(x, Column))]
