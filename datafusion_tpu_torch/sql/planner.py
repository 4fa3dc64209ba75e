"""SQL AST -> LogicalPlan planner.

Reference parity: `SqlToRel` (`datafusion/sql/src/{planner,query,select,
statement}.rs` + `expr/` subdir). Responsibilities: name resolution with
qualifiers and outer-query scopes (correlated subqueries become
Exists/InSubquery/ScalarSubquery exprs carrying their subplans), wildcard
expansion, aggregate extraction + post-aggregation rewriting, window
planning, set operations, CTEs (incl. recursive), VALUES, and GROUP BY /
ORDER BY alias+ordinal resolution.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..common import dt
from ..common.datatypes import DataType
from ..common.errors import NotImplementedError_, PlanError, SchemaError
from ..common.scalar import ScalarValue
from ..common.schema import Field, Schema
from ..expr import (
    Aggregate, AggregateFunction, Alias, Between, BinaryExpr, Case, Cast,
    Column, CrossJoin, Distinct, EmptyRelation, Except, Exists, Expr, Filter,
    GroupingSet, InList, InSubquery, Intersect, IsBool, IsNull, Join, Like,
    Limit, Literal, LogicalPlan, Negative, Not, Op, OuterRef, Placeholder,
    Projection, RecursiveQuery, ScalarFunction, ScalarSubquery, SimilarTo,
    Sort, SortExpr, SubqueryAlias, TableScan, Union, Values, Window,
    WindowFrame, WindowFrameBound, WindowFunction, conjunction,
    find_aggregate_exprs, find_window_exprs, lit, op_from_sql,
)
from ..functions import registry as freg
from . import ast as A

# --------------------------------------------------------------------------

_TYPE_MAP = {
    "INT": dt.INT32, "INTEGER": dt.INT32, "INT4": dt.INT32,
    "BIGINT": dt.INT64, "INT8": dt.INT64, "LONG": dt.INT64,
    "SMALLINT": dt.INT16, "INT2": dt.INT16, "TINYINT": dt.INT8,
    "UNSIGNED": dt.UINT64,
    "TINYINT UNSIGNED": dt.UINT8, "SMALLINT UNSIGNED": dt.UINT16,
    "INT UNSIGNED": dt.UINT32, "INTEGER UNSIGNED": dt.UINT32,
    "BIGINT UNSIGNED": dt.UINT64,
    "FLOAT": dt.FLOAT32, "REAL": dt.FLOAT32, "FLOAT4": dt.FLOAT32,
    "DOUBLE": dt.FLOAT64, "FLOAT8": dt.FLOAT64,
    "BOOLEAN": dt.BOOL, "BOOL": dt.BOOL,
    "VARCHAR": dt.STRING, "CHAR": dt.STRING, "TEXT": dt.STRING,
    "STRING": dt.STRING, "UTF8": dt.STRING,
    "BYTEA": dt.BINARY, "BINARY": dt.BINARY, "VARBINARY": dt.BINARY,
    "DATE": dt.DATE, "TIME": dt.TIME, "INTERVAL": dt.INTERVAL,
    "NULL": dt.NULL,
}


_ARROW_TYPE_MAP = {
    "int8": dt.INT8, "int16": dt.INT16, "int32": dt.INT32, "int64": dt.INT64,
    "uint8": dt.UINT8, "uint16": dt.UINT16, "uint32": dt.UINT32,
    "uint64": dt.UINT64,
    "float16": dt.FLOAT32, "float32": dt.FLOAT32, "float64": dt.FLOAT64,
    "utf8": dt.STRING, "largeutf8": dt.STRING, "utf8view": dt.STRING,
    "binary": dt.BINARY, "largebinary": dt.BINARY, "binaryview": dt.BINARY,
    "boolean": dt.BOOL, "date32": dt.DATE, "date64": dt.DATE64,
    "null": dt.NULL,
}

_ARROW_UNITS = {"second": "s", "millisecond": "ms", "microsecond": "us",
                "nanosecond": "ns"}


def arrow_type_name_to_datatype(name: str) -> DataType:
    """Parse arrow DataType display names as used by `arrow_cast`
    (reference: functions/src/core/arrow_cast.rs + arrow's parser)."""
    s = name.strip()
    low = s.lower()
    if low in _ARROW_TYPE_MAP:
        return _ARROW_TYPE_MAP[low]
    m = re.match(r"(?i)dictionary\s*\(\s*\w+\s*,\s*(.+)\)$", s)
    if m:
        return arrow_type_name_to_datatype(m.group(1))
    m = re.match(r"(?i)timestamp\s*\(\s*(\w+)\s*,\s*(.+)\)$", s)
    if m:
        tzm = re.match(r'(?i)some\s*\(\s*"([^"]*)"\s*\)', m.group(2).strip())
        return dt.timestamp(_ARROW_UNITS.get(m.group(1).lower(), "us"),
                            tz=tzm.group(1) if tzm else None)
    m = re.match(r"(?i)time(?:32|64)\s*\(\s*(\w+)\s*\)$", s)
    if m:
        return dt.time(_ARROW_UNITS.get(m.group(1).lower(), "ns"))
    m = re.match(r"(?i)decimal(128|256)?\s*\(\s*(\d+)\s*,\s*(-?\d+)\s*\)$", s)
    if m:
        return dt.decimal(int(m.group(2)), int(m.group(3)))
    m = re.match(r"(?i)(?:large)?list\s*\(\s*(.+)\)$", s)
    if m:
        return dt.list_(arrow_type_name_to_datatype(m.group(1)))
    m = re.match(r"(?i)fixedsizelist\s*\(\s*(\d+)\s*,\s*(.+)\)$", s)
    if m:
        # variable-length layout underneath; the fixed size is a
        # constraint the reference's arrow arrays enforce physically
        return dt.list_(arrow_type_name_to_datatype(m.group(2)))
    m = re.match(r"(?i)interval\s*\(\s*(\w+)\s*\)", s)
    if m:
        sub = m.group(1).lower()
        return dt.INTERVAL_DT if sub == "daytime" else \
            dt.INTERVAL_YM if sub == "yearmonth" else dt.INTERVAL
    m = re.match(r"(?i)duration\s*\(\s*(\w+)\s*\)", s)
    if m:
        u = _ARROW_UNITS.get(m.group(1).lower(), "ms")
        return dt.DataType(dt.TypeId.INTERVAL, unit=f"rawdur_{u}")
    raise PlanError(f"Unsupported arrow type name {name!r}")


def _check_window_frame(f: WindowFrame, n_order: int) -> None:
    """Frame validation (reference: expr/src/window_frame.rs:120-160
    try_from + check_window_frame): bound direction, RANGE/GROUPS ORDER BY
    requirements, start <= end for literal offsets."""
    if f.start.kind == "UNBOUNDED_FOLLOWING":
        raise PlanError(
            "Invalid window frame: start bound cannot be UNBOUNDED FOLLOWING")
    if f.end.kind == "UNBOUNDED_PRECEDING":
        raise PlanError(
            "Invalid window frame: end bound cannot be UNBOUNDED PRECEDING")
    if f.units == "RANGE" and n_order != 1:
        start_ok = f.start.kind in ("UNBOUNDED_PRECEDING", "CURRENT")
        end_ok = f.end.kind in ("CURRENT", "UNBOUNDED_FOLLOWING")
        if not (start_ok and end_ok):
            raise PlanError("RANGE requires exactly one ORDER BY column")
    if f.units == "GROUPS" and n_order == 0:
        raise PlanError("GROUPS requires an ORDER BY clause")

    def signed(b):
        # numeric offset as a signed position on the frame axis
        if b.offset is None or b.offset.value is None:
            return None
        try:
            v = float(b.offset.value)
        except (TypeError, ValueError):
            return None   # interval offsets: compared at execution
        return -v if b.kind == "PRECEDING" else v if b.kind == "FOLLOWING" else 0.0

    if f.start.kind in ("PRECEDING", "FOLLOWING", "CURRENT") and \
            f.end.kind in ("PRECEDING", "FOLLOWING", "CURRENT"):
        a = 0.0 if f.start.kind == "CURRENT" else signed(f.start)
        b = 0.0 if f.end.kind == "CURRENT" else signed(f.end)
        if a is not None and b is not None and a > b:
            def disp(bd):
                if bd.kind == "CURRENT":
                    return "CURRENT ROW"
                return f"{bd.offset} {bd.kind}"
            raise PlanError(
                f"Invalid window frame: start bound ({disp(f.start)}) "
                f"cannot be larger than end bound ({disp(f.end)})")


def _using_duplicates(plan: LogicalPlan) -> set:
    """(qualifier, name) pairs of right-side USING-join duplicates visible
    in a FROM plan; hidden from unqualified wildcard expansion (reference:
    expand_wildcard using_columns handling, sql/src/expr/mod.rs)."""
    hide = set()

    def walk(p):
        if isinstance(p, Filter):
            walk(p.input)
        elif isinstance(p, Join):
            walk(p.left)
            walk(p.right)
            for c in p.using_columns:
                try:
                    f = p.right.schema.field_by_name(c)
                except Exception:  # noqa: BLE001
                    continue
                hide.add((f.qualifier, f.name))
        elif isinstance(p, CrossJoin):
            walk(p.left)
            walk(p.right)
    walk(plan)
    return hide


def sql_type_to_datatype(name: str, args: Tuple[int, ...] = (),
                         config=None) -> DataType:
    name = name.upper()
    if name.startswith("STRUCT<") and name.endswith(">"):
        # canonicalized by parse_type_name: "STRUCT<a INT, b VARCHAR>"
        body = name[len("STRUCT<"):-1].strip()
        fields = []
        if body:
            depth = 0
            part = ""
            parts = []
            for ch in body:
                if ch == "<" or ch == "(":
                    depth += 1
                elif ch == ">" or ch == ")":
                    depth -= 1
                if ch == "," and depth == 0:
                    parts.append(part)
                    part = ""
                else:
                    part += ch
            parts.append(part)
            for p in parts:
                fname, _, ftype = p.strip().partition(" ")
                targs: Tuple[int, ...] = ()
                if "(" in ftype and ftype.endswith(")"):
                    base, _, rest = ftype.partition("(")
                    targs = tuple(int(x) for x in rest[:-1].split(","))
                    ftype = base
                fields.append((fname.lower(),
                               sql_type_to_datatype(ftype.strip(), targs,
                                                    config)))
        return dt.struct(fields)
    if name in ("VARCHAR", "CHAR", "CHARACTER") and args:
        # length-parameterized character types: accepted (length ignored)
        # unless datafusion.sql_parser.support_varchar_with_length is off
        # (reference: sql/src/planner.rs convert_data_type)
        allowed = True
        if config is not None:
            try:
                allowed = bool(config.get(
                    "datafusion.sql_parser.support_varchar_with_length"))
            except Exception:  # noqa: BLE001
                pass
        if not allowed:
            raise NotImplementedError_(
                f"Unsupported SQL type {name.title()}({args[0]})")
    if name in ("DECIMAL", "NUMERIC", "DEC"):
        p = args[0] if args else 38
        s = args[1] if len(args) > 1 else 0
        return dt.decimal(p, s)
    if name == "TIMESTAMP":
        # reference: SQL TIMESTAMP == Timestamp(Nanosecond, None)
        # (sql/src/planner.rs convert_data_type)
        return dt.timestamp("ns")
    if name == "TIMESTAMPTZ":
        # TIMESTAMP WITH TIME ZONE: typed with the SESSION zone at
        # definition time (reference: convert_data_type + time_zone config)
        tzname = "+00"
        if config is not None:
            try:
                tzname = str(config.get("datafusion.execution.time_zone"))
            except Exception:  # noqa: BLE001
                pass
        return dt.timestamp("ns", tz=tzname)
    if name.endswith("[]"):
        return dt.list_(sql_type_to_datatype(name[:-2]))
    t = _TYPE_MAP.get(name)
    if t is None:
        raise PlanError(f"Unsupported SQL type {name}")
    return t


# aggregate arity table (reference: each UDAF's Signature); names absent
# here accept any arity (count multi-column, UDAFs)
_AGG_ARITY = {
    "sum": {1}, "avg": {1}, "mean": {1}, "min": {1}, "max": {1},
    "median": {1}, "approx_median": {1}, "approx_distinct": {1},
    "stddev": {1}, "stddev_samp": {1}, "stddev_pop": {1},
    "var": {1}, "variance": {1}, "var_samp": {1}, "var_pop": {1},
    "covar": {2}, "covar_samp": {2}, "covar_pop": {2}, "corr": {2},
    "regr_slope": {2}, "regr_intercept": {2}, "regr_count": {2},
    "regr_r2": {2}, "regr_avgx": {2}, "regr_avgy": {2},
    "regr_sxx": {2}, "regr_syy": {2}, "regr_sxy": {2},
    "string_agg": {2}, "nth_value": {2},
    "bit_and": {1}, "bit_or": {1}, "bit_xor": {1},
    "bool_and": {1}, "bool_or": {1}, "every": {1},
    "first_value": {1}, "last_value": {1}, "array_agg": {1},
    "approx_percentile_cont": {2, 3},
    "approx_percentile_cont_with_weight": {3},
}

# window function arities (reference: each built-in's Signature)
_WINDOW_ARITY = {
    "row_number": {0}, "rank": {0}, "dense_rank": {0}, "percent_rank": {0},
    "cume_dist": {0}, "ntile": {1}, "lag": {1, 2, 3}, "lead": {1, 2, 3},
    "first_value": {1}, "last_value": {1}, "nth_value": {2},
}

_INTERVAL_UNIT_FACTORS = {
    "YEAR": ("months", 12), "YEARS": ("months", 12),
    "MONTH": ("months", 1), "MONTHS": ("months", 1),
    "WEEK": ("days", 7), "WEEKS": ("days", 7),
    "DAY": ("days", 1), "DAYS": ("days", 1),
    "HOUR": ("nanos", 3_600_000_000_000), "HOURS": ("nanos", 3_600_000_000_000),
    "MINUTE": ("nanos", 60_000_000_000), "MINUTES": ("nanos", 60_000_000_000),
    "SECOND": ("nanos", 1_000_000_000), "SECONDS": ("nanos", 1_000_000_000),
    "MILLISECOND": ("nanos", 1_000_000), "MILLISECONDS": ("nanos", 1_000_000),
    "MICROSECOND": ("nanos", 1_000), "MICROSECONDS": ("nanos", 1_000),
    "NANOSECOND": ("nanos", 1), "NANOSECONDS": ("nanos", 1),
}


def parse_interval(value: str, leading_unit: Optional[str]) -> ScalarValue:
    """Parse '3 month', '90' DAY, '1 year 2 months', '1:30' etc. into a
    (months, days, nanos) interval scalar."""
    parts: Dict[str, int] = {"months": 0, "days": 0, "nanos": 0}
    text = value.strip()
    if leading_unit:
        fld, factor = _INTERVAL_UNIT_FACTORS[leading_unit.upper()]
        parts[fld] += int(round(float(text) * factor))
        return ScalarValue.interval(**parts)
    toks = re.findall(r"([-+]?\d+\.?\d*)\s*([a-zA-Z]+)", text)
    if not toks:
        # bare number = seconds (reference: interval '5' -> 5 secs)
        try:
            parts["nanos"] = int(round(float(text) * 1_000_000_000))
            return ScalarValue.interval(**parts)
        except ValueError:
            raise PlanError(f"cannot parse interval literal '{value}'")
    for num, unit in toks:
        key = unit.upper()
        if key not in _INTERVAL_UNIT_FACTORS:
            raise PlanError(f"unknown interval unit '{unit}'")
        fld, factor = _INTERVAL_UNIT_FACTORS[key]
        parts[fld] += int(round(float(num) * factor))
    return ScalarValue.interval(**parts)


# --------------------------------------------------------------------------


class PlannerContext:
    """Scope state threaded through planning."""

    def __init__(self, outer: Optional["PlannerContext"] = None):
        self.ctes: Dict[str, LogicalPlan] = dict(outer.ctes) if outer else {}
        self.outer_schemas: List[Schema] = list(outer.outer_schemas) if outer else []
        self.outer_refs: List[Column] = []

    def child(self, current_schema: Schema) -> "PlannerContext":
        c = PlannerContext(self)
        c.outer_schemas = [current_schema] + self.outer_schemas
        return c


class SqlToRel:
    """Plans parsed statements against a context provider exposing
    ``get_table(name) -> TableProvider`` and ``get_table_function(name)``."""

    def __init__(self, provider):
        self.provider = provider

    # ==================================================================
    # entry points
    # ==================================================================
    def _session_tz(self) -> str:
        try:
            return str(self.provider.config.options.get(
                "datafusion.execution.time_zone"))
        except Exception:  # noqa: BLE001
            return "+00"

    def statement_to_plan(self, stmt: A.Statement) -> LogicalPlan:
        if isinstance(stmt, A.QueryStatement):
            return self.query_to_plan(stmt.query, PlannerContext())
        if isinstance(stmt, A.Explain):
            from ..expr.plan import Explain as LExplain
            inner = self.statement_to_plan(stmt.statement)
            return LExplain(inner, stmt.analyze, stmt.verbose,
                            format=stmt.format)
        raise NotImplementedError_(f"statement {type(stmt).__name__} is handled by SessionContext")

    # ==================================================================
    # queries
    # ==================================================================
    def query_to_plan(self, query: A.Query, ctx: PlannerContext) -> LogicalPlan:
        ctx = PlannerContext(ctx)  # CTE scope
        seen_ctes = set()
        for cte in query.ctes:
            key = cte.name.lower()
            if key in seen_ctes:
                raise PlanError(
                    f'WITH query name "{cte.name}" specified more than once')
            seen_ctes.add(key)
            if query.recursive and self._cte_is_recursive(cte):
                enabled = True
                try:
                    enabled = bool(self.provider.config.options.get(
                        "datafusion.execution.enable_recursive_ctes"))
                except Exception:  # noqa: BLE001 — provider without config
                    pass
                if not enabled:
                    raise NotImplementedError_(
                        "Recursive CTEs are not enabled")
                plan = self._plan_recursive_cte(cte, ctx)
            else:
                plan = self.query_to_plan(cte.query, ctx)
                if cte.column_aliases:
                    plan = self._apply_column_aliases(plan, cte.column_aliases)
            ctx.ctes[cte.name.lower()] = SubqueryAlias(plan, cte.name.lower())

        plan = self._set_expr_to_plan(query.body, ctx)

        # ORDER BY — resolved against output schema (aliases/ordinals) first,
        # then against the pre-projection input (adds hidden sort columns).
        if query.order_by:
            plan = self._plan_order_by(plan, query.order_by, ctx)

        skip = self._const_int(query.offset, ctx) if query.offset else 0
        fetch = self._const_int(query.limit, ctx) if query.limit is not None else None
        if fetch is not None or skip:
            plan = Limit(plan, skip or 0, fetch)
        return plan

    def _cte_is_recursive(self, cte: A.Cte) -> bool:
        found = [False]
        name = cte.name.lower()

        def walk(node):
            if isinstance(node, A.TableName) and node.parts[-1].lower() == name:
                found[0] = True
            for f in dataclasses.fields(node) if dataclasses.is_dataclass(node) else []:
                v = getattr(node, f.name)
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if dataclasses.is_dataclass(x) and isinstance(x, A.Node):
                        walk(x)
        walk(cte.query)
        return found[0]

    def _plan_recursive_cte(self, cte: A.Cte, ctx: PlannerContext) -> LogicalPlan:
        body = cte.query.body
        if not isinstance(body, A.SetOp) or body.op != "UNION":
            raise PlanError("recursive CTE must be UNION [ALL] of static and recursive terms")
        static_plan = self._set_expr_to_plan(body.left, ctx)
        if cte.column_aliases:
            static_plan = self._apply_column_aliases(static_plan, cte.column_aliases)
        # register the work-table relation for the recursive term
        from ..datasource.worktable import WorkTableProvider
        wt = WorkTableProvider(cte.name.lower(), static_plan.schema)
        rctx = PlannerContext(ctx)
        rctx.ctes[cte.name.lower()] = SubqueryAlias(
            TableScan(cte.name.lower(), wt), cte.name.lower())
        # the recursive term may reference the work table exactly once and
        # not from inside a nested recursive CTE (reference:
        # sql/src/query.rs recursive-CTE validation)
        refs = self._count_table_refs(body.right, cte.name.lower())
        if refs > 1:
            raise NotImplementedError_(
                "Multiple recursive references to the same CTE are "
                "not supported")
        rec_plan = self._set_expr_to_plan(body.right, rctx)
        if self._worktable_under_nested_recursion(body.right,
                                                  cte.name.lower()):
            raise NotImplementedError_(
                "Recursive CTE cannot be referenced from inside a nested "
                "recursive CTE")
        # column-count / type alignment with the anchor (reference:
        # coerce recursive term to the static term's schema)
        ss, rs = static_plan.schema, rec_plan.schema
        if len(ss) != len(rs):
            raise PlanError(
                "Non-recursive term and recursive term must have the same "
                f"number of columns ({len(ss)} != {len(rs)})")
        if any(a.dtype != b.dtype for a, b in zip(ss.fields, rs.fields)):
            exprs = []
            for a, b in zip(ss.fields, rs.fields):
                c = Column(b.name, b.qualifier)
                e = Cast(c, a.dtype) if a.dtype != b.dtype else c
                exprs.append(Alias(e, a.name))
            rec_plan = Projection(exprs, rec_plan)
        return RecursiveQuery(cte.name.lower(), static_plan, rec_plan,
                              is_distinct=not body.all)

    def _count_table_refs(self, node: A.Node, name: str) -> int:
        count = [0]

        def walk(n):
            if isinstance(n, A.TableName) and n.parts[-1].lower() == name:
                count[0] += 1
            for f in dataclasses.fields(n) if dataclasses.is_dataclass(n) else []:
                v = getattr(n, f.name)
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if dataclasses.is_dataclass(x) and isinstance(x, A.Node):
                        walk(x)
        walk(node)
        return count[0]

    def _worktable_under_nested_recursion(self, node: A.Node,
                                          name: str) -> bool:
        """True when a nested recursive WITH inside the recursive term
        references the outer work table (unsupported in the reference)."""
        hit = [False]

        def walk(n, inside_nested):
            if isinstance(n, A.Query) and n.recursive:
                inside_nested += 1
            if inside_nested and isinstance(n, A.TableName) and \
                    n.parts[-1].lower() == name:
                hit[0] = True
            for f in dataclasses.fields(n) if dataclasses.is_dataclass(n) else []:
                v = getattr(n, f.name)
                for x in (v if isinstance(v, (list, tuple)) else [v]):
                    if dataclasses.is_dataclass(x) and isinstance(x, A.Node):
                        walk(x, inside_nested)
        walk(node, 0)
        return hit[0]

    def _apply_column_aliases(self, plan: LogicalPlan, names: Sequence[str]) -> LogicalPlan:
        if len(names) > len(plan.schema):
            raise PlanError("more column aliases than columns")
        exprs = []
        for i, f in enumerate(plan.schema.fields):
            c = Column(f.name, f.qualifier)
            exprs.append(Alias(c, names[i].lower()) if i < len(names) else c)
        return Projection(exprs, plan)

    def _set_expr_to_plan(self, body: A.Node, ctx: PlannerContext) -> LogicalPlan:
        if isinstance(body, A.Select):
            return self.select_to_plan(body, ctx)
        if isinstance(body, A.Query):
            return self.query_to_plan(body, ctx)
        if isinstance(body, A.Values):
            return self._plan_values(body, ctx)
        if isinstance(body, A.SetOp):
            left = self._set_expr_to_plan(body.left, ctx)
            right = self._set_expr_to_plan(body.right, ctx)
            left, right = self._coerce_union_schemas(left, right)
            if body.op == "UNION":
                u = Union([left, right])
                return u if body.all else Distinct(u)
            if body.op == "INTERSECT":
                return Intersect(left, right, body.all)
            if body.op == "EXCEPT":
                return Except(left, right, body.all)
        raise NotImplementedError_(f"set expression {type(body).__name__}")

    def _coerce_union_schemas(self, left, right):
        ls, rs = left.schema, right.schema
        if len(ls) != len(rs):
            raise PlanError(f"UNION inputs have different column counts: {len(ls)} vs {len(rs)}")
        lexprs, rexprs = [], []
        need_l = need_r = False
        for lf, rf in zip(ls.fields, rs.fields):
            le: Expr = Column(lf.name, lf.qualifier)
            re_: Expr = Column(rf.name, rf.qualifier)
            if lf.dtype != rf.dtype:
                t = self._common_type(lf.dtype, rf.dtype)
                if t != lf.dtype:
                    le = Alias(Cast(le, t), lf.name)
                    need_l = True
                if t != rf.dtype:
                    need_r = True
                    re_ = Cast(re_, t)
            # union output uses left names
            if rf.name != lf.name:
                re_ = Alias(re_, lf.name)
                need_r = True
            lexprs.append(le)
            rexprs.append(re_)
        if need_l:
            left = Projection(lexprs, left)
        if need_r:
            right = Projection(rexprs, right)
        return left, right

    @staticmethod
    def _common_type(a: DataType, b: DataType) -> DataType:
        if a == b:
            return a
        if a.is_null:
            return b
        if b.is_null:
            return a
        from ..common.datatypes import TypeId
        if a.id == TypeId.LIST and b.id == TypeId.LIST:
            # unify element types (List(Null) defers to the other side)
            return dt.list_(SqlToRel._common_type(a.inner, b.inner))
        if a.is_numeric and b.is_numeric:
            return dt.common_numeric_type(a, b)
        if a.is_string or b.is_string:
            return dt.STRING
        return a

    def _plan_values(self, v: A.Values, ctx: PlannerContext) -> LogicalPlan:
        rows = [[self.expr_to_expr(e, Schema.empty(), ctx) for e in row] for row in v.rows]
        ncols = len(rows[0])
        for ri, row in enumerate(rows):
            if len(row) != ncols:
                raise PlanError(
                    "Inconsistent data length across values list: got "
                    f"{len(row)} values in row {ri} but expected {ncols}")
        empty = Schema.empty()
        fields = []
        for i in range(ncols):
            t = dt.NULL
            nullable = False
            for ri, row in enumerate(rows):
                rt = row[i].data_type(empty)
                nullable = nullable or row[i].nullable(empty)
                if not (t.is_null or rt.is_null) and \
                        (t.is_string != rt.is_string or
                         t.is_boolean != rt.is_boolean):
                    raise PlanError(
                        "Inconsistent data type across values list "
                        f"at row {ri} column {i}")
                t = self._common_type(t, rt)
            # reference VALUES columns are always nullable
            # (expr/logical_plan/builder.rs:223 Field::new(name, type, true))
            fields.append(Field(f"column{i+1}", t, True))
        return Values(rows, Schema(fields))

    # ==================================================================
    # SELECT
    # ==================================================================
    def select_to_plan(self, sel: A.Select, ctx: PlannerContext) -> LogicalPlan:
        # 0. resolve named WINDOW references (WINDOW w AS (...) ... OVER w)
        if sel.named_windows:
            def subst(node):
                if isinstance(node, A.Node):
                    for fld in getattr(node, "__dataclass_fields__", {}):
                        subst(getattr(node, fld))
                    if isinstance(node, A.FunctionCall) and node.over is not None \
                            and hasattr(node.over, "name_ref"):
                        ref = node.over.name_ref.lower()
                        spec = {k.lower(): v
                                for k, v in sel.named_windows.items()}.get(ref)
                        if spec is None:
                            raise PlanError(f"window '{ref}' is not defined")
                        node.over = spec
                elif isinstance(node, (list, tuple)):
                    for x in node:
                        subst(x)
            for item in sel.projection:
                subst(item.expr)
            subst(sel.qualify)
        # 1. FROM
        if sel.from_ is None:
            plan: LogicalPlan = EmptyRelation(produce_one_row=True)
        else:
            plan = self.plan_table_ref(sel.from_, ctx)
        schema = plan.schema

        # 2. WHERE
        if sel.where is not None:
            pred = self.expr_to_expr(sel.where, schema, ctx)
            plan = Filter(pred, plan)

        # 3. projection expansion
        ctx.using_hidden = _using_duplicates(plan)  # USING right-side dups
        select_exprs: List[Expr] = []
        for item in sel.projection:
            if isinstance(item.expr, A.Wildcard):
                w = item.expr
                if not sel.from_ and not schema.fields:
                    # reference: expand_wildcard errors without a relation
                    raise PlanError(
                        "SELECT * with no tables specified is not valid")
                # reference (sql/src/expr/mod.rs expand_wildcard): EXCLUDE /
                # EXCEPT names must exist and must not repeat
                seen_exc = set()
                for c in w.except_cols:
                    if c in seen_exc:
                        raise PlanError(f"EXCLUDE/EXCEPT contains duplicate column name '{c}'")
                    seen_exc.add(c)
                    if not any(f.name == c for f in schema.fields):
                        raise PlanError(f"EXCLUDE/EXCEPT column '{c}' does not exist")
                hide = ctx.using_hidden if not w.qualifier else set()
                if w.qualifier and not any(
                        (f.qualifier or "").lower() == w.qualifier.lower()
                        for f in schema.fields):
                    # reference: `unknown.*` is a planning error
                    raise PlanError(
                        f"Invalid qualifier {w.qualifier}")
                repl = {c: e for c, e in w.replace_cols}
                for c in repl:
                    if not any(f.name == c for f in schema.fields):
                        raise PlanError(
                            f"REPLACE column '{c}' does not exist")
                for f in schema.fields:
                    if w.qualifier and (f.qualifier or "").lower() != w.qualifier.lower():
                        continue
                    if f.name in w.except_cols:
                        continue
                    if (f.qualifier, f.name) in hide:
                        continue
                    if f.name in repl:
                        # * REPLACE (expr AS col): substitute, keep position
                        # (reference: expand_wildcard w/ ReplaceSelectItem)
                        e = self.expr_to_expr(repl[f.name], schema, ctx)
                        select_exprs.append(Alias(e, f.name))
                        continue
                    select_exprs.append(Column(f.name, f.qualifier))
            else:
                e = self.expr_to_expr(item.expr, schema, ctx)
                if item.alias:
                    e = Alias(e, item.alias.lower())
                select_exprs.append(e)

        # 3b. SELECT-list UNNEST (reference: sql/src/select.rs
        # try_process_unnest): each top-level unnest(arg) becomes a computed
        # placeholder column fed through an Unnest node, then a plain column
        # reference in the projection
        unnest_items: List[Tuple[str, Expr]] = []
        rewritten: List[Expr] = []
        for e in select_exprs:
            alias, inner = None, e
            if isinstance(inner, Alias):
                alias, inner = inner.name, inner.expr
            if isinstance(inner, ScalarFunction) and inner.name == "unnest" \
                    and len(inner.args) == 1:
                ph = f"__unnest_placeholder_{len(unnest_items)}"
                unnest_items.append((ph, inner.args[0]))
                rewritten.append(Alias(Column(ph, None),
                                       alias or f"unnest({inner.args[0]})"))
            else:
                rewritten.append(e)
        if unnest_items:
            base = [Column(f.name, f.qualifier) for f in schema.fields]
            from ..expr import Unnest as LUnnest
            plan = Projection(
                base + [Alias(arg, ph) for ph, arg in unnest_items], plan)
            for ph, _ in unnest_items:
                plan = LUnnest(plan, Column(ph, None))
            schema = plan.schema
            select_exprs = rewritten

        # 4. aggregates
        having_expr = self.expr_to_expr(sel.having, schema, ctx,
                                        select_exprs=select_exprs) if sel.having is not None else None
        # QUALIFY (reference: sql/src/select.rs select_to_plan qualify
        # handling): planned like HAVING — may reference select aliases,
        # aggregates, and window functions — and applied as a Filter after
        # the Window stage.
        qualify_expr = self.expr_to_expr(sel.qualify, schema, ctx,
                                         select_exprs=select_exprs) if sel.qualify is not None else None
        group_exprs = self._plan_group_by(sel.group_by, schema, select_exprs, ctx) \
            if sel.group_by is not None else []
        aggr_exprs = find_aggregate_exprs(
            select_exprs + ([having_expr] if having_expr is not None else [])
            + ([qualify_expr] if qualify_expr is not None else []))
        if group_exprs and not any(isinstance(g, GroupingSet) for g in group_exprs):
            # functional dependence (reference:
            # common/src/functional_dependencies.rs): columns determined by
            # the grouped key set are carried as extra group keys
            # (cardinality is unchanged within each group)
            grouped_idx = set()
            grouped_names = set()
            for g in group_exprs:
                c = g.expr if isinstance(g, Alias) else g
                if isinstance(c, Column):
                    i = schema.maybe_index_of(c.name, c.qualifier)
                    if i is not None:
                        grouped_idx.add(i)
                        f = schema.field(i)
                        grouped_names.add((f.qualifier, f.name))
            fds = plan.functional_deps()
            determined = set(grouped_idx)
            changed = True
            while changed:     # transitive closure over dependencies
                changed = False
                for src, tgt in fds:
                    if src and src <= determined and not tgt <= determined:
                        determined |= tgt
                        changed = True
            if determined > grouped_idx:
                refs = []
                for e in select_exprs + ([having_expr] if having_expr is not None else []):
                    refs.extend(c for c in e.collect(
                        lambda x: isinstance(x, Column)))
                for c in refs:
                    i = schema.maybe_index_of(c.name, c.qualifier)
                    if i is None or i not in determined:
                        continue
                    f = schema.field(i)
                    if (f.qualifier, f.name) not in grouped_names:
                        group_exprs.append(Column(f.name, f.qualifier))
                        grouped_names.add((f.qualifier, f.name))
                        grouped_idx.add(i)
        if group_exprs or aggr_exprs:
            plan = Aggregate(group_exprs, aggr_exprs, plan)
            agg_schema = plan.schema
            out_groups = plan.output_group_exprs() if isinstance(plan, Aggregate) else group_exprs
            select_exprs = [self._rewrite_post_aggregate(e, out_groups, aggr_exprs, agg_schema)
                            for e in select_exprs]
            if having_expr is not None:
                having_expr = self._rewrite_post_aggregate(
                    having_expr, out_groups, aggr_exprs, agg_schema)
                plan = Filter(having_expr, plan)
            if qualify_expr is not None:
                qualify_expr = self._rewrite_post_aggregate(
                    qualify_expr, out_groups, aggr_exprs, agg_schema)
        elif having_expr is not None:
            raise PlanError("HAVING requires GROUP BY or aggregates")

        # 5. window functions (QUALIFY's window exprs are planned into the
        # same Window node; the qualify Filter runs after the window stage)
        window_exprs = find_window_exprs(
            select_exprs + ([qualify_expr] if qualify_expr is not None else []))
        if window_exprs:
            plan = Window(window_exprs, plan)
            wschema = plan.schema
            select_exprs = [self._rewrite_window(e, window_exprs, wschema)
                            for e in select_exprs]
            if qualify_expr is not None:
                qualify_expr = self._rewrite_window(
                    qualify_expr, window_exprs, wschema)
        if qualify_expr is not None:
            plan = Filter(qualify_expr, plan)

        # 6. projection
        proj = Projection(select_exprs, plan)

        # 7. DISTINCT
        if sel.distinct_on:
            on_exprs = [self.expr_to_expr(e, plan.schema, ctx) for e in sel.distinct_on]
            return Distinct(plan, on_exprs=on_exprs, select_exprs=select_exprs)
        if sel.distinct:
            return Distinct(proj)
        return proj

    def _plan_group_by(self, gb: A.GroupBy, schema: Schema,
                       select_exprs: List[Expr], ctx: PlannerContext) -> List[Expr]:
        def plan_one(e: A.Node) -> Expr:
            # ordinal
            if isinstance(e, A.NumberLit) and "." not in e.text and "e" not in e.text.lower():
                idx = int(e.text)
                if not (1 <= idx <= len(select_exprs)):
                    raise PlanError(f"GROUP BY position {idx} is out of range")
                se = select_exprs[idx - 1]
                return se.expr if isinstance(se, Alias) else se
            # alias of a select item
            if isinstance(e, A.Identifier) and len(e.parts) == 1:
                name = e.parts[0].lower()
                if not schema.has(name):
                    for se in select_exprs:
                        if isinstance(se, Alias) and se.name == name:
                            return se.expr
            return self.expr_to_expr(e, schema, ctx)

        if gb.grouping_sets is not None:
            sets = tuple(tuple(plan_one(e) for e in s) for s in gb.grouping_sets)
            return [GroupingSet(sets)]
        if gb.rollup is not None:
            exprs = [plan_one(e) for e in gb.rollup]
            sets = tuple(tuple(exprs[:i]) for i in range(0, len(exprs) + 1))
            return [GroupingSet(sets)]
        if gb.cube is not None:
            exprs = [plan_one(e) for e in gb.cube]
            sets = []
            for mask in range(1 << len(exprs)):
                sets.append(tuple(e for i, e in enumerate(exprs) if mask & (1 << i)))
            return [GroupingSet(tuple(reversed(sets)))]
        if gb.all_:
            # GROUP BY ALL: every select item without an aggregate groups
            # (reference: sql/src/select.rs group-by-all resolution)
            out = []
            for se in select_exprs:
                inner = se.expr if isinstance(se, Alias) else se
                if not find_aggregate_exprs([inner]):
                    out.append(inner)
            return out
        # duplicate group expressions collapse to one key
        # (GROUP BY c, c is legal SQL)
        out = []
        for e in gb.exprs:
            p = plan_one(e)
            if not any(p == q for q in out):
                out.append(p)
        return out

    def _rewrite_post_aggregate(self, e: Expr, group_exprs: List[Expr],
                                aggr_exprs: List[Expr], agg_schema: Schema) -> Expr:
        n_group = len(group_exprs)

        def rw(node: Expr):
            for i, g in enumerate(group_exprs):
                target = g.expr if isinstance(g, Alias) else g
                if node == g or node == target:
                    f = agg_schema.fields[i]
                    return Column(f.name, f.qualifier)
            for j, a in enumerate(aggr_exprs):
                if node == a:
                    f = agg_schema.fields[n_group + j]
                    return Column(f.name, f.qualifier)
            return None

        return e.transform_down(rw)

    def _rewrite_window(self, e: Expr, window_exprs: List[Expr], wschema: Schema) -> Expr:
        base = len(wschema) - len(window_exprs)

        def rw(node: Expr):
            for j, w in enumerate(window_exprs):
                if node == w:
                    f = wschema.fields[base + j]
                    return Column(f.name, f.qualifier)
            return None

        return e.transform_down(rw)

    # ==================================================================
    # ORDER BY
    # ==================================================================
    def _plan_order_by(self, plan: LogicalPlan, items: List[A.OrderByItem],
                       ctx: PlannerContext) -> LogicalPlan:
        if isinstance(plan, Distinct) and plan.on_exprs is not None:
            # DISTINCT ON (exprs) ... ORDER BY: the sort picks which row
            # survives per key; the ON exprs must be the initial ORDER BY
            # prefix, and the output stays ordered by that prefix
            # (reference: optimizer/src/replace_distinct_aggregate.rs +
            # sql/src/select.rs DistinctOn sort_expr wiring)
            inner_schema = plan.input.schema
            on_sort: List[SortExpr] = []
            for it in items:
                e = self.expr_to_expr(it.expr, inner_schema, ctx)
                nf = it.nulls_first if it.nulls_first is not None \
                    else (not it.asc)
                on_sort.append(SortExpr(e, it.asc, nf))
            n = len(plan.on_exprs)
            if [str(s.expr) for s in on_sort[:n]] != \
                    [str(e) for e in plan.on_exprs]:
                raise PlanError(
                    "SELECT DISTINCT ON expressions must match initial "
                    "ORDER BY expressions")
            return Distinct(plan.input, plan.on_exprs, plan.select_exprs,
                            on_sort)
        schema = plan.schema
        # Window into the projection beneath (for expressions over
        # pre-projection columns, e.g. ORDER BY sum(x) with aliases).
        proj = plan if isinstance(plan, Projection) else None
        sort_exprs: List[SortExpr] = []
        extra_exprs: List[Expr] = []
        for it in items:
            e: Optional[Expr] = None
            if isinstance(it.expr, A.NumberLit) and "." not in it.expr.text:
                idx = int(it.expr.text)
                if not (1 <= idx <= len(schema)):
                    raise PlanError(f"ORDER BY position {idx} is out of range")
                f = schema.fields[idx - 1]
                e = Column(f.name, f.qualifier)
            else:
                try:
                    e = self.expr_to_expr(it.expr, schema, ctx)
                except PlanError:
                    e = None
                if e is None and isinstance(plan, Distinct) and \
                        plan.on_exprs is None and \
                        isinstance(plan.input, Projection):
                    # SELECT DISTINCT ... ORDER BY <original expr of an
                    # aliased select item> resolves to the output column;
                    # anything else must appear in the select list
                    # (reference: sql/src/select.rs order_by over DISTINCT)
                    dproj = plan.input
                    inner = self.expr_to_expr(it.expr, dproj.input.schema,
                                              ctx)
                    for i, se in enumerate(dproj.exprs):
                        base = se.expr if isinstance(se, Alias) else se
                        if str(base) == str(inner):
                            f = schema.fields[i]
                            e = Column(f.name, f.qualifier)
                            break
                    if e is None:
                        raise PlanError(
                            "For SELECT DISTINCT, ORDER BY expressions "
                            f"{inner} must appear in select list")
                if e is not None and find_aggregate_exprs([e]):
                    # ORDER BY <aggregate expr>: rewrite to the matching
                    # aggregate output column (ORDER BY count(*) DESC)
                    agg_node = plan
                    while isinstance(agg_node, (Projection, Filter)):
                        agg_node = agg_node.input
                    if isinstance(agg_node, Aggregate):
                        e = self._rewrite_post_aggregate(
                            e, agg_node.group_exprs, agg_node.aggr_exprs,
                            agg_node.schema)
                    if find_aggregate_exprs([e]):
                        raise PlanError(
                            f"ORDER BY aggregate {e} not in select list")
                if e is None and proj is not None:
                    # ORDER BY sum(x) where x only exists below the
                    # aggregate: plan against the aggregate's input and map
                    # to the matching aggregate output column
                    agg_node = proj.input
                    while isinstance(agg_node, (Projection, Filter)):
                        agg_node = agg_node.input
                    if isinstance(agg_node, Aggregate):
                        try:
                            deep = self.expr_to_expr(
                                it.expr, agg_node.input.schema, ctx)
                            cand = self._rewrite_post_aggregate(
                                deep, agg_node.group_exprs,
                                agg_node.aggr_exprs, agg_node.schema)
                            if not find_aggregate_exprs([cand]) and all(
                                    schema.has(c.name, c.qualifier)
                                    for c in cand.collect(
                                        lambda x: isinstance(x, Column))):
                                e = cand
                        except PlanError:
                            pass
                if e is None and proj is not None:
                    # plan against pre-projection input; add hidden column
                    inner = self.expr_to_expr(it.expr, proj.input.schema, ctx)
                    aggs = find_aggregate_exprs([inner])
                    if aggs:
                        raise PlanError(
                            f"ORDER BY aggregate {inner} not in select list")
                    name = f"__sort_{len(extra_exprs)}"
                    extra_exprs.append(Alias(inner, name))
                    e = Column(name)
                elif e is None:
                    raise PlanError(f"cannot resolve ORDER BY expression {it.expr}")
            nulls_first = it.nulls_first if it.nulls_first is not None else (not it.asc)
            sort_exprs.append(SortExpr(e, it.asc, nulls_first))
        if extra_exprs:
            widened = Projection(proj.exprs + extra_exprs, proj.input)
            sorted_plan = Sort(sort_exprs, widened)
            keep = [Column(f.name, f.qualifier)
                    for f in widened.schema.fields[:len(proj.exprs)]]
            return Projection(keep, sorted_plan)
        return Sort(sort_exprs, plan)

    # ==================================================================
    # FROM clause
    # ==================================================================
    def plan_table_ref(self, ref: A.TableRef, ctx: PlannerContext) -> LogicalPlan:
        if isinstance(ref, A.TableName):
            name = ".".join(ref.parts).lower()
            short = ref.parts[-1].lower()
            if short in ctx.ctes and len(ref.parts) == 1:
                plan = ctx.ctes[short]
            else:
                provider = self.provider.get_table(name)
                if provider is None:
                    raise PlanError(f"table '{name}' not found")
                if hasattr(provider, "logical_plan") and provider.logical_plan() is not None:
                    # view
                    plan = SubqueryAlias(provider.logical_plan(), short)
                else:
                    plan = TableScan(short, provider)
            if ref.alias:
                plan = SubqueryAlias(plan, ref.alias.lower())
                if ref.column_aliases:
                    plan = self._apply_column_aliases(plan, ref.column_aliases)
            return plan
        if isinstance(ref, A.AliasedTable):
            plan = self.plan_table_ref(ref.inner, ctx)
            plan = SubqueryAlias(plan, ref.alias.lower())
            if ref.col_aliases:
                plan = self._apply_column_aliases(plan, ref.col_aliases)
            return plan
        if isinstance(ref, A.SubqueryRef):
            sub_ctx = ctx if not ref.lateral else ctx  # lateral unsupported: same scope
            plan = self.query_to_plan(ref.query, sub_ctx)
            if ref.column_aliases:
                plan = self._apply_column_aliases(plan, ref.column_aliases)
            if ref.alias:
                return SubqueryAlias(plan, ref.alias.lower())
            # the reference leaves an unaliased derived table unqualified
            # (sql/src/relation/mod.rs Derived w/ alias=None), so generated
            # names like "a + Int64(1)" stay referencable from the outer query
            return plan
        if isinstance(ref, A.TableFunctionRef) and ref.name.lower() == "unnest" \
                and self.provider.get_table_function("unnest") is None:
            # FROM unnest([...]) — a one-column relation of the array's
            # elements (reference: sql/src/relation/mod.rs create_relation)
            if len(ref.args) != 1:
                raise PlanError("unnest() table function takes one argument")
            arg = self.expr_to_expr(ref.args[0], Schema.empty(), ctx)
            from ..expr import Unnest as LUnnest
            plan = Projection([Alias(arg, "unnest")],
                              EmptyRelation(produce_one_row=True))
            plan = LUnnest(plan, Column("unnest", None))
            plan = SubqueryAlias(plan, (ref.alias or "unnest").lower())
            if ref.column_aliases:
                plan = self._apply_column_aliases(plan, ref.column_aliases)
            return plan
        if isinstance(ref, A.TableFunctionRef) \
                and ref.name.lower() in ("generate_series", "range") \
                and self.provider.get_table_function(ref.name.lower()) is None:
            # FROM generate_series(a, b[, step]) -> one "value" column
            # (reference: functions-table/src/generate_series.rs)
            args = [self.expr_to_expr(a, Schema.empty(), ctx) for a in ref.args]
            from ..expr import Unnest as LUnnest
            series = ScalarFunction(ref.name.lower(), tuple(args))
            plan = Projection([Alias(series, "value")],
                              EmptyRelation(produce_one_row=True))
            plan = LUnnest(plan, Column("value", None))
            plan = SubqueryAlias(plan, (ref.alias or ref.name).lower())
            if ref.column_aliases:
                plan = self._apply_column_aliases(plan, ref.column_aliases)
            return plan
        if isinstance(ref, A.TableFunctionRef):
            fn = self.provider.get_table_function(ref.name.lower())
            if fn is None:
                raise PlanError(f"table function '{ref.name}' not found")
            args = [self.expr_to_expr(a, Schema.empty(), ctx) for a in ref.args]
            provider = fn(args)
            plan = TableScan(ref.alias or ref.name.lower(), provider)
            return plan
        if isinstance(ref, A.Join):
            return self._plan_join(ref, ctx)
        raise NotImplementedError_(f"table ref {type(ref).__name__}")

    def _plan_join(self, j: A.Join, ctx: PlannerContext) -> LogicalPlan:
        left = self.plan_table_ref(j.left, ctx)
        right = self.plan_table_ref(j.right, ctx)
        if j.kind == "CROSS":
            return CrossJoin(left, right)
        combined = left.schema.merge(right.schema)
        if j.natural:
            common = [f.name for f in left.schema.fields
                      if right.schema.has(f.name)]
            return self._plan_using_join(left, right, j.kind, common)
        if j.using:
            return self._plan_using_join(left, right, j.kind, list(j.using))
        on_expr = self.expr_to_expr(j.on, combined, ctx) if j.on is not None else None
        # keep the raw predicate as join filter; the optimizer extracts
        # equijoin pairs (reference: ExtractEquijoinPredicate)
        return Join(left, right, on=[], filter=on_expr, join_type=j.kind)

    def _plan_using_join(self, left, right, kind, cols: List[str]) -> LogicalPlan:
        on = []
        for c in cols:
            lf = left.schema.field_by_name(c)
            rf = right.schema.field_by_name(c)
            on.append((Column(lf.name, lf.qualifier), Column(rf.name, rf.qualifier)))
        # both sides stay addressable (t1.c2 AND t2.c2); wildcard
        # expansion hides the right-side duplicate (reference:
        # expand_wildcard + LogicalPlan::using_columns, sql/src/expr/mod.rs)
        return Join(left, right, on=on, filter=None, join_type=kind,
                    using_columns=tuple(cols))

    # ==================================================================
    # expressions
    # ==================================================================
    def expr_to_expr(self, e: A.Node, schema: Schema, ctx: PlannerContext,
                     select_exprs: Optional[List[Expr]] = None) -> Expr:
        E = lambda x: self.expr_to_expr(x, schema, ctx, select_exprs)  # noqa: E731

        if isinstance(e, A.Identifier):
            return self._resolve_ident(e.parts, schema, ctx, select_exprs)
        if isinstance(e, A.NumberLit):
            return self._plan_number(e.text)
        if isinstance(e, A.StringLit):
            return Literal(ScalarValue.string(e.value))
        if isinstance(e, A.BoolLit):
            return Literal(ScalarValue.boolean(e.value))
        if isinstance(e, A.NullLit):
            return Literal(ScalarValue.null())
        if isinstance(e, A.Param):
            return Placeholder(e.index)
        if isinstance(e, A.Variable):
            # @var / @@sysvar via registered VarProviders
            get = getattr(self.provider, "get_variable", None)
            if get is None:
                raise PlanError(f"no variable provider for '{e.name}'")
            return Literal(get(e.name))
        if isinstance(e, A.TypedString):
            if e.type_name == "BINARYHEX":
                # X'616263' hex byte-string literal
                raw = e.value.strip()
                if len(raw) % 2:
                    raw = "0" + raw
                return Literal(ScalarValue(dt.BINARY, bytes.fromhex(raw)))
            if e.type_name == "DATE":
                return Literal(ScalarValue.date(_dt.date.fromisoformat(e.value.strip())))
            if e.type_name == "TIMESTAMP":
                # exact nanosecond parse (fromisoformat truncates to
                # microseconds and rejects 9-digit fractions)
                from ..functions.datetime_helpers import parse_timestamp_ns
                return Literal(ScalarValue(dt.timestamp("ns"),
                                           parse_timestamp_ns(e.value)))
            if e.type_name == "TIMESTAMPTZ":
                # naive wall time reads in the session zone; explicit
                # offsets convert; stored as a UTC instant typed with the
                # session zone (reference: TIMESTAMPTZ literals +
                # execution.time_zone)
                from ..functions.tz_util import wall_to_utc_ns_scalar
                tzname = self._session_tz()
                raw = e.value.strip().replace("Z", "+00:00")
                zone = None
                parts = raw.rsplit(" ", 1)
                if len(parts) == 2 and (parts[1].isalpha()
                                        or "/" in parts[1]):
                    # trailing zone name ('... America/Los_Angeles'):
                    # the wall time reads in THAT zone; only full names
                    # and GMT/UTC are accepted (abbreviations error)
                    raw, zone = parts
                    if zone.upper() in ("GMT", "UTC"):
                        zone = "+00"
                    elif "/" in zone:
                        from zoneinfo import ZoneInfo
                        ZoneInfo(zone)   # raises for unknown names
                    else:
                        raise PlanError(
                            f"Invalid timezone abbreviation {zone!r}")
                v = _dt.datetime.fromisoformat(raw)
                if v.tzinfo is not None:
                    off = v.utcoffset()
                    if abs(off.total_seconds()) > 14 * 3600:
                        raise PlanError(
                            f"timezone offset out of range: {e.value!r}")
                if v.tzinfo is None:
                    ns = wall_to_utc_ns_scalar(v, zone or tzname)
                else:
                    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
                    td = v - epoch
                    ns = ((td.days * 86_400 + td.seconds) * 10**9
                          + td.microseconds * 1000)
                return Literal(ScalarValue(dt.timestamp("ns", tz=tzname), ns))
            if e.type_name == "TIME":
                from ..functions.datetime_helpers import parse_time_ns
                return Literal(ScalarValue(dt.TIME,
                                           parse_time_ns(e.value.strip())))
        if isinstance(e, A.IntervalLit):
            return Literal(parse_interval(e.value, e.leading_unit))
        if isinstance(e, A.BinaryOp):
            return BinaryExpr(E(e.left), op_from_sql(e.op), E(e.right))
        if isinstance(e, A.UnaryOp):
            if e.op == "NOT":
                inner = E(e.operand)
                ity = inner.data_type(schema)
                if not (ity == dt.BOOL or ity.is_null):
                    # reference: NOT requires boolean/NULL operand
                    # (expr/src/expr_fn.rs + type checks in simplifier)
                    raise PlanError(
                        f"NOT '{inner}' can't be evaluated because the "
                        f"expression's type is {ity}, not boolean or NULL")
                return Not(inner)
            if e.op == "-":
                inner = E(e.operand)
                if isinstance(inner, Literal) and inner.value.value is not None \
                        and inner.value.dtype.is_numeric:
                    sv = inner.value
                    ty = sv.dtype
                    if ty == dt.UINT64 and -sv.value >= -(2**63):
                        # -9223372036854775808: the magnitude parses as
                        # UInt64 but the negation is a valid Int64
                        ty = dt.INT64
                    return Literal(ScalarValue(ty, -sv.value))
                return Negative(inner)
            return E(e.operand)
        if isinstance(e, A.IsNull):
            return IsNull(E(e.operand), e.negated)
        if isinstance(e, A.IsBool):
            return IsBool(E(e.operand), e.value, e.negated)
        if isinstance(e, A.IsDistinctFrom):
            op = Op.IS_NOT_DISTINCT_FROM if e.negated else Op.IS_DISTINCT_FROM
            return BinaryExpr(E(e.left), op, E(e.right))
        if isinstance(e, A.Between):
            return Between(E(e.operand), E(e.low), E(e.high), e.negated)
        if isinstance(e, A.InList):
            return InList(E(e.operand), tuple(E(i) for i in e.items), e.negated)
        if isinstance(e, A.InSubquery):
            sub, refs = self._plan_subquery(e.query, schema, ctx)
            return InSubquery(E(e.operand), sub, e.negated, refs)
        if isinstance(e, A.Exists):
            sub, refs = self._plan_subquery(e.query, schema, ctx)
            return Exists(sub, e.negated, refs)
        if isinstance(e, A.ScalarSubquery):
            sub, refs = self._plan_subquery(e.query, schema, ctx)
            return ScalarSubquery(sub, refs)
        if isinstance(e, A.Like):
            return Like(E(e.operand), E(e.pattern), e.negated,
                        e.case_insensitive, e.escape)
        if isinstance(e, A.SimilarTo):
            return SimilarTo(E(e.operand), E(e.pattern), e.negated)
        if isinstance(e, A.Cast):
            inner = E(e.operand)
            cfg = getattr(getattr(self.provider, "config", None),
                          "options", None)
            to = sql_type_to_datatype(e.type_name, e.type_args, cfg)
            # SQL CAST(int AS TIMESTAMP) interprets the integer as epoch
            # SECONDS (reference: datafusion integer->timestamp cast rule;
            # arrow_cast keeps raw-unit semantics) — go through Timestamp(s)
            if to.id == dt.TypeId.TIMESTAMP and to.unit != "s":
                try:
                    src = inner.data_type(schema)
                except Exception:  # noqa: BLE001
                    src = None
                if src is not None and src.is_integer:
                    # floats cast directly: the columnar float->timestamp
                    # kernel scales seconds to the target unit, keeping
                    # fractional seconds (cast(1.1 as timestamp) = ...T00:00:01.100)
                    inner = Cast(inner, dt.timestamp("s"), safe=e.safe)
            return Cast(inner, to, safe=e.safe)
        if isinstance(e, A.Case):
            operand = E(e.operand) if e.operand is not None else None
            whens = tuple((E(w), E(t)) for w, t in e.whens)
            else_ = E(e.else_) if e.else_ is not None else None
            return Case(operand, whens, else_)
        if isinstance(e, A.Extract):
            return ScalarFunction("date_part",
                                  (lit(e.field.lower()), E(e.operand)))
        if isinstance(e, A.Substring):
            args = [E(e.operand)]
            args.append(E(e.start) if e.start is not None else lit(1))
            if e.length is not None:
                args.append(E(e.length))
            return ScalarFunction("substr", tuple(args))
        if isinstance(e, A.Trim):
            fn = {"BOTH": "btrim", "LEADING": "ltrim", "TRAILING": "rtrim"}[e.where]
            args = [E(e.operand)]
            if e.chars is not None:
                args.append(E(e.chars))
            return ScalarFunction(fn, tuple(args))
        if isinstance(e, A.Position):
            return ScalarFunction("strpos", (E(e.string), E(e.substr)))
        if isinstance(e, A.FunctionCall):
            return self._plan_function(e, schema, ctx, select_exprs)
        if isinstance(e, A.Tuple_):
            raise NotImplementedError_("row/tuple expressions")
        if isinstance(e, A.ArrayLit):
            return ScalarFunction("make_array", tuple(E(x) for x in e.items)) \
                if hasattr(e, "items") else ScalarFunction(
                    "make_array", tuple(E(x) for x in e.elements))
        if isinstance(e, A.ArrayIndex):
            base = E(e.operand) if hasattr(e, "operand") else E(e.base)
            idx = e.index
            iexpr = E(idx)
            # struct['field'] -> get_field; list[i] -> array_element
            # (reference: sql/src/expr/mod.rs get-indexed-field planning)
            if isinstance(idx, A.StringLit):
                return ScalarFunction("get_field", (base, iexpr))
            return ScalarFunction("array_element", (base, iexpr))
        if isinstance(e, A.Wildcard):
            raise PlanError("wildcard not allowed here")
        raise NotImplementedError_(f"expression {type(e).__name__}")

    def _plan_number(self, text: str) -> Literal:
        low = text.lower()
        if "e" in low:
            return Literal(ScalarValue.float64(float(text)))
        if "." in text:
            # reference default: float literals are Float64 unless
            # datafusion.sql_parser.parse_float_as_decimal is set
            # (sql/src/expr/value.rs parse_sql_number, config.rs:198)
            as_decimal = False
            try:
                as_decimal = bool(self.provider.config.options.get(
                    "datafusion.sql_parser.parse_float_as_decimal"))
            except Exception:  # noqa: BLE001 — provider without config
                pass
            if as_decimal:
                return Literal(ScalarValue.decimal_from_str(text))
            return Literal(ScalarValue.float64(float(text)))
        v = int(text)
        if v > 2**63 - 1:
            # the reference types an oversized integer literal as UInt64
            # (sql/src/expr/value.rs parse_sql_number)
            return Literal(ScalarValue(dt.UINT64, v))
        return Literal(ScalarValue.int64(v))

    def _resolve_ident(self, parts: List[str], schema: Schema,
                       ctx: PlannerContext,
                       select_exprs: Optional[List[Expr]] = None) -> Expr:
        name = parts[-1]
        qualifier = ".".join(parts[:-1]) if len(parts) > 1 else None
        if schema.has(name, qualifier):
            try:
                idx = schema.index_of(name, qualifier)
            except SchemaError:
                # a USING join keeps both copies addressable; the bare name
                # resolves to the surviving (left) copy (reference:
                # sql/src/expr/identifier.rs + using_columns)
                hidden = getattr(ctx, "using_hidden", None) or set()
                cands = [f for f in schema.fields
                         if f.name == name and (f.qualifier, f.name) not in hidden]
                if len(cands) != 1:
                    raise
                return Column(cands[0].name, cands[0].qualifier)
            f = schema.fields[idx]
            return Column(f.name, f.qualifier)
        # schema/catalog-qualified column (information_schema.tables.col):
        # the reference resolves by TableReference suffix match
        # (sql/src/expr/identifier.rs); try shorter qualifier suffixes
        if qualifier is not None and len(parts) > 2:
            for k in range(1, len(parts) - 1):
                q2 = ".".join(parts[k:-1])
                if schema.has(name, q2):
                    f = schema.fields[schema.index_of(name, q2)]
                    return Column(f.name, f.qualifier)
        # outer scopes (correlated subquery)
        for outer in ctx.outer_schemas:
            if outer.has(name, qualifier):
                f = outer.fields[outer.index_of(name, qualifier)]
                c = Column(f.name, f.qualifier)
                ctx.outer_refs.append(c)
                return OuterRef(c, f.dtype)
        # select-list alias (HAVING can reference aliases)
        if select_exprs and qualifier is None:
            for se in select_exprs:
                if isinstance(se, Alias) and se.name == name:
                    return se.expr
        # struct field access by CompoundIdentifier: some_struct.c0
        # (reference: sql/src/expr/identifier.rs — longest column-name
        # prefix wins, remainder becomes get_field chain)
        for split in range(len(parts) - 1, 0, -1):
            head, tail = parts[:split], parts[split:]
            hq = ".".join(head[:-1]) if len(head) > 1 else None
            if schema.has(head[-1], hq):
                f = schema.fields[schema.index_of(head[-1], hq)]
                if f.dtype.fields:
                    ex: Expr = Column(f.name, f.qualifier)
                    for part in tail:
                        ex = ScalarFunction("get_field", (ex, lit(part)))
                    return ex
        raise PlanError(
            f"No field named '{'.'.join(parts)}'. Valid fields: "
            + ", ".join(f.qualified_name() for f in schema.fields))

    def _plan_subquery(self, q: A.Query, schema: Schema, ctx: PlannerContext):
        sub_ctx = ctx.child(schema)
        plan = self.query_to_plan(q, sub_ctx)
        return plan, tuple(sub_ctx.outer_refs)

    def _plan_function(self, f: A.FunctionCall, schema: Schema,
                       ctx: PlannerContext,
                       select_exprs: Optional[List[Expr]] = None) -> Expr:
        # The parser lowercases unquoted names and keeps quoted names
        # verbatim, so "SQRT"(x) must NOT resolve to sqrt (reference:
        # quoted identifiers are case-sensitive — sql/src/planner.rs
        # identifier normalization); an unknown quoted name errors below.
        name = f.name
        E = lambda x: self.expr_to_expr(x, schema, ctx, select_exprs)  # noqa: E731

        if name == "arrow_cast" and len(f.args) == 2:
            # arrow_cast(expr, 'Utf8') — second arg is an arrow type name
            # literal (reference: functions/src/core/arrow_cast.rs)
            tname = f.args[1]
            if isinstance(tname, A.StringLit):
                return Cast(E(f.args[0]), arrow_type_name_to_datatype(tname.value))
            raise PlanError("arrow_cast requires a string literal type name")

        args = tuple(E(a) for a in f.args)

        if f.over is not None:
            spec = f.over
            if hasattr(spec, "name_ref"):
                raise NotImplementedError_("named WINDOW reference must be "
                                           "resolved by select planning")
            pb = tuple(E(p) for p in spec.partition_by)
            ob = tuple(SortExpr(E(o.expr), o.asc,
                                o.nulls_first if o.nulls_first is not None else not o.asc)
                       for o in spec.order_by)
            order_dtype = ob[0].expr.data_type(schema) if len(ob) == 1 else None
            frame = self._plan_frame(spec, len(ob), order_dtype)
            if not (freg.is_window_function(name) or freg.is_aggregate_function(name)):
                raise PlanError(f"'{name}' is not a window or aggregate function")
            arity = _WINDOW_ARITY.get(name)
            if arity is not None and len(args) not in arity:
                raise PlanError(
                    f"Error during planning: The function {name} expects "
                    f"{sorted(arity)} arguments, got {len(args)}")
            if f.order_by:
                # reference (and PostgreSQL): frame ordering belongs in the
                # OVER clause, not the aggregate (window.slt:3786)
                raise PlanError("Aggregate ORDER BY is not implemented for "
                                "window functions")
            if name.startswith(("regr_", "covar", "corr", "stddev",
                                "var")):
                for a in args:
                    try:
                        at = a.data_type(schema)
                    except Exception:  # noqa: BLE001
                        continue
                    if at.is_string:
                        raise PlanError(
                            f"Coercion error: {name} does not accept "
                            f"{at} arguments")
            return WindowFunction(name, args, pb, ob, frame,
                                  getattr(f, "ignore_nulls", False))

        if freg.is_aggregate_function(name):
            if name == "count" and not args and not f.star:
                # reference: count() is invalid — only count(*)/count(expr)
                raise PlanError(
                    "Error during planning: count() is not allowed; "
                    "use count(*) or count(expression)")
            if name in ("approx_percentile_cont",
                        "approx_percentile_cont_with_weight"):
                self._check_approx_percentile_args(name, args, schema)
            arity = _AGG_ARITY.get(name)
            if arity is not None and len(args) not in arity and not f.star:
                raise PlanError(
                    f"Error during planning: The function {name} expects "
                    f"{sorted(arity)} arguments, got {len(args)}")
            if name.startswith(("regr_", "covar", "corr", "stddev",
                                "var")):
                # strict numeric signature (reference: Coercion error —
                # the stats aggregates do not coerce strings)
                for a in args:
                    try:
                        at = a.data_type(schema)
                    except Exception:  # noqa: BLE001
                        continue
                    if at.is_string:
                        raise PlanError(
                            f"Coercion error: {name} does not accept "
                            f"{at} arguments")
            filt = E(f.filter) if f.filter is not None else None
            order_by = tuple(SortExpr(E(o.expr), o.asc,
                                      o.nulls_first if o.nulls_first is not None else not o.asc)
                             for o in f.order_by)
            if f.star or not args:
                args = ()
            return AggregateFunction(name, args, f.distinct, filt, order_by,
                                     getattr(f, "ignore_nulls", False))

        if freg.is_scalar_function(name):
            allowed = freg.SCALAR_ARITY.get(name)
            if allowed is not None and len(args) not in allowed:
                raise PlanError(
                    "Error during planning: No function matches the given "
                    f"name and argument types '{name}({len(args)} args)'. "
                    f"The function expects {sorted(allowed)} arguments")
            return ScalarFunction(name, args)

        if name == "unnest" and len(args) == 1:
            # placeholder; select_to_plan rewrites it into an Unnest node
            return ScalarFunction("unnest", args)

        raise PlanError(f"Invalid function '{name}'")

    @staticmethod
    def _check_approx_percentile_args(name, args, schema):
        """Signature validation matching the reference's coercion errors
        (functions-aggregate/src/approx_percentile_cont.rs signature +
        validate_input_percentile_expr / max_size checks)."""
        weighted = name.endswith("_with_weight")
        want = 3 if weighted else None   # cont: 2 or 3 args
        if weighted and len(args) != 3 or not weighted and len(args) not in (2, 3):
            raise PlanError(f"{name} requires "
                            f"{'3' if weighted else '2 or 3'} arguments")
        types = [a.data_type(schema) for a in args]
        if any(not t.is_numeric for t in types):
            raise PlanError(
                "Error during planning: Coercion from ["
                + ", ".join(str(t) for t in types)
                + f"] to the signature OneOf of '{name}' failed")
        pidx = 2 if weighted else 1
        p = args[pidx]
        while isinstance(p, (Cast, Alias)):
            p = p.expr
        if not isinstance(p, Literal):
            raise PlanError(
                f"Error during planning: Coercion failed: the percentile "
                f"argument of {name} must be a literal")
        if not weighted and len(args) == 3:
            m = args[2]
            ok = isinstance(m, Literal) and m.value.dtype.is_integer \
                and m.value.value is not None and int(m.value.value) > 0
            if not ok:
                raise NotImplementedError_(
                    "Tdigest max_size value for 'APPROX_PERCENTILE_CONT' "
                    "must be UInt > 0 literal")
        del want

    @staticmethod
    def _plan_frame(spec: A.WindowSpec, n_order: int,
                    order_dtype=None) -> WindowFrame:
        has_order = n_order > 0
        units = spec.frame_units or "RANGE"

        def offset_scalar(node):
            # reference: window_frame.rs:388 — ROWS/GROUPS offsets must be
            # non-negative integers; RANGE offsets coerce to the (single)
            # ORDER BY key's type: interval for temporal keys, number
            # otherwise ("Cannot cast" on mismatch)
            neg = False
            while isinstance(node, A.UnaryOp) and node.op in ("-", "+"):
                neg ^= node.op == "-"
                node = node.operand
            if isinstance(node, A.NullLit):
                raise PlanError("Invalid window frame: frame offsets must "
                                "be non negative integers")
            if isinstance(node, A.NumberLit):
                t = node.text
                v = float(t) if ("." in t or "e" in t.lower()) else int(t)
                if neg:
                    v = -v
                if v < 0 or (units != "RANGE" and isinstance(v, float)):
                    raise PlanError("Invalid window frame: frame offsets "
                                    "must be non negative integers")
                return ScalarValue.float64(v) if isinstance(v, float) \
                    else ScalarValue.int64(v)
            if isinstance(node, A.IntervalLit):
                return parse_interval(node.value, node.leading_unit)
            if isinstance(node, A.StringLit) and units == "RANGE":
                if order_dtype is not None and order_dtype.is_temporal:
                    return parse_interval(node.value, None)
                try:
                    return ScalarValue.float64(float(node.value))
                except ValueError:
                    raise PlanError(
                        f'Cannot cast Utf8("{node.value}") to '
                        f"{order_dtype if order_dtype is not None else 'Int8'}")
            raise PlanError("Invalid window frame: frame offsets must be "
                            "non negative integers")

        def bound(b: Optional[A.WindowFrameBound]) -> WindowFrameBound:
            if b is None:
                return WindowFrameBound("UNBOUNDED_PRECEDING")
            off = None
            if b.offset is not None:
                off = offset_scalar(b.offset)
            return WindowFrameBound(b.kind, off)

        if spec.frame_units is None:
            # SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW with
            # ORDER BY, else the whole partition
            if has_order:
                return WindowFrame("RANGE", WindowFrameBound("UNBOUNDED_PRECEDING"),
                                   WindowFrameBound("CURRENT"))
            return WindowFrame("ROWS", WindowFrameBound("UNBOUNDED_PRECEDING"),
                               WindowFrameBound("UNBOUNDED_FOLLOWING"))
        f = WindowFrame(spec.frame_units, bound(spec.frame_start),
                        bound(spec.frame_end) if spec.frame_end else WindowFrameBound("CURRENT"))
        _check_window_frame(f, n_order)
        return f

    def _const_int(self, e: A.Node, ctx: PlannerContext) -> Optional[int]:
        expr = self.expr_to_expr(e, Schema.empty(), ctx)
        # reference's plan_limit (sql/src/query.rs) accepts literals and
        # +,-,* arithmetic over literals; LIMIT NULL means no limit
        def check(x):
            if isinstance(x, Literal):
                if x.value.is_null or x.value.dtype.is_integer:
                    return
                raise PlanError("Unexpected expression in LIMIT clause")
            if isinstance(x, Negative):
                return check(x.expr)
            if isinstance(x, BinaryExpr):
                if x.op not in (Op.PLUS, Op.MINUS, Op.MULTIPLY):
                    raise PlanError("Unsupported operator for LIMIT clause")
                check(x.left)
                return check(x.right)
            raise PlanError("Unexpected expression in LIMIT clause")
        check(expr)
        if isinstance(expr, Negative) and isinstance(expr.expr, Literal) \
                and not expr.expr.value.is_null:
            expr = Literal(ScalarValue.int64(-int(expr.expr.value.value)))
        if not isinstance(expr, Literal):
            from ..optimizer.simplify import _try_const_fold
            folded = _try_const_fold(expr)
            if folded is not None:
                expr = folded
        if isinstance(expr, Literal) and expr.value.is_null:
            return None
        if isinstance(expr, Literal) and expr.value.dtype.is_integer:
            v = int(expr.value.value)
            if v < 0:
                raise PlanError("LIMIT/OFFSET must not be negative")
            return v
        raise PlanError("LIMIT/OFFSET must be an integer constant")
