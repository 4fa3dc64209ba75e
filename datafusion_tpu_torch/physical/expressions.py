"""Physical expressions: executable, column-index-bound expression trees.

Reference parity: the `PhysicalExpr` trait and its concrete impls
(`datafusion/physical-expr/src/expressions/` — binary.rs, case.rs,
in_list.rs, like.rs, column.rs, cast.rs, negative.rs, is_null.rs, ...).
`compile_expr` plays the role of `create_physical_expr`
(`datafusion/physical-expr/src/planner.rs`): it resolves logical column
names against the input schema into positional indices and selects kernels.

`PhysicalExpr.evaluate(batch) -> Column` always returns a column of length
`batch.num_rows` (scalar results are broadcast).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common import dt
from ..common.batch import Batch
from ..common.column import Column as PhysColumn
from ..common.datatypes import DataType, TypeId
from ..common.errors import ExecutionError, PlanError, internal
from ..common.scalar import ScalarValue
from ..common.schema import Schema
from ..expr import expr as E
from ..expr.operator import Op
from . import kernels as K
from . import scalar_functions as F


class PhysicalExpr:
    """Base: an executable expression bound to an input schema."""

    out_type: DataType

    def evaluate(self, batch: Batch) -> PhysColumn:
        raise NotImplementedError

    def children(self) -> Tuple["PhysicalExpr", ...]:
        return ()

    def column_indices(self) -> List[int]:
        """All input column positions this expression reads."""
        out = []
        def walk(e):
            if isinstance(e, ColumnExpr):
                out.append(e.index)
            for c in e.children():
                walk(c)
        walk(self)
        return out


@dataclasses.dataclass
class ColumnExpr(PhysicalExpr):
    index: int
    name: str
    out_type: DataType

    def evaluate(self, batch: Batch) -> PhysColumn:
        return batch.columns[self.index]

    def __str__(self):
        return f"{self.name}@{self.index}"


class DeferredScalarExpr(PhysicalExpr):
    """Uncorrelated scalar subquery folded into an expression: executes
    `plan` once per query and broadcasts its single value. Produced when
    the device-aggregate fusion descends through a one-row nested-loop /
    cross join side (reference analog: the 1-row build of
    NestedLoopJoinExec, nested_loop_join.rs — here the scalar becomes a
    program INPUT so compiled device programs are reused across values)."""

    def __init__(self, plan, index: int, out_type: DataType):
        self.plan = plan
        self.index = index
        self.out_type = out_type
        self._memo = None
        self._ctx = None

    def children(self):
        return ()

    def bind_ctx(self, ctx):
        """Use the enclosing query's TaskContext (shares the per-query
        subtree cache); invalidates the memo when the context changes."""
        if ctx is not self._ctx:
            self._ctx = ctx
            self._memo = None

    def scalar(self):
        """(host numpy scalar in device representation, valid) — memoized
        per (physical-plan instance, bound context)."""
        if self._memo is None:
            from .plan.base import collect_batch
            b = collect_batch(self.plan, self._ctx)
            c = b.columns[self.index]
            if b.num_rows == 0:
                self._memo = (np.zeros(1, c.dtype.device_dtype())[0], False,
                              c.dictionary)
            else:
                v = c.validity_host()
                self._memo = (c.data_host()[0],
                              bool(v[0]) if v is not None else True,
                              c.dictionary)
        return self._memo

    def evaluate(self, batch: Batch) -> PhysColumn:
        val, valid, dic = self.scalar()
        n = batch.num_rows
        data = np.full(max(n, 1), val)[:n]
        validity = None if valid else np.zeros(n, bool)
        return PhysColumn(self.out_type, data, validity, dic)

    def __str__(self):
        return f"scalar_subquery@{self.index}"


@dataclasses.dataclass
class LiteralExpr(PhysicalExpr):
    value: ScalarValue

    def __post_init__(self):
        self.out_type = self.value.dtype

    def evaluate(self, batch: Batch) -> PhysColumn:
        return K.broadcast_scalar(self.value, batch.num_rows)

    def __str__(self):
        return str(self.value)


@dataclasses.dataclass
class BinaryPhysExpr(PhysicalExpr):
    left: PhysicalExpr
    op: Op
    right: PhysicalExpr
    out_type: DataType

    def children(self):
        return (self.left, self.right)

    def evaluate(self, batch: Batch) -> PhysColumn:
        l = self.left.evaluate(batch)
        r = self.right.evaluate(batch)
        op = self.op
        if op in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
            return K.compare(op.value, l, r)
        if op == Op.AND:
            return K.kleene_and(l, r)
        if op == Op.OR:
            return K.kleene_or(l, r)
        if op in (Op.PLUS, Op.MINUS, Op.MULTIPLY, Op.DIVIDE, Op.MODULO):
            return K.arith(op.value, l, r, self.out_type)
        if op == Op.IS_DISTINCT_FROM:
            return K.is_distinct_from(l, r, negated=False)
        if op == Op.IS_NOT_DISTINCT_FROM:
            return K.is_distinct_from(l, r, negated=True)
        if op == Op.STRING_CONCAT:
            return F.string_concat(l, r)
        if op in (Op.BITWISE_AND, Op.BITWISE_OR, Op.BITWISE_XOR,
                  Op.BITWISE_SHIFT_LEFT, Op.BITWISE_SHIFT_RIGHT):
            a = K.cast_column(l, self.out_type).data_host()
            b = K.cast_column(r, self.out_type).data_host()
            if op in (Op.BITWISE_SHIFT_LEFT, Op.BITWISE_SHIFT_RIGHT):
                # Rust wrapping_shl/shr semantics (arrow bitwise kernels):
                # the shift amount wraps modulo the lane bit-width, so
                # `c >> 1024` on Int32 shifts by 0
                bits = a.dtype.itemsize * 8
                b = b & (bits - 1)
                fn = (np.left_shift if op == Op.BITWISE_SHIFT_LEFT
                      else np.right_shift)
            else:
                fn = {Op.BITWISE_AND: np.bitwise_and,
                      Op.BITWISE_OR: np.bitwise_or,
                      Op.BITWISE_XOR: np.bitwise_xor}[op]
            return PhysColumn(self.out_type, fn(a, b),
                              K.and_validity(l.validity_host(), r.validity_host()))
        raise internal(f"unhandled binary op {op}")

    def __str__(self):
        return f"({self.left} {self.op.value} {self.right})"


@dataclasses.dataclass
class NotExpr(PhysicalExpr):
    expr: PhysicalExpr
    out_type: DataType = dt.BOOL

    def children(self):
        return (self.expr,)

    def evaluate(self, batch):
        return K.logical_not(self.expr.evaluate(batch))

    def __str__(self):
        return f"NOT {self.expr}"


@dataclasses.dataclass
class NegativeExpr(PhysicalExpr):
    expr: PhysicalExpr
    out_type: DataType

    def children(self):
        return (self.expr,)

    def evaluate(self, batch):
        c = self.expr.evaluate(batch)
        if c.dtype.is_interval and \
                not (c.dtype.unit or "").startswith("rawdur"):
            # packed offset-binary interval: negate componentwise
            from ..functions.datetime_helpers import (pack_interval_np,
                                                      unpack_interval_np)
            m, d, ns = unpack_interval_np(c.data_host())
            return PhysColumn(c.dtype, pack_interval_np(-m, -d, -ns),
                              c.validity_host())
        return PhysColumn(c.dtype, -c.data_host(), c.validity_host())

    def __str__(self):
        return f"(- {self.expr})"


@dataclasses.dataclass
class IsNullExpr(PhysicalExpr):
    expr: PhysicalExpr
    negated: bool
    out_type: DataType = dt.BOOL

    def children(self):
        return (self.expr,)

    def evaluate(self, batch):
        c = self.expr.evaluate(batch)
        m = K.valid_mask(c)
        return PhysColumn(dt.BOOL, m if self.negated else ~m, None)

    def __str__(self):
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclasses.dataclass
class IsBoolExpr(PhysicalExpr):
    expr: PhysicalExpr
    value: Optional[bool]   # True / False / None (UNKNOWN)
    negated: bool
    out_type: DataType = dt.BOOL

    def children(self):
        return (self.expr,)

    def evaluate(self, batch):
        c = self.expr.evaluate(batch)
        m = K.valid_mask(c)
        d = c.data_host().astype(bool)
        if self.value is None:
            out = ~m
        elif self.value:
            out = m & d
        else:
            out = m & ~d
        return PhysColumn(dt.BOOL, ~out if self.negated else out, None)


@dataclasses.dataclass
class CastExpr(PhysicalExpr):
    expr: PhysicalExpr
    out_type: DataType
    safe: bool = False

    def children(self):
        return (self.expr,)

    def evaluate(self, batch):
        return K.cast_column(self.expr.evaluate(batch), self.out_type, self.safe)

    def __str__(self):
        return f"CAST({self.expr} AS {self.out_type})"


@dataclasses.dataclass
class CaseExpr(PhysicalExpr):
    operand: Optional[PhysicalExpr]
    whens: List[Tuple[PhysicalExpr, PhysicalExpr]]
    else_: Optional[PhysicalExpr]
    out_type: DataType

    def children(self):
        out = ([self.operand] if self.operand else [])
        for w, t in self.whens:
            out += [w, t]
        if self.else_:
            out.append(self.else_)
        return tuple(out)

    def evaluate(self, batch):
        n = batch.num_rows
        if self.operand is not None:
            opv = self.operand.evaluate(batch)
        # start from ELSE (or NULL), then overlay whens in reverse order so
        # the first matching WHEN wins
        if self.else_ is not None:
            acc = K.cast_column(self.else_.evaluate(batch), self.out_type) \
                if not self.out_type.is_string else self.else_.evaluate(batch)
        else:
            acc = K.broadcast_scalar(ScalarValue(self.out_type, None), n)
        taken = np.zeros(n, bool)
        results = []
        for w, t in self.whens:
            if self.operand is not None:
                cond = K.compare("=", opv, w.evaluate(batch))
            else:
                cond = w.evaluate(batch)
                if not cond.dtype.is_boolean:
                    # reference coerces WHEN conditions ('true' etc.) to bool
                    cond = K.cast_column(cond, dt.BOOL)
            mask = K.true_mask(cond) & ~taken
            taken |= mask
            results.append((mask, t))
        for mask, t in reversed(results):
            if mask.any():
                acc = K.select(mask, t.evaluate(batch), acc)
        if acc.dtype != self.out_type and not (acc.dtype.is_string and self.out_type.is_string):
            acc = K.cast_column(acc, self.out_type)
        return acc


@dataclasses.dataclass
class InListExpr(PhysicalExpr):
    expr: PhysicalExpr
    items: List[PhysicalExpr]
    negated: bool
    out_type: DataType = dt.BOOL

    def children(self):
        return (self.expr, *self.items)

    def evaluate(self, batch):
        c = self.expr.evaluate(batch)
        n = batch.num_rows
        hit = np.zeros(n, bool)
        any_null_item = np.zeros(n, bool)
        for item in self.items:
            ic = item.evaluate(batch)
            eq = K.compare("=", c, ic)
            hit |= K.true_mask(eq)
            v = eq.validity_host()
            if v is not None:
                any_null_item |= ~v
        # SQL: x IN (...) is NULL if no hit and any comparison was NULL
        valid = hit | ~any_null_item
        final_validity = K.and_validity(
            None if valid.all() else valid, c.validity_host())
        data = ~hit if self.negated else hit
        return PhysColumn(dt.BOOL, data, final_validity)


@dataclasses.dataclass
class LikeExpr(PhysicalExpr):
    expr: PhysicalExpr
    pattern: PhysicalExpr
    negated: bool
    case_insensitive: bool
    escape: Optional[str]
    out_type: DataType = dt.BOOL

    def children(self):
        return (self.expr, self.pattern)

    def evaluate(self, batch):
        c = self.expr.evaluate(batch)
        if isinstance(self.pattern, LiteralExpr):
            pat = self.pattern.value.value
            if pat is None:
                return K.broadcast_scalar(ScalarValue(dt.BOOL, None), batch.num_rows)
            return K.like(c, pat, self.negated, self.case_insensitive, self.escape)
        # non-constant pattern: evaluate row-wise on decoded strings
        import re
        pc = self.pattern.evaluate(batch)
        if c.dtype.is_null or pc.dtype.is_null:
            # NULL LIKE x / x LIKE NULL is all-NULL boolean
            return K.broadcast_scalar(ScalarValue(dt.BOOL, None),
                                      batch.num_rows)
        s = K.decode_strings(c)
        p = K.decode_strings(pc)
        flags = re.DOTALL | (re.IGNORECASE if self.case_insensitive else 0)
        out = np.fromiter(
            (si is not None and pi is not None and
             re.match(K.like_pattern_to_regex(pi, self.escape), si, flags) is not None
             for si, pi in zip(s, p)), dtype=bool, count=batch.num_rows)
        if self.negated:
            out = ~out
        return PhysColumn(dt.BOOL, out,
                          K.and_validity(c.validity_host(), pc.validity_host()))


@dataclasses.dataclass
class ScalarFunctionExpr(PhysicalExpr):
    name: str
    args: List[PhysicalExpr]
    out_type: DataType

    def children(self):
        return tuple(self.args)

    def evaluate(self, batch):
        cols = [a.evaluate(batch) for a in self.args]
        return F.dispatch(self.name, cols, self.out_type, batch.num_rows,
                          arg_exprs=self.args)

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


def rewrite_columns(e: PhysicalExpr, repl: List[PhysicalExpr]) -> PhysicalExpr:
    """Replace every ColumnExpr(i) with repl[i] (projection inlining —
    used to fuse operator chains into one compiled pipeline)."""
    if isinstance(e, ColumnExpr):
        return repl[e.index]
    if isinstance(e, (LiteralExpr, DeferredScalarExpr)):
        return e   # column-free leaves pass through unchanged
    if isinstance(e, BinaryPhysExpr):
        return BinaryPhysExpr(rewrite_columns(e.left, repl), e.op,
                              rewrite_columns(e.right, repl), e.out_type)
    if isinstance(e, NotExpr):
        return NotExpr(rewrite_columns(e.expr, repl))
    if isinstance(e, NegativeExpr):
        return NegativeExpr(rewrite_columns(e.expr, repl), e.out_type)
    if isinstance(e, IsNullExpr):
        return IsNullExpr(rewrite_columns(e.expr, repl), e.negated)
    if isinstance(e, IsBoolExpr):
        return IsBoolExpr(rewrite_columns(e.expr, repl), e.value, e.negated)
    if isinstance(e, CastExpr):
        return CastExpr(rewrite_columns(e.expr, repl), e.out_type, e.safe)
    if isinstance(e, CaseExpr):
        return CaseExpr(
            rewrite_columns(e.operand, repl) if e.operand is not None else None,
            [(rewrite_columns(w, repl), rewrite_columns(t, repl))
             for w, t in e.whens],
            rewrite_columns(e.else_, repl) if e.else_ is not None else None,
            e.out_type)
    if isinstance(e, InListExpr):
        return InListExpr(rewrite_columns(e.expr, repl),
                          [rewrite_columns(i, repl) for i in e.items],
                          e.negated)
    if isinstance(e, LikeExpr):
        return LikeExpr(rewrite_columns(e.expr, repl),
                        rewrite_columns(e.pattern, repl),
                        e.negated, e.case_insensitive, e.escape)
    if isinstance(e, ScalarFunctionExpr):
        return ScalarFunctionExpr(e.name,
                                  [rewrite_columns(a, repl) for a in e.args],
                                  e.out_type)
    raise internal(f"rewrite_columns: unhandled {type(e).__name__}")


# --------------------------------------------------------------------------
# compiler: logical Expr -> PhysicalExpr
# --------------------------------------------------------------------------

def compile_expr(expr: E.Expr, schema: Schema) -> PhysicalExpr:
    if isinstance(expr, E.Alias):
        return compile_expr(expr.expr, schema)
    if isinstance(expr, E.Column):
        idx = schema.index_of(expr.name, expr.qualifier)
        return ColumnExpr(idx, expr.name, schema.field(idx).dtype)
    if isinstance(expr, E.Literal):
        return LiteralExpr(expr.value)
    if isinstance(expr, E.BinaryExpr):
        return BinaryPhysExpr(compile_expr(expr.left, schema), expr.op,
                              compile_expr(expr.right, schema),
                              expr.data_type(schema))
    if isinstance(expr, E.Not):
        return NotExpr(compile_expr(expr.expr, schema))
    if isinstance(expr, E.Negative):
        return NegativeExpr(compile_expr(expr.expr, schema), expr.data_type(schema))
    if isinstance(expr, E.IsNull):
        return IsNullExpr(compile_expr(expr.expr, schema), expr.negated)
    if isinstance(expr, E.IsBool):
        return IsBoolExpr(compile_expr(expr.expr, schema), expr.value, expr.negated)
    if isinstance(expr, E.Cast):
        return CastExpr(compile_expr(expr.expr, schema), expr.dtype, expr.safe)
    if isinstance(expr, E.Case):
        operand = compile_expr(expr.operand, schema) if expr.operand is not None else None
        whens = [(compile_expr(w, schema), compile_expr(t, schema))
                 for w, t in expr.whens]
        else_ = compile_expr(expr.else_, schema) if expr.else_ is not None else None
        return CaseExpr(operand, whens, else_, expr.data_type(schema))
    if isinstance(expr, E.InList):
        return InListExpr(compile_expr(expr.expr, schema),
                          [compile_expr(i, schema) for i in expr.items],
                          expr.negated)
    if isinstance(expr, E.Between):
        # x BETWEEN lo AND hi  ==  x >= lo AND x <= hi
        x = compile_expr(expr.expr, schema)
        lo = compile_expr(expr.low, schema)
        hi = compile_expr(expr.high, schema)
        ge = BinaryPhysExpr(x, Op.GTEQ, lo, dt.BOOL)
        le = BinaryPhysExpr(x, Op.LTEQ, hi, dt.BOOL)
        both = BinaryPhysExpr(ge, Op.AND, le, dt.BOOL)
        return NotExpr(both) if expr.negated else both
    if isinstance(expr, E.Like):
        return LikeExpr(compile_expr(expr.expr, schema),
                        compile_expr(expr.pattern, schema),
                        expr.negated, expr.case_insensitive, expr.escape)
    if isinstance(expr, E.SimilarTo):
        # SIMILAR TO uses SQL regex; approximate with full regex match
        return ScalarFunctionExpr(
            "regexp_like_full",
            [compile_expr(expr.expr, schema), compile_expr(expr.pattern, schema)],
            dt.BOOL) if not expr.negated else NotExpr(ScalarFunctionExpr(
                "regexp_like_full",
                [compile_expr(expr.expr, schema), compile_expr(expr.pattern, schema)],
                dt.BOOL))
    if isinstance(expr, E.ScalarFunction):
        args = [compile_expr(a, schema) for a in expr.args]
        return ScalarFunctionExpr(expr.name, args, expr.data_type(schema))
    if isinstance(expr, E.AggregateFunction):
        raise PlanError(f"aggregate function {expr.name} used outside an Aggregate node")
    if isinstance(expr, E.WindowFunction):
        raise PlanError("window function used outside a Window node")
    if isinstance(expr, (E.ScalarSubquery, E.Exists, E.InSubquery)):
        raise PlanError(
            "subquery was not decorrelated; enable the optimizer or rewrite the query")
    raise PlanError(f"cannot compile expression {type(expr).__name__}: {expr}")


def compile_exprs(exprs: Sequence[E.Expr], schema: Schema) -> List[PhysicalExpr]:
    return [compile_expr(e, schema) for e in exprs]
