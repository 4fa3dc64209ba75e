"""Interval arithmetic + constraint propagation (cp_solver analog).

Reference parity: `datafusion/expr/src/interval_arithmetic.rs` (Interval
type, forward bound evaluation over expression trees) and
`datafusion/physical-expr/src/intervals/cp_solver.rs` (the
ExprIntervalGraph that pushes a required output interval back down the
tree, shrinking per-column ranges), surfaced the way
`physical-expr/src/analysis.rs` uses them: per-column bounds + a
selectivity estimate for a predicate.

Operates on logical `Expr` trees at planning time (planning is host-side
Python; the TPU executes the compiled plan, so this never runs on
device). Bounds are closed `[lower, upper]` floats with ±inf for
unbounded — the reference's open/closed bound distinction only sharpens
strict comparisons and does not change pruning/selectivity decisions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..expr import expr as E
from ..expr.operator import Op

_INF = math.inf


@dataclasses.dataclass
class Interval:
    lower: float = -_INF
    upper: float = _INF

    def is_empty(self) -> bool:
        return self.lower > self.upper

    def width(self) -> float:
        return self.upper - self.lower

    def intersect(self, other: "Interval") -> "Interval":
        return Interval(max(self.lower, other.lower),
                        min(self.upper, other.upper))

    def union(self, other: "Interval") -> "Interval":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return Interval(min(self.lower, other.lower),
                        max(self.upper, other.upper))

    def __add__(self, o: "Interval") -> "Interval":
        return Interval(self.lower + o.lower, self.upper + o.upper)

    def __sub__(self, o: "Interval") -> "Interval":
        return Interval(self.lower - o.upper, self.upper - o.lower)

    def __mul__(self, o: "Interval") -> "Interval":
        cs = [a * b for a in (self.lower, self.upper)
              for b in (o.lower, o.upper) if not math.isnan(a * b)]
        return Interval(min(cs), max(cs)) if cs else Interval()


def _lit_value(e: E.Expr) -> Optional[float]:
    if isinstance(e, E.Literal) and e.value.value is not None:
        v = e.value.value
        try:
            import datetime
            if isinstance(v, datetime.date) and not isinstance(
                    v, datetime.datetime):
                return float((v - datetime.date(1970, 1, 1)).days)
            return float(v)
        except (TypeError, ValueError):
            return None
    return None


def evaluate_bounds(e: E.Expr, ranges: Dict[str, Interval]) -> Interval:
    """Forward pass: expression -> value interval
    (interval_arithmetic.rs `Interval::add/sub/mul...`)."""
    if isinstance(e, E.Column):
        return ranges.get(e.name, Interval())
    v = _lit_value(e)
    if v is not None:
        return Interval(v, v)
    if isinstance(e, E.Cast):
        return evaluate_bounds(e.expr, ranges)
    if isinstance(e, E.Negative):
        b = evaluate_bounds(e.expr, ranges)
        return Interval(-b.upper, -b.lower)
    if isinstance(e, E.BinaryExpr):
        l = evaluate_bounds(e.left, ranges)
        r = evaluate_bounds(e.right, ranges)
        if e.op == Op.PLUS:
            return l + r
        if e.op == Op.MINUS:
            return l - r
        if e.op == Op.MULTIPLY:
            return l * r
    return Interval()


def _propagate_into(e: E.Expr, target: Interval,
                    ranges: Dict[str, Interval]) -> bool:
    """Backward pass (cp_solver.rs `propagate_constraints`): require
    `e ∈ target`, shrink column ranges in place. False = unsatisfiable."""
    if isinstance(e, E.Column):
        cur = ranges.get(e.name, Interval())
        nxt = cur.intersect(target)
        if nxt.is_empty():
            return False
        ranges[e.name] = nxt
        return True
    v = _lit_value(e)
    if v is not None:
        return target.lower <= v <= target.upper
    if isinstance(e, E.Cast):
        return _propagate_into(e.expr, target, ranges)
    if isinstance(e, E.Negative):
        return _propagate_into(e.expr, Interval(-target.upper, -target.lower),
                               ranges)
    if isinstance(e, E.BinaryExpr) and e.op in (Op.PLUS, Op.MINUS):
        l = evaluate_bounds(e.left, ranges)
        r = evaluate_bounds(e.right, ranges)
        if e.op == Op.PLUS:
            # a = target - b ; b = target - a
            return (_propagate_into(e.left, target - r, ranges) and
                    _propagate_into(e.right, target - evaluate_bounds(
                        e.left, ranges), ranges))
        # a - b ∈ target  =>  a ∈ target + b ; b ∈ a - target
        if not _propagate_into(e.left, target + r, ranges):
            return False
        l = evaluate_bounds(e.left, ranges)
        return _propagate_into(
            e.right, Interval(l.lower - target.upper, l.upper - target.lower),
            ranges)
    return True          # unsupported shape: no shrink, still satisfiable


def propagate_predicate(pred: E.Expr,
                        ranges: Dict[str, Interval]) -> Optional[
                            Dict[str, Interval]]:
    """Require `pred` TRUE; returns shrunk copy of ranges or None when the
    predicate is provably unsatisfiable over the given bounds."""
    out = dict(ranges)
    if _apply_true(pred, out):
        return out
    return None


def _apply_true(pred: E.Expr, ranges: Dict[str, Interval]) -> bool:
    if isinstance(pred, E.BinaryExpr):
        if pred.op == Op.AND:
            return _apply_true(pred.left, ranges) and \
                _apply_true(pred.right, ranges)
        if pred.op == Op.OR:
            l, r = dict(ranges), dict(ranges)
            ok_l = _apply_true(pred.left, l)
            ok_r = _apply_true(pred.right, r)
            if not ok_l and not ok_r:
                return False
            src = l if not ok_r else (r if not ok_l else None)
            for k in ranges:
                ranges[k] = (src[k] if src is not None
                             else l[k].union(r[k]))
            return True
        if pred.op in (Op.LT, Op.LTEQ, Op.GT, Op.GTEQ, Op.EQ):
            a, b = pred.left, pred.right
            op = pred.op
            if op in (Op.GT, Op.GTEQ):
                a, b = b, a
                op = Op.LT if op == Op.GT else Op.LTEQ
            av = evaluate_bounds(a, ranges)
            bv = evaluate_bounds(b, ranges)
            if op == Op.EQ:
                both = av.intersect(bv)
                return (_propagate_into(a, both, ranges) and
                        _propagate_into(b, both, ranges))
            # a <(=) b: a ≤ b.upper, b ≥ a.lower
            return (_propagate_into(a, Interval(-_INF, bv.upper), ranges) and
                    _propagate_into(b, Interval(av.lower, _INF), ranges))
    if isinstance(pred, E.Between) and not pred.negated:
        lo = _lit_value(pred.low)
        hi = _lit_value(pred.high)
        t = Interval(lo if lo is not None else -_INF,
                     hi if hi is not None else _INF)
        return _propagate_into(pred.expr, t, ranges)
    if isinstance(pred, E.Alias):
        return _apply_true(pred.expr, ranges)
    return True          # opaque predicate: no information


def selectivity(pred: E.Expr, ranges: Dict[str, Interval]) -> float:
    """analysis.rs `AnalysisContext` selectivity: the product over columns
    of shrunk-width / original-width after constraint propagation; 0.0
    when the predicate is unsatisfiable."""
    shrunk = propagate_predicate(pred, ranges)
    if shrunk is None:
        return 0.0
    sel = 1.0
    for name, orig in ranges.items():
        if orig.is_empty() or orig.width() in (0.0, _INF) or \
                math.isinf(orig.width()):
            continue
        s = shrunk[name]
        if s.is_empty():
            return 0.0
        sel *= max(min(s.width() / orig.width(), 1.0), 1e-9)
    return sel
