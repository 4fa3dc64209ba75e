"""Optimizer driver.

Reference parity: `Optimizer::optimize` (`optimizer/src/optimizer.rs:245`)
— fixed rule list applied in order, up to `max_passes` passes, stopping
early when a pass leaves the plan unchanged (compared by display text, the
reference compares plan fingerprints).
"""
from __future__ import annotations

from typing import List, Optional

from ..expr.plan import LogicalPlan
from .decorrelate import DecorrelatePredicateSubquery, ScalarSubqueryToJoin
from .extra_rules import (CommonSubexprEliminate, EliminateJoin,
                          FilterNullJoinKeys, PropagateEmptyRelation,
                          ReplaceDistinctWithAggregate,
                          SingleDistinctToGroupBy, UnwrapCastInComparison)
from .join_rules import (EliminateCrossJoin, EliminateOuterJoin,
                         ExtractEquijoinPredicate)
from .optimize_projections import OptimizeProjections
from .push_down_filter import (EliminateFilter, EliminateLimit,
                               PushDownFilter, PushDownLimit)
from .simplify import RewriteDisjunctivePredicate, SimplifyExpressions


def default_rules() -> List:
    # ordering mirrors the reference's list (optimizer.rs:245-278) for the
    # rules implemented so far
    return [
        SimplifyExpressions(),
        UnwrapCastInComparison(),
        ReplaceDistinctWithAggregate(),
        EliminateJoin(),
        DecorrelatePredicateSubquery(),
        ScalarSubqueryToJoin(),
        RewriteDisjunctivePredicate(),
        ExtractEquijoinPredicate(),
        EliminateCrossJoin(),
        ExtractEquijoinPredicate(),   # extract keys exposed by cross-join elim
        EliminateFilter(),
        PropagateEmptyRelation(),
        FilterNullJoinKeys(),
        EliminateOuterJoin(),
        EliminateFilter(),
        PushDownFilter(),
        EliminateLimit(),
        PushDownLimit(),
        SingleDistinctToGroupBy(),
        SimplifyExpressions(),
        UnwrapCastInComparison(),
        CommonSubexprEliminate(),
        OptimizeProjections(),
    ]


class Optimizer:
    def __init__(self, rules: Optional[List] = None, max_passes: int = 3):
        self.rules = rules if rules is not None else default_rules()
        self.max_passes = max_passes

    def optimize(self, plan: LogicalPlan, config=None) -> LogicalPlan:
        from .decorrelate import reset_alias_counter
        reset_alias_counter()   # per-statement __correlated_sq_N numbering
        prev = plan.display()
        for _ in range(self.max_passes):
            for rule in self.rules:
                plan = rule.rewrite(plan)
            cur = plan.display()
            if cur == prev:
                break
            prev = cur
        return plan
