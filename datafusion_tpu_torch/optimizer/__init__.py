"""Logical optimizer.

Reference parity: `datafusion/optimizer/src/` — the Analyzer + Optimizer
two-stage rewrite pipeline with a fixed rule list run up to `max_passes`
times (`optimizer.rs:245-278`). Rules implemented so far (same names as the
reference): SimplifyExpressions, ExtractEquijoinPredicate,
EliminateCrossJoin, PushDownFilter, EliminateFilter, EliminateLimit,
PushDownLimit, ScalarSubqueryToJoin, DecorrelatePredicateSubquery,
OptimizeProjections.
"""
from .optimizer import Optimizer  # noqa: F401
