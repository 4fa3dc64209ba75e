"""Logical IR: expressions, plans, builders.

Reference parity: the `datafusion-expr` crate (SURVEY.md §2.2).
"""
from .expr import (  # noqa: F401
    AggregateFunction, Alias, Between, BinaryExpr, Case, Cast, Column, Exists,
    Expr, GroupingSet, InList, InSubquery, IsBool, IsNull, Like, Literal,
    Negative, Not, OuterRef, Placeholder, ScalarFunction, ScalarSubquery,
    SimilarTo, SortExpr, WindowFrame, WindowFrameBound, WindowFunction,
    col, conjunction, expr_to_columns, lit, split_conjunction,
)
from .operator import Op, op_from_sql  # noqa: F401
from .plan import (  # noqa: F401
    Aggregate, CrossJoin, Distinct, EmptyRelation, Except, Explain, Filter,
    Intersect, Join, Limit, LogicalPlan, Projection, RecursiveQuery, Sort,
    SubqueryAlias, TableScan, Union, Unnest, Values, Window,
    columns_from_exprs, find_aggregate_exprs, find_window_exprs,
)
