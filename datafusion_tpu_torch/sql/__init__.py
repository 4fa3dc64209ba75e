"""SQL frontend: tokenizer, parser, and SQL->LogicalPlan planner.

Reference parity: the `datafusion-sql` crate (SURVEY.md §2.2) — except the
parser itself is also ours (the reference delegates to sqlparser-rs).
"""
from .parser import parse_one, parse_sql  # noqa: F401
