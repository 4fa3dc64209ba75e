"""Physical operators.

Reference parity: `datafusion/physical-plan/src/` (SURVEY.md §2.4). Every
operator implements `ExecutionPlan` with `execute(partition, ctx)` yielding
Batches lazily — the pull-based stream model of the reference, with the
hot compute inside each step vectorized (numpy host path / jitted device
path).
"""
from .base import ExecutionPlan, Partitioning, collect, execute_stream  # noqa: F401
