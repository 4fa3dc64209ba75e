"""Typed engine errors.

Reference parity: DataFusionError (`datafusion/common/src/error.rs:53-74`).
Every operator surfaces errors as exceptions of these types; the first error
aborts the query (matching the reference's first-Err-cancels-siblings model).
"""
from __future__ import annotations


class DataFusionError(Exception):
    """Base error for the engine."""


class PlanError(DataFusionError):
    """Logical planning failed (bad SQL semantics, unknown column, ...)."""


class ParserError(DataFusionError):
    """SQL text could not be parsed."""


class SchemaError(DataFusionError):
    """Schema mismatch / unknown field / ambiguous reference."""


class TypeError_(DataFusionError):
    """Type coercion / signature mismatch."""


class ExecutionError(DataFusionError):
    """Runtime failure inside an operator."""


class NotImplementedError_(DataFusionError):
    """Feature recognized but not yet supported."""


class ResourcesExhausted(DataFusionError):
    """Memory budget exceeded (analog of ResourcesExhausted from MemoryPool,
    `datafusion/execution/src/memory_pool/mod.rs:85`)."""


class InternalError(DataFusionError):
    """Engine bug — invariant violated."""


def internal(msg: str) -> InternalError:
    return InternalError(f"Internal error: {msg}. This is a bug in datafusion_tpu.")
