"""Data sources: pluggable TableProviders, in-memory tables, Parquet/CSV/JSON
listing tables with pruning.

Reference parity: `datafusion/core/src/datasource/` (SURVEY.md §2.5).
"""
from .provider import TableProvider  # noqa: F401
from .memory import MemTable  # noqa: F401
from .stream import StreamTable  # noqa: F401
