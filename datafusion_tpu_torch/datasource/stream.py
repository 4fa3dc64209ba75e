"""Unbounded / streaming table sources.

Reference parity: `StreamTable` + FIFO sources
(`core/src/datasource/stream.rs`) scanned by `StreamingTableExec`
(`physical-plan/src/streaming.rs:207`). A StreamTable wraps a factory of
batch iterators; `unbounded=True` marks an infinite source, which the
PipelineChecker physical rule (reference:
`physical_optimizer/pipeline_checker.rs:18`) uses to reject plans whose
pipeline-breaking operators (full sort, hash-join build, blocking
aggregate) would never produce output. Streaming-capable operators
(filters, projections, limits, BoundedWindowExec, SymmetricHashJoinExec)
execute incrementally over it.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

from ..common.batch import Batch
from ..common.schema import Schema
from .provider import TableProvider


class StreamTable(TableProvider):
    """A table backed by a user-supplied batch-iterator factory."""

    def __init__(self, schema: Schema,
                 source: Callable[[], Iterator[Batch]],
                 unbounded: bool = True):
        self._schema = schema
        self.source = source
        self.unbounded = unbounded

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.scan import StreamingTableExec
        return StreamingTableExec(self, projection, limit)
