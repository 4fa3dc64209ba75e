"""Batch — the unit of data flowing between physical operators.

Replaces Arrow ``RecordBatch`` streams (the currency of every reference
operator, `datafusion/physical-plan/src/lib.rs:414`). A Batch is a schema +
a list of Columns of equal length. Unlike the reference, batches destined
for device kernels are *padded to a bucket-rounded capacity* so XLA sees a
small set of static shapes; ``num_rows`` tracks real occupancy and kernels
mask the tail.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .column import Column, concat_columns
from .errors import internal
from .schema import Field, Schema


def round_capacity(n: int, bucket: int = 4096) -> int:
    """Round a row count up to a shape bucket so jit caches stay small:
    {4,5,6,7} x 2^k above the bucket floor. Quarter-octave buckets cap
    padding waste at ~14% (pure powers of two waste up to 50% — at SF1
    the 6.0M-row lineitem spine padded to 8.39M lanes, and every device
    op in the chain paid the full 8.39M)."""
    if n <= bucket:
        return bucket
    cap = bucket
    while cap < n:
        cap *= 2
    for m in (4, 5, 6, 7):
        c = (cap // 8) * m
        if c >= n:
            return c
    return cap


class Batch:
    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns: Sequence[Column], num_rows: Optional[int] = None):
        self.schema = schema
        self.columns: List[Column] = list(columns)
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        self.num_rows = num_rows
        for c in self.columns:
            if len(c) < num_rows:
                raise internal(f"column shorter ({len(c)}) than num_rows ({num_rows})")

    # ---- constructors ---------------------------------------------------------
    @staticmethod
    def from_arrays(named: Dict[str, np.ndarray], qualifier: Optional[str] = None) -> "Batch":
        cols, fields = [], []
        for name, arr in named.items():
            c = Column.from_numpy(np.asarray(arr))
            cols.append(c)
            fields.append(Field(name, c.dtype, nullable=c.has_nulls, qualifier=qualifier))
        return Batch(Schema(fields), cols)

    @staticmethod
    def empty(schema: Schema) -> "Batch":
        cols = []
        for f in schema:
            from .column import Dictionary
            dic = Dictionary(np.array([], dtype=object)) if f.dtype.is_dict_coded else None
            cols.append(Column(f.dtype, np.empty(0, f.dtype.device_dtype()), None, dic))
        return Batch(schema, cols, 0)

    # ---- access ----------------------------------------------------------------
    def column(self, i: int) -> Column:
        return self.columns[i]

    def column_by_name(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def __len__(self) -> int:
        return self.num_rows

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def capacity(self) -> int:
        return len(self.columns[0]) if self.columns else self.num_rows

    # ---- transforms -------------------------------------------------------------
    def project(self, indices: Sequence[int]) -> "Batch":
        return Batch(self.schema.project(indices),
                     [self.columns[i] for i in indices], self.num_rows)

    def with_schema(self, schema: Schema) -> "Batch":
        return Batch(schema, self.columns, self.num_rows)

    def take_host(self, indices: np.ndarray) -> "Batch":
        return Batch(self.schema, [c.take_host(indices) for c in self.columns],
                     len(indices))

    def filter_host(self, mask: np.ndarray) -> "Batch":
        mask = mask[:self.num_rows] if len(mask) > self.num_rows else mask
        return Batch(self.schema,
                     [c.slice_host(0, self.num_rows).filter_host(mask) for c in self.columns],
                     int(mask.sum()))

    def slice_host(self, start: int, length: int) -> "Batch":
        length = max(0, min(length, self.num_rows - start))
        return Batch(self.schema,
                     [c.slice_host(start, length) for c in self.columns], length)

    def compact(self) -> "Batch":
        """Trim padding: columns exactly num_rows long, on host."""
        if self.capacity == self.num_rows:
            return self
        return self.slice_host(0, self.num_rows)

    def pad_to(self, capacity: int) -> "Batch":
        """Pad columns with zeros/invalid up to ``capacity`` rows (host op)."""
        if self.capacity >= capacity:
            return self
        cols = []
        extra = capacity - self.capacity
        for c in self.columns:
            data = np.concatenate([c.data_host(),
                                   np.zeros(extra, c.data_host().dtype)])
            v = c.validity_host()
            if v is not None:
                v = np.concatenate([v, np.zeros(extra, bool)])
            cols.append(Column(c.dtype, data, v, c.dictionary))
        return Batch(self.schema, cols, self.num_rows)

    def nbytes(self) -> int:
        """Approximate in-memory size (device representation bytes)."""
        total = 0
        for c in self.columns:
            if c.dtype.is_nested:
                total += self.num_rows * 64   # host object estimate
            else:
                total += self.num_rows * c.dtype.device_dtype().itemsize
            if c.has_nulls:
                total += self.num_rows
        return total

    # ---- display ------------------------------------------------------------
    def to_pydict(self):
        return {f.name: c.to_pylist(self.num_rows)
                for f, c in zip(self.schema.fields, self.columns)}

    def __repr__(self):
        return f"Batch({self.num_rows} rows, schema={self.schema})"


def concat_batches(schema: Schema, batches: Sequence[Batch]) -> Batch:
    batches = [b.compact() for b in batches if b.num_rows > 0]
    if not batches:
        return Batch.empty(schema)
    if len(batches) == 1:
        return batches[0]
    cols = []
    for i in range(len(schema)):
        cols.append(concat_columns([b.columns[i] for b in batches]))
    return Batch(schema, cols, sum(b.num_rows for b in batches))
