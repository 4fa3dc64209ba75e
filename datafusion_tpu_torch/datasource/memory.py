"""MemTable — batches resident in memory (device-ready).

Reference parity: `MemTable` + `MemoryExec`
(`datafusion/core/src/datasource/memory.rs`,
`datafusion/physical-plan/src/memory.rs:105`). This is the "tpch_mem" path:
columns get dictionary-encoded / converted once at registration and scans
are free.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..common.batch import Batch, concat_batches
from ..common.schema import Schema
from ..common.stats import Precision, Statistics, ColumnStatistics
from .provider import TableProvider


class MemTable(TableProvider):
    def __init__(self, schema: Schema, partitions: List[List[Batch]]):
        self._schema = schema
        self.partitions = partitions

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def from_batches(batches: List[Batch], n_partitions: int = 1) -> "MemTable":
        schema = batches[0].schema
        if n_partitions <= 1:
            return MemTable(schema, [batches])
        big = concat_batches(schema, batches)
        n = big.num_rows
        per = (n + n_partitions - 1) // n_partitions
        parts = []
        for i in range(n_partitions):
            s = big.slice_host(i * per, per)
            parts.append([s] if s.num_rows else [])
        return MemTable(schema, parts)

    @staticmethod
    def from_arrays(named, qualifier=None, n_partitions: int = 1) -> "MemTable":
        return MemTable.from_batches([Batch.from_arrays(named, qualifier)], n_partitions)

    @staticmethod
    def from_pandas(df, n_partitions: int = 1) -> "MemTable":
        named = {}
        for c in df.columns:
            s = df[c]
            if s.dtype == object or str(s.dtype).startswith("string"):
                named[c] = np.array([None if v is None or (isinstance(v, float) and np.isnan(v)) else v
                                     for v in s.tolist()], dtype=object)
            else:
                named[c] = s.to_numpy()
        return MemTable.from_arrays(named, n_partitions=n_partitions)

    # ---- TableProvider ------------------------------------------------------
    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.scan import MemoryExec
        return MemoryExec(self, projection, limit)

    def column_ndv(self, index: int):
        cache = getattr(self, "_ndv_cache", None)
        if cache is None:
            cache = self._ndv_cache = {}
        if index not in cache:
            import numpy as np
            vals = []
            for part in self.partitions:
                for b in part:
                    c = b.columns[index]
                    d = c.data_host()[: b.num_rows]
                    if c.dtype.is_string:
                        # codes are dictionary-local but within one table the
                        # dictionary is shared; distinct codes == distinct values
                        vals.append(np.unique(d))
                    else:
                        vals.append(np.unique(d))
            if not vals:
                cache[index] = 0
            else:
                cache[index] = int(len(np.unique(np.concatenate(vals))))
        return cache[index]

    def statistics(self) -> Statistics:
        rows = sum(b.num_rows for p in self.partitions for b in p)
        nbytes = 0
        for p in self.partitions:
            for b in p:
                for c in b.columns:
                    nbytes += b.num_rows * c.dtype.device_dtype().itemsize
        cols = getattr(self, "_colstats_cache", None)
        if cols is None:
            import numpy as np
            cols = []
            for i, f in enumerate(self._schema.fields):
                cs = ColumnStatistics()
                if f.dtype.is_numeric or f.dtype.id.value in (
                        "date", "timestamp", "time"):
                    mins, maxs, nulls = [], [], 0
                    for part in self.partitions:
                        for b in part:
                            c = b.columns[i]
                            d = c.data_host()[: b.num_rows]
                            v = c.validity_host()
                            if v is not None:
                                nulls += int((~v[: b.num_rows]).sum())
                                d = d[v[: b.num_rows]]
                            if len(d):
                                mins.append(d.min())
                                maxs.append(d.max())
                    if mins:
                        cs = ColumnStatistics(
                            null_count=Precision.exact(nulls),
                            min_value=Precision.exact(min(mins)),
                            max_value=Precision.exact(max(maxs)))
                cols.append(cs)
            self._colstats_cache = cols
        return Statistics(Precision.exact(rows), Precision.exact(nbytes),
                          list(cols))

    def insert_into(self, batches: Sequence[Batch], overwrite: bool = False) -> int:
        if overwrite:
            self.partitions = [[]]
        added = 0
        for b in batches:
            self.partitions[0].append(b)
            added += b.num_rows
        return added
