"""File-backed tables: Parquet / CSV / JSON.

Reference parity: `ListingTable` (`datasource/listing/table.rs:617`) +
format execs (`datasource/physical_plan/{parquet,csv,json}.rs`). Scans
list the files, prune with predicate min/max row-group statistics
(PruningPredicate analog) and read only the projected columns.
"""
from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional, Sequence

from ..common.batch import Batch
from ..common.errors import ExecutionError, PlanError
from ..common.schema import Schema
from ..common.stats import ColumnStatistics, Precision, Statistics
from .arrow_convert import arrow_schema_to_schema, arrow_table_to_batch
from .provider import TableProvider


_DEFAULT_REGISTRY = None


def _registry(reg=None):
    """Session registry or the shared default (file:// only)."""
    global _DEFAULT_REGISTRY
    if reg is not None:
        return reg
    if _DEFAULT_REGISTRY is None:
        from .object_store import ObjectStoreRegistry
        _DEFAULT_REGISTRY = ObjectStoreRegistry()
    return _DEFAULT_REGISTRY


def _expand(path: str, registry=None, cache=None) -> List[str]:
    """URL/path/glob/dir -> local file paths, through the object-store
    registry (reference: ListingTable list_files_for_scan + ListFilesCache)."""
    reg = _registry(registry)
    store, p = reg.store_for_url(path)
    metas = None
    if cache is not None:
        metas = cache.get_listing(path)
    if metas is None:
        metas = store.list(p)
        if cache is not None:
            cache.put_listing(path, metas)
    out = []
    for m_ in metas:
        lp = store.local_path(m_.location)
        if lp is None:
            raise PlanError(
                f"object store for '{path}' has no local materialization")
        out.append(lp)
    return out


class ParquetTable(TableProvider):
    def __init__(self, path: str, table_partition_cols=None,
                 registry=None, cache=None):
        import pyarrow.parquet as pq
        self.paths = _expand(path, registry, cache)
        if not self.paths:
            raise PlanError(f"no files found at {path}")
        self._pq = pq
        self._cache = cache
        md = pq.read_schema(self.paths[0])
        if len(self.paths) > 1:
            # evolving listings: the table schema is the union of all file
            # schemas with types promoted (reference: ListingTable
            # infer_schema merges per-file schemas, listing/table.rs;
            # per-file drift is handled by the SchemaAdapter at scan time)
            import pyarrow as pa
            try:
                md = pa.unify_schemas(
                    [pq.read_schema(p) for p in self.paths],
                    promote_options="permissive")
            except Exception:  # noqa: BLE001 — incompatible: first file wins
                pass
        self.arrow_schema = md      # for the SchemaAdapter (evolving files)
        self._schema = arrow_schema_to_schema(md)
        self._stats_cache = None

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.file_scan import ParquetScanExec
        return ParquetScanExec(self, projection, filters, limit)

    def statistics(self) -> Statistics:
        if self._stats_cache is None:
            rows = 0
            nbytes = 0
            for p in self.paths:
                per_file = None
                meta = None
                if self._cache is not None:
                    st = os.stat(p)
                    from .object_store import ObjectMeta
                    meta = ObjectMeta(p, st.st_size, st.st_mtime)
                    per_file = self._cache.get_file_statistics(meta)
                if per_file is None:
                    md = self._pq.ParquetFile(p).metadata
                    per_file = (md.num_rows,
                                sum(md.row_group(rg).total_byte_size
                                    for rg in range(md.num_row_groups)))
                    if self._cache is not None:
                        self._cache.put_file_statistics(meta, per_file)
                rows += per_file[0]
                nbytes += per_file[1]
            self._stats_cache = Statistics(
                Precision.exact(rows), Precision.inexact(nbytes),
                self._column_stats())
        return self._stats_cache

    def _column_stats(self):
        """Exact column min/max/null_count folded over every row group of
        every file (reference: ParquetExec statistics extraction,
        datasource/physical_plan/parquet/statistics.rs) — feeds interval
        range selectivity and join-side choice."""
        names = [f.name for f in self._schema.fields]
        mins = {n: [] for n in names}
        maxs = {n: [] for n in names}
        nulls = {n: 0 for n in names}
        have_nulls = {n: True for n in names}
        try:
            for p in self.paths:
                md = self._pq.ParquetFile(p).metadata
                for rg in range(md.num_row_groups):
                    rgm = md.row_group(rg)
                    for ci in range(rgm.num_columns):
                        col = rgm.column(ci)
                        name = col.path_in_schema.split(".")[0]
                        if name not in mins:
                            continue
                        s = col.statistics
                        if s is None:
                            have_nulls[name] = False
                            continue
                        if s.has_min_max:
                            mins[name].append(s.min)
                            maxs[name].append(s.max)
                        if s.null_count is not None:
                            nulls[name] += s.null_count
                        else:
                            have_nulls[name] = False
        except Exception:  # noqa: BLE001 — stats stay Absent on any failure
            return [ColumnStatistics() for _ in names]
        out = []
        for n in names:
            cs = ColumnStatistics()
            if mins[n]:
                try:
                    cs = ColumnStatistics(
                        null_count=(Precision.exact(nulls[n])
                                    if have_nulls[n] else Precision.absent()),
                        min_value=Precision.exact(min(mins[n])),
                        max_value=Precision.exact(max(maxs[n])))
                except TypeError:    # mixed/unorderable stat types
                    cs = ColumnStatistics()
            out.append(cs)
        return out


class CsvTable(TableProvider):
    def __init__(self, path: str, has_header: bool = True,
                 delimiter: str = ",", schema: Optional[Schema] = None,
                 registry=None, cache=None, unbounded: bool = False,
                 with_order=None):
        self.paths = _expand(path, registry, cache)
        if not self.paths:
            raise PlanError(f"no files found at {path}")
        self.has_header = has_header
        self.delimiter = delimiter
        self.unbounded = unbounded        # CREATE UNBOUNDED EXTERNAL TABLE
        self.with_order = with_order or []  # [[(col, asc), ...], ...]
        self.explicit_schema = schema is not None
        self._schema = schema or self._infer()

    def _infer(self) -> Schema:
        import pyarrow.csv as pcsv
        ro = pcsv.ReadOptions(autogenerate_column_names=not self.has_header)
        po = pcsv.ParseOptions(delimiter=self.delimiter)
        t = pcsv.read_csv(self.paths[0], read_options=ro, parse_options=po)
        return arrow_schema_to_schema(t.schema)

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.file_scan import CsvScanExec
        return CsvScanExec(self, projection, limit)


class JsonTable(TableProvider):
    """Newline-delimited JSON."""

    def __init__(self, path: str, schema: Optional[Schema] = None,
                 registry=None, cache=None):
        self.paths = _expand(path, registry, cache)
        if not self.paths:
            raise PlanError(f"no files found at {path}")
        self._schema = schema or self._infer()

    def _infer(self) -> Schema:
        import pyarrow.json as pjson
        t = pjson.read_json(self.paths[0])
        return arrow_schema_to_schema(t.schema)

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.file_scan import JsonScanExec
        return JsonScanExec(self, projection, limit)


class AvroTable(TableProvider):
    """Avro object container files (embedded decoder — see
    datasource/avro.py; reference: AvroExec avro.rs:101 with the
    avro_to_arrow embedded reader)."""

    def __init__(self, path: str, schema: Optional[Schema] = None,
                 registry=None, cache=None):
        self.paths = _expand(path, registry, cache)
        if not self.paths:
            raise PlanError(f"no files found at {path}")
        self._schema = schema or self._infer()

    def _infer(self) -> Schema:
        from .avro import avro_to_arrow
        return arrow_schema_to_schema(avro_to_arrow(self.paths[0]).schema)

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.file_scan import AvroScanExec
        return AvroScanExec(self, projection, limit)


class OrcTable(TableProvider):
    """ORC files (pyarrow.orc reader)."""

    def __init__(self, path: str, schema: Optional[Schema] = None,
                 registry=None, cache=None):
        self.paths = _expand(path, registry, cache)
        if not self.paths:
            raise PlanError(f"no files found at {path}")
        self._schema = schema or self._infer()

    def _infer(self) -> Schema:
        import pyarrow.orc as porc
        return arrow_schema_to_schema(porc.ORCFile(self.paths[0]).schema)

    def schema(self) -> Schema:
        return self._schema

    def scan(self, projection, filters, limit, ctx):
        from ..physical.plan.file_scan import OrcScanExec
        return OrcScanExec(self, projection, limit)
