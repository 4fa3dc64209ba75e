"""File scan operators: Parquet (with row-group stats pruning), CSV, JSON.

Reference parity: `ParquetExec` (`datasource/physical_plan/parquet/mod.rs:629`)
with row-group pruning via predicate min/max statistics
(`parquet/row_groups.rs`, the PruningPredicate design
`physical_optimizer/pruning.rs:463`), `CsvExec` (`csv.rs:170`),
`NdJsonExec` (`json.rs:129`).

The host reads + decodes (pyarrow), prunes row groups whose [min, max]
cannot satisfy the predicate, converts to the dense device layout, and
yields one large Batch per file (big tiles amortize TPU kernel launches).
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from ...common.batch import Batch
from ...common.errors import ExecutionError
from ...common.schema import Schema
from ...datasource.arrow_convert import arrow_table_to_batch
from ...expr import expr as E
from ...expr.operator import Op
from ...runtime import BaselineMetrics, TaskContext
from .base import ExecutionPlan, Partitioning


class ParquetScanExec(ExecutionPlan):
    def __init__(self, table, projection: Optional[List[int]],
                 filters: Optional[List[E.Expr]] = None,
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.filters = filters or []    # logical exprs for stats pruning
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base
        # row-group assignments per partition: [[(file_idx, rg), ...], ...]
        # (intra-file parallelism; None = one partition per file)
        self._assignments = None

    def schema(self):
        return self._schema

    def output_partitioning(self):
        if self._assignments is not None:
            return Partitioning.unknown(len(self._assignments))
        return Partitioning.unknown(max(1, len(self.table.paths)))

    def repartitioned(self, target: int) -> Optional["ParquetScanExec"]:
        """Split the scan's row groups across `target` partitions by byte
        size (LPT greedy), so one large file reads as N parallel
        partitions (reference: ParquetExec::repartitioned,
        datasource/physical_plan/parquet/mod.rs:629 — byte ranges that
        claim the row groups whose midpoint falls inside)."""
        import pyarrow.parquet as pq
        units = []
        for fi, path in enumerate(self.table.paths):
            try:
                md = pq.ParquetFile(path).metadata
            except Exception:  # noqa: BLE001
                return None
            for rg in range(md.num_row_groups):
                units.append((md.row_group(rg).total_byte_size, fi, rg))
        if target <= 1 or len(units) <= max(1, len(self.table.paths)):
            return None
        target = min(target, len(units))
        units.sort(reverse=True)
        loads = [0] * target
        buckets = [[] for _ in range(target)]
        for b, fi, rg in units:
            i = loads.index(min(loads))
            loads[i] += max(1, b)
            buckets[i].append((fi, rg))
        new = ParquetScanExec(self.table, self.projection, self.filters,
                              self.limit)
        new._assignments = [sorted(bkt) for bkt in buckets]
        return new

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import pyarrow.parquet as pq
        m = BaselineMetrics(self.metrics, partition)
        rg_pruned = self.metrics.counter("row_groups_pruned_statistics", partition)
        rg_matched = self.metrics.counter("row_groups_matched_statistics", partition)
        names = self._schema.names()
        try:
            use_bloom = bool(ctx.config.get(
                "datafusion.execution.parquet.bloom_filter_on_read"))
        except Exception:  # noqa: BLE001
            use_bloom = True
        if self._assignments is not None:
            work = {}
            for fi, rg in self._assignments[partition]:
                work.setdefault(fi, []).append(rg)
            items = sorted(work.items())
        else:
            items = [(partition, None)]
        expected_arrow = getattr(self.table, "arrow_schema", None)
        for file_idx, subset in items:
            path = self.table.paths[file_idx]
            f = pq.ParquetFile(path)
            # SchemaAdapter (reference: datasource/schema_adapter.rs): a
            # file written before a column was added reads its present
            # columns and null-fills the rest; type drift casts up
            from ...datasource.schema_adapter import (adapt_table,
                                                      needs_adapting)
            file_schema = f.schema_arrow
            adapting = needs_adapting(file_schema, names, expected_arrow)
            read_cols = ([c for c in names if c in file_schema.names]
                         if adapting else names)
            keep_groups = self._prune_row_groups(
                f, path, rg_pruned, rg_matched, use_bloom, subset)
            if not keep_groups:
                continue
            try:
                pushdown = bool(ctx.config.get(
                    "datafusion.execution.parquet.pushdown_filters"))
            except Exception:  # noqa: BLE001
                pushdown = True
            pd_expr = self._pushdown_expr() if pushdown else None
            if pd_expr is not None:
                tbl = self._read_filtered(path, keep_groups, read_cols,
                                          pd_expr, partition, f)
                if tbl is not None:
                    if adapting:
                        tbl = adapt_table(tbl, names, expected_arrow)
                    if self.limit is not None and tbl.num_rows > self.limit:
                        tbl = tbl.slice(0, self.limit)
                    with m.elapsed_compute:
                        batch = arrow_table_to_batch(tbl, self._schema)
                    m.record_output(batch.num_rows)
                    yield batch
                    continue
            selections = self._page_index_selections(f, path, keep_groups,
                                                     partition)
            if selections is None:
                tbl = f.read_row_groups(keep_groups, columns=read_cols)
            else:
                import pyarrow as pa
                pieces = []
                for rg in keep_groups:
                    ranges = selections.get(rg)
                    if ranges == []:
                        continue            # every page pruned
                    t = f.read_row_groups([rg], columns=read_cols)
                    if ranges is None:
                        pieces.append(t)
                    else:
                        pieces.extend(t.slice(lo, hi - lo)
                                      for lo, hi in ranges)
                if not pieces:
                    continue
                tbl = pa.concat_tables(pieces)
            if adapting:
                tbl = adapt_table(tbl, names, expected_arrow)
            if self.limit is not None and tbl.num_rows > self.limit:
                tbl = tbl.slice(0, self.limit)
            with m.elapsed_compute:
                batch = arrow_table_to_batch(tbl, self._schema)
            m.record_output(batch.num_rows)
            yield batch

    def _read_filtered(self, path, keep_groups, read_cols, pd_expr,
                       partition, f):
        """Late-materialization read: Arrow decodes the predicate columns
        first and gathers only surviving rows of the rest
        (ParquetFileFragment.to_table(filter=...); reference
        row_filter.rs). Returns None to fall back to the plain read."""
        try:
            import pyarrow.dataset as pds
            from pyarrow.fs import LocalFileSystem
            fmt = pds.ParquetFileFormat()
            frag = fmt.make_fragment(os.path.abspath(path),
                                     filesystem=LocalFileSystem())
            total = sum(f.metadata.row_group(rg).num_rows
                        for rg in keep_groups)
            if len(keep_groups) < f.metadata.num_row_groups:
                frag = frag.subset(row_group_ids=keep_groups)
            tbl = frag.to_table(columns=read_cols, filter=pd_expr)
        except Exception:  # noqa: BLE001 — unsupported expr/type: full read
            return None
        self.metrics.counter("pushdown_rows_matched", partition) \
            .add(tbl.num_rows)
        self.metrics.counter("pushdown_rows_filtered", partition) \
            .add(max(total - tbl.num_rows, 0))
        return tbl

    def _pushdown_expr(self):
        """Translate supported filter conjuncts into one
        pyarrow.dataset expression for late-materialization scanning
        (reference: datasource/physical_plan/parquet/row_filter.rs —
        decode predicate columns first, apply, decode survivors only;
        Arrow's ParquetFileFragment.to_table(filter=...) performs that
        dance in C++). Unsupported conjuncts are simply left out: the
        FilterExec above re-applies the full predicate, so pushdown is
        purely an IO/decode reduction."""
        try:
            import pyarrow.compute as pc
        except Exception:  # noqa: BLE001
            return None
        from ...optimizer.predicate_utils import split_conjunction

        def lit(sv):
            # Decimals stay exact (pyarrow infers a decimal scalar); a
            # float approximation would move comparison boundaries
            return sv.value

        def to_pc(e):
            if isinstance(e, E.BinaryExpr) and e.op in (
                    Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
                a, b = e.left, e.right
                flip = {Op.LT: Op.GT, Op.GT: Op.LT, Op.LTEQ: Op.GTEQ,
                        Op.GTEQ: Op.LTEQ, Op.EQ: Op.EQ, Op.NEQ: Op.NEQ}
                if isinstance(a, E.Literal) and isinstance(b, E.Column):
                    a, b, op = b, a, flip[e.op]
                else:
                    op = e.op
                if not (isinstance(a, E.Column) and isinstance(b, E.Literal)):
                    return None
                v = lit(b.value)
                if v is None:
                    return None
                fld = pc.field(a.name)
                return {Op.EQ: fld == v, Op.NEQ: fld != v, Op.LT: fld < v,
                        Op.LTEQ: fld <= v, Op.GT: fld > v,
                        Op.GTEQ: fld >= v}[op]
            if isinstance(e, E.IsNull) and isinstance(e.expr, E.Column):
                fld = pc.field(e.expr.name)
                return fld.is_valid() if e.negated else ~fld.is_valid()
            if isinstance(e, E.InList) and isinstance(e.expr, E.Column) \
                    and not e.negated \
                    and all(isinstance(i, E.Literal) for i in e.items):
                vals = [lit(i.value) for i in e.items]
                if any(v is None for v in vals):
                    return None
                return pc.field(e.expr.name).isin(vals)
            return None

        parts = []
        for flt in self.filters:
            for c in split_conjunction(flt):
                p = to_pc(c)
                if p is not None:
                    parts.append(p)
        if not parts:
            return None
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out

    def _prune_row_groups(self, f, path, rg_pruned, rg_matched,
                          use_bloom: bool = True,
                          subset: Optional[List[int]] = None) -> List[int]:
        md = f.metadata
        n = md.num_row_groups
        candidates = subset if subset is not None else list(range(n))
        if not self.filters:
            return candidates
        eq_probes = self._bloom_eq_conjuncts() if use_bloom else {}
        rg_bloom = (self.metrics.counter("row_groups_pruned_bloom_filter", 0)
                    if eq_probes else None)
        keep = []
        for rg in candidates:
            rgm = md.row_group(rg)
            stats = {}
            blooms = {}
            for ci in range(rgm.num_columns):
                col = rgm.column(ci)
                name = col.path_in_schema.split(".")[0]
                s = col.statistics
                if s is not None and s.has_min_max:
                    stats[name] = (s.min, s.max)
                if name in eq_probes and col.bloom_filter_offset is not None:
                    blooms[name] = (col.bloom_filter_offset,
                                    col.bloom_filter_length,
                                    col.physical_type)
            if not all(_may_match(flt, stats) for flt in self.filters):
                rg_pruned.add(1)
                continue
            if blooms and not self._bloom_may_match(path, eq_probes, blooms,
                                                    rg_bloom):
                rg_pruned.add(1)
                continue
            keep.append(rg)
            rg_matched.add(1)
        return keep

    def _bloom_eq_conjuncts(self):
        """{column: [literal, ...]} for `col = literal` conjuncts — the
        only shape bloom filters can answer (reference:
        row_group_filter.rs BloomFilterPruningPredicate)."""
        from ...optimizer.predicate_utils import split_conjunction
        out = {}
        for flt in self.filters:
            for c in split_conjunction(flt):
                if not isinstance(c, E.BinaryExpr) or c.op != Op.EQ:
                    continue
                a, b = c.left, c.right
                if isinstance(b, E.Column) and isinstance(a, E.Literal):
                    a, b = b, a
                if isinstance(a, E.Column) and isinstance(b, E.Literal) \
                        and b.value.value is not None:
                    out.setdefault(a.name, []).append(b.value.value)
        return out

    def _bloom_may_match(self, path, eq_probes, blooms, rg_bloom) -> bool:
        """Probe each equality literal against the row group's bloom
        filter; a definitive miss prunes the group (reference:
        parquet/row_group_filter.rs + SBBF spec)."""
        from ...datasource.bloom import read_bloom_filter
        for name, values in eq_probes.items():
            if name not in blooms:
                continue
            offset, length, ptype = blooms[name]
            try:
                sb = read_bloom_filter(path, offset, length)
            except Exception:  # noqa: BLE001 — unreadable filter: keep
                continue
            if sb is None:
                continue
            for v in values:
                if sb.might_contain(v, ptype) is False:
                    if rg_bloom is not None:
                        rg_bloom.add(1)
                    return False
        return True

    def _page_index_selections(self, f, path, keep_groups, partition):
        """Page-index pruning (reference: parquet/page_filter.rs): map each
        predicate conjunct over per-page min/max; returns {rg: row ranges}
        (None value = whole group; [] = fully pruned; missing = whole
        group), or None when the file has no usable page index."""
        if not self.filters:
            return None
        from ...datasource.page_index import read_page_index
        from ...optimizer.predicate_utils import split_conjunction
        try:
            index, rg_rows = read_page_index(path)
        except Exception:  # noqa: BLE001 — malformed index: no pruning
            return None
        if not index:
            return None
        pages_pruned = self.metrics.counter("page_index_rows_pruned", partition)
        conjuncts = [c for flt in self.filters for c in split_conjunction(flt)]
        out = {}
        any_pruned = False
        for rg in keep_groups:
            n_rows = rg_rows.get(rg, 0)
            keep = None                    # None = all rows survive so far
            for c in conjuncts:
                col = _conjunct_column(c)
                if col is None or (rg, col) not in index:
                    continue
                mins, maxs, null_pages, first = index[(rg, col)]
                mask = np.zeros(n_rows, bool)
                for p in range(len(first)):
                    lo = first[p]
                    hi = first[p + 1] if p + 1 < len(first) else n_rows
                    if null_pages[p]:
                        continue           # all-NULL page can't match c<op>lit
                    if _conjunct_may_match(c, {col: (mins[p], maxs[p])}):
                        mask[lo:hi] = True
                keep = mask if keep is None else (keep & mask)
            if keep is None:
                continue
            if keep.all():
                continue
            any_pruned = True
            pages_pruned.add(int(n_rows - keep.sum()))
            # boolean mask -> [lo, hi) ranges
            d = np.flatnonzero(np.diff(np.concatenate(
                [[False], keep, [False]]).astype(np.int8)))
            out[rg] = list(zip(d[::2].tolist(), d[1::2].tolist()))
        return out if any_pruned else None

    def display_line(self):
        proj = ", ".join(self._schema.names())
        parts = (f", partitions={len(self._assignments)}"
                 if self._assignments is not None else "")
        return (f"ParquetScanExec: files={len(self.table.paths)}{parts}, "
                f"projection=[{proj}]")


def _conjunct_column(c: E.Expr):
    """Column name of a `col <op> literal` conjunct, else None."""
    if not isinstance(c, E.BinaryExpr):
        return None
    if isinstance(c.left, E.Column) and isinstance(c.right, E.Literal):
        return c.left.name
    if isinstance(c.right, E.Column) and isinstance(c.left, E.Literal):
        return c.right.name
    return None


def _may_match(pred: E.Expr, stats: dict) -> bool:
    """Conservative PruningPredicate: False only when the row group
    provably contains no matching row (reference: pruning.rs:463 rewrites
    the predicate over min/max columns; this evaluates the common
    col <op> literal shapes directly)."""
    from ...optimizer.predicate_utils import split_conjunction
    for c in split_conjunction(pred):
        r = _conjunct_may_match(c, stats)
        if r is False:
            return False
    return True


def _conjunct_may_match(c: E.Expr, stats: dict):
    if not isinstance(c, E.BinaryExpr):
        return True
    a, b = c.left, c.right
    op = c.op
    if isinstance(a, E.Literal) and isinstance(b, E.Column):
        a, b = b, a
        flip = {Op.LT: Op.GT, Op.LTEQ: Op.GTEQ, Op.GT: Op.LT, Op.GTEQ: Op.LTEQ}
        op = flip.get(op, op)
    if not (isinstance(a, E.Column) and isinstance(b, E.Literal)):
        return True
    if a.name not in stats:
        return True
    mn, mx = stats[a.name]
    v = b.value.value
    if v is None or mn is None or mx is None:
        return True
    try:
        import datetime
        if isinstance(v, datetime.date) and isinstance(mn, (int, np.integer)):
            v = (v - datetime.date(1970, 1, 1)).days
        from decimal import Decimal
        if isinstance(v, Decimal):
            v = float(v)
            mn, mx = float(mn), float(mx)
        if op == Op.EQ:
            return mn <= v <= mx
        if op == Op.LT:
            return mn < v
        if op == Op.LTEQ:
            return mn <= v
        if op == Op.GT:
            return mx > v
        if op == Op.GTEQ:
            return mx >= v
    except TypeError:
        return True
    return True


class CsvScanExec(ExecutionPlan):
    def __init__(self, table, projection: Optional[List[int]],
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(max(1, len(self.table.paths)))

    def unbounded(self) -> bool:
        return bool(getattr(self.table, "unbounded", False))

    def output_ordering(self):
        o = self.output_orderings()
        return o[0] if o else None

    def output_orderings(self):
        # declared WITH ORDER clauses, one ordering each (reference:
        # CREATE EXTERNAL TABLE ... WITH ORDER, listing table orderings)
        orders = getattr(self.table, "with_order", None)
        if not orders:
            return []
        names = self._schema.names()
        out = []
        for spec in orders:
            cur = []
            for col, asc in spec:
                if col not in names:
                    break   # projection dropped it; the prefix stays valid
                cur.append((f"{col}@{names.index(col)}", asc, not asc))
            if cur:
                out.append(cur)
        return out

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import pyarrow.csv as pcsv
        m = BaselineMetrics(self.metrics, partition)
        t = self.table
        if t.has_header and getattr(t, "explicit_schema", False):
            # declared schema + header row: skip the header, use the
            # declared names (reference: CsvReadOptions.schema + has_header)
            ro = pcsv.ReadOptions(column_names=t.schema().names(),
                                  skip_rows=1)
        elif t.has_header:
            ro = pcsv.ReadOptions()
        else:
            # headerless file with a declared schema: supply the column
            # names so downstream select-by-name works (reference:
            # CsvFormat reads with the table schema, csv/mod.rs)
            ro = pcsv.ReadOptions(column_names=t.schema().names())
        po = pcsv.ParseOptions(delimiter=t.delimiter)
        # pin declared integer column types: pyarrow would otherwise infer
        # uint64-range values as float64 and lose precision before the
        # schema cast (reference: CsvFormat decodes with the table schema)
        import pyarrow as pa
        _pin_pa = {"int8": pa.int8(), "int16": pa.int16(),
                   "int32": pa.int32(), "int64": pa.int64(),
                   "uint8": pa.uint8(), "uint16": pa.uint16(),
                   "uint32": pa.uint32(), "uint64": pa.uint64(),
                   "string": pa.string(), "largestring": pa.string()}
        ctypes = {f.name: _pin_pa[f.dtype.id.value]
                  for f in t.schema().fields
                  if getattr(t, "explicit_schema", False)
                  and f.dtype.id.value in _pin_pa}
        co = pcsv.ConvertOptions(column_types=ctypes) if ctypes else None
        tbl = pcsv.read_csv(t.paths[partition], read_options=ro,
                            parse_options=po, convert_options=co)
        tbl = tbl.select(self._schema.names())
        if self.limit is not None and tbl.num_rows > self.limit:
            tbl = tbl.slice(0, self.limit)
        batch = arrow_table_to_batch(tbl, self._schema)
        m.record_output(batch.num_rows)
        yield batch

    def display_line(self):
        return f"CsvScanExec: files={len(self.table.paths)}"


class JsonScanExec(ExecutionPlan):
    def __init__(self, table, projection: Optional[List[int]],
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(max(1, len(self.table.paths)))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import pyarrow.json as pjson
        m = BaselineMetrics(self.metrics, partition)
        tbl = pjson.read_json(self.table.paths[partition])
        tbl = tbl.select(self._schema.names())
        if self.limit is not None and tbl.num_rows > self.limit:
            tbl = tbl.slice(0, self.limit)
        batch = arrow_table_to_batch(tbl, self._schema)
        m.record_output(batch.num_rows)
        yield batch

    def display_line(self):
        return f"JsonScanExec: files={len(self.table.paths)}"


class OrcScanExec(ExecutionPlan):
    """ORC file scan with column projection (bonus format beyond the
    reference's parquet/csv/json/avro set — pyarrow ships an ORC reader
    while this image has no Avro decoder)."""

    def __init__(self, table, projection: Optional[List[int]],
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(max(1, len(self.table.paths)))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import pyarrow.orc as porc
        m = BaselineMetrics(self.metrics, partition)
        f = porc.ORCFile(self.table.paths[partition])
        tbl = f.read(columns=self._schema.names())
        if self.limit is not None and tbl.num_rows > self.limit:
            tbl = tbl.slice(0, self.limit)
        batch = arrow_table_to_batch(tbl, self._schema)
        m.record_output(batch.num_rows)
        yield batch

    def display_line(self):
        return f"OrcScanExec: files={len(self.table.paths)}"


class AvroScanExec(ExecutionPlan):
    """Avro scan (reference: AvroExec `datasource/physical_plan/avro.rs:101`
    using the embedded avro_to_arrow decoder)."""

    def __init__(self, table, projection: Optional[List[int]],
                 limit: Optional[int] = None):
        super().__init__()
        self.table = table
        self.projection = projection
        self.limit = limit
        base = table.schema()
        self._schema = base.project(projection) if projection is not None else base

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(max(1, len(self.table.paths)))

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from ...datasource.avro import avro_to_arrow
        m = BaselineMetrics(self.metrics, partition)
        tbl = avro_to_arrow(self.table.paths[partition])
        tbl = tbl.select(self._schema.names())
        if self.limit is not None and tbl.num_rows > self.limit:
            tbl = tbl.slice(0, self.limit)
        with m.elapsed_compute:
            batch = arrow_table_to_batch(tbl, self._schema)
        m.record_output(batch.num_rows)
        yield batch

    def display_line(self):
        return f"AvroScanExec: files={len(self.table.paths)}"
