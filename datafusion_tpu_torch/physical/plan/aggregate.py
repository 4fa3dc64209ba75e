"""AggregateExec — hash aggregation with two-phase modes.

Reference parity: `datafusion/physical-plan/src/aggregates/mod.rs:241`
(AggregateMode Partial/Final/FinalPartitioned/Single `mod.rs:64-84`) and the
GroupedHashAggregateStream hot loop (`aggregates/row_hash.rs:207,524`):
GroupValues::intern maps keys to dense group ids, accumulators scatter-add
with those ids. Here interning is vectorized factorization
(`physical/hashing.py`); accumulator state is dense per-group tensors —
the same layout the TPU segment-reduce path uses.
"""
from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ...common.batch import Batch
from ...common.column import Column, concat_columns
from ...common.schema import Field, Schema
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from ..aggregates import CollectingAcc, GroupsAccumulator, create_accumulator
from ..expressions import PhysicalExpr
from ..hashing import factorize
from .base import ExecutionPlan, Partitioning


class AggregateMode(enum.Enum):
    PARTIAL = "Partial"
    FINAL = "Final"
    FINAL_PARTITIONED = "FinalPartitioned"
    SINGLE = "Single"
    SINGLE_PARTITIONED = "SinglePartitioned"

    @property
    def is_first_stage(self) -> bool:
        return self in (AggregateMode.PARTIAL, AggregateMode.SINGLE,
                        AggregateMode.SINGLE_PARTITIONED)

    @property
    def is_final_stage(self) -> bool:
        return self in (AggregateMode.FINAL, AggregateMode.FINAL_PARTITIONED,
                        AggregateMode.SINGLE, AggregateMode.SINGLE_PARTITIONED)


class PhysAggregateExpr:
    """One aggregate call: accumulator factory + bound argument/filter
    expressions (reference: AggregateExpr trait in physical-expr)."""

    def __init__(self, name: str, args: List[PhysicalExpr], out_type,
                 display: str, distinct: bool = False,
                 filter: Optional[PhysicalExpr] = None,
                 count_star: bool = False, order_by=None,
                 ignore_nulls: bool = False):
        self.name = name
        self.args = args
        self.out_type = out_type
        self.display = display
        self.distinct = distinct
        self.filter = filter
        self.count_star = count_star
        self.order_by = order_by or []   # List[PhysSortExpr]
        self.ignore_nulls = ignore_nulls

    def make_accumulator(self) -> GroupsAccumulator:
        acc = create_accumulator(
            self.name, [a.out_type for a in self.args], self.out_type,
            distinct=self.distinct, count_star=self.count_star,
            ignore_nulls=self.ignore_nulls)
        if self.order_by:
            acc.order_specs = [(s.asc, s.nulls_first) for s in self.order_by]
        return acc

    def __str__(self):
        return self.display


class GroupValues:
    """Incremental multi-column key interning with stable first-appearance
    group ids (reference: aggregates/group_values/row.rs)."""

    def __init__(self, num_keys: int):
        self.num_keys = num_keys
        self.uniq: Optional[List[Column]] = None
        self.n_groups = 0

    def intern(self, key_cols: List[Column], n_rows: int) -> np.ndarray:
        if self.num_keys == 0:
            self.n_groups = 1
            return np.zeros(n_rows, np.int64)
        if self.uniq is None:
            ids, first_rows, g = factorize(key_cols, n_rows)
            self.uniq = [c.take_host(first_rows) for c in key_cols]
            self.n_groups = g
            return ids
        prev_g = self.n_groups
        combined = [concat_columns([u, c]) for u, c in zip(self.uniq, key_cols)]
        total = prev_g + n_rows
        ids, first_rows, g = factorize(combined, total)
        if g > prev_g:
            new_rows = first_rows[prev_g:]
            self.uniq = [c.take_host(np.concatenate(
                [np.arange(prev_g), new_rows])) for c in combined]
            self.n_groups = g
        return ids[prev_g:]

    def keys(self) -> List[Column]:
        return self.uniq or []


def group_sort_bytes(key_cols: List[Column], n: int) -> np.ndarray:
    """Value-deterministic lexicographic byte encoding of group keys: an
    'S<w>' array whose np order is a total order consistent across runs
    (same key value -> same bytes, regardless of dictionary codes). Used
    to sort spilled partial state and pick merge-round thresholds
    (reference: row_hash.rs:436 sorts spilled state by group columns)."""
    parts: List[np.ndarray] = []
    for c in key_cols:
        v = c.validity_host()
        if c.dtype.is_string:
            codes = np.asarray(c.data_host()[:n])
            if c.dictionary is not None:
                vals = np.asarray(c.dictionary.values)[
                    np.clip(codes, 0, max(0, len(c.dictionary) - 1))]
            else:
                vals = codes
            sb = np.array([x.encode("utf-8") if isinstance(x, str)
                           else bytes(x) for x in vals.tolist()], dtype="S")
            if sb.dtype.itemsize == 0:
                sb = sb.astype("S1")
            w = sb.dtype.itemsize
            mat = sb.view(np.uint8).reshape(n, w)
            rank = (np.ones(n, np.uint8) if v is None
                    else v[:n].astype(np.uint8))
            if v is not None:
                mat = np.where(v[:n, None], mat, np.uint8(0))
            parts.append(rank.reshape(n, 1))
            parts.append(mat)
        else:
            from .sort import order_keys
            col = Column(c.dtype, c.data_host()[:n],
                         None if v is None else v[:n], c.dictionary)
            for word in order_keys(col, True, True):
                be = word.astype(word.dtype.newbyteorder(">"))
                parts.append(be.view(np.uint8).reshape(n, be.dtype.itemsize))
    if not parts:
        return np.zeros(n, "S1")
    mat = np.concatenate(parts, axis=1)
    return np.ascontiguousarray(mat).view(f"S{mat.shape[1]}").ravel()


class AggregateExec(ExecutionPlan):
    def __init__(self, mode: AggregateMode,
                 group_exprs: List[Tuple[PhysicalExpr, str]],
                 aggr_exprs: List[PhysAggregateExpr],
                 input: ExecutionPlan,
                 input_schema: Optional[Schema] = None):
        super().__init__()
        self.mode = mode
        self.group_exprs = group_exprs
        self.aggr_exprs = aggr_exprs
        self.input = input
        fields: List[Field] = []
        in_schema = input.schema()
        for e, name in group_exprs:
            from ..expressions import ColumnExpr
            q = in_schema.field(e.index).qualifier if isinstance(e, ColumnExpr) else None
            fields.append(Field(name, e.out_type, True, qualifier=q))
        if mode == AggregateMode.PARTIAL:
            for a in aggr_exprs:
                acc = a.make_accumulator()
                fields.extend(acc.state_fields(a.display))
        else:
            for a in aggr_exprs:
                fields.append(Field(a.display, a.out_type, True))
        self._schema = Schema(fields)
        self._n_state_cols = None
        self._spill_schema = None

    def schema(self):
        return self._schema

    def children(self):
        return [self.input]

    def with_children(self, c):
        return AggregateExec(self.mode, self.group_exprs, self.aggr_exprs, c[0])

    def output_partitioning(self):
        if self.mode in (AggregateMode.PARTIAL,):
            return self.input.output_partitioning()
        return Partitioning.unknown(self.input.output_partitioning().n)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from ...common.errors import ResourcesExhausted
        from ...runtime import MemoryReservation
        m = BaselineMetrics(self.metrics, partition)
        spill_count = self.metrics.counter("spill_count", partition)
        gv = GroupValues(len(self.group_exprs))
        accs = [a.make_accumulator() for a in self.aggr_exprs]
        reservation = MemoryReservation("AggregateExec", ctx.memory_pool,
                                        can_spill=True)
        disk = ctx.runtime.disk_manager
        spills = []

        final_merge = self.mode in (AggregateMode.FINAL,
                                    AggregateMode.FINAL_PARTITIONED)
        for batch in self.input.execute(partition, ctx):
            m.record_bytes(batch.nbytes())   # host-path bytes touched
            with m.elapsed_compute:
                if final_merge:
                    self._merge_batch(batch, gv, accs)
                else:
                    self._update_batch(batch, gv, accs)
                if self.group_exprs:
                    try:
                        reservation.resize(self._state_nbytes(gv))
                    except ResourcesExhausted:
                        # spill the sorted partial state and start a fresh
                        # hash table (reference: row_hash.rs:436-604
                        # spill_previous_if_necessary)
                        can = (disk is not None
                               and all(acc.supports_two_phase()
                                       for acc in accs))
                        if not can:
                            reservation.free()
                            raise
                        try:
                            spilled = self._spill_state(gv, accs, disk)
                        except Exception:
                            reservation.free()
                            raise ResourcesExhausted(
                                "aggregation state exceeds the memory pool "
                                "and is not spillable") from None
                        spills.append(spilled)
                        spill_count.add(1)
                        reservation.resize(0)
                        gv = GroupValues(len(self.group_exprs))
                        accs = [a.make_accumulator() for a in self.aggr_exprs]

        if spills:
            with m.elapsed_compute:
                if gv.n_groups:
                    spills.append(self._spill_state(gv, accs, disk))
            try:
                yield from self._emit_merged_spills(spills, m)
            finally:
                reservation.free()
            return

        with m.elapsed_compute:
            out = self._emit_groups(gv, accs)
        reservation.free()
        if out is None:
            return
        m.record_output(out.num_rows)
        yield out

    def _emit_groups(self, gv: GroupValues,
                     accs: List[GroupsAccumulator]) -> Optional[Batch]:
        n_groups = gv.n_groups
        if len(self.group_exprs) == 0:
            n_groups = 1   # scalar aggregate: one output row even on empty input
        if n_groups == 0:
            return None
        cols: List[Column] = []
        if self.group_exprs:
            keys = gv.keys()
            if not keys:
                return None
            cols.extend(keys)
        if self.mode == AggregateMode.PARTIAL:
            for acc in accs:
                cols.extend(acc.state(n_groups))
        else:
            for acc in accs:
                cols.append(acc.evaluate(n_groups))
        return Batch(self._schema, cols, n_groups)

    # ---- spill path ---------------------------------------------------------
    def _state_nbytes(self, gv: GroupValues) -> int:
        """Cheap monotone estimate of in-memory aggregation state: group
        key bytes + 16B per state column per group (reference tracks the
        exact allocation via MemoryReservation; the estimate only needs to
        grow with group count to trigger the spill)."""
        total = 0
        for c in (gv.uniq or []):
            d = c.data_host()
            total += d.nbytes if d.dtype != object else 64 * len(d)
        if self._n_state_cols is None:
            cnt = 0
            for a in self.aggr_exprs:
                try:
                    cnt += len(a.make_accumulator().state_fields(a.display))
                except NotImplementedError:
                    cnt += 1   # single-phase acc (not spillable anyway)
            self._n_state_cols = cnt
        return total + gv.n_groups * 16 * max(1, self._n_state_cols)

    def _partial_schema(self) -> Schema:
        fields: List[Field] = []
        in_schema = self.input.schema()
        for e, name in self.group_exprs:
            from ..expressions import ColumnExpr
            q = (in_schema.field(e.index).qualifier
                 if isinstance(e, ColumnExpr) else None)
            fields.append(Field(name, e.out_type, True, qualifier=q))
        for a in self.aggr_exprs:
            fields.extend(a.make_accumulator().state_fields(a.display))
        return Schema(fields)

    def _spill_state(self, gv: GroupValues, accs: List[GroupsAccumulator],
                     disk):
        """Materialize partial state sorted by group key and write it out
        (reference: row_hash.rs spill — sort_batch by group columns +
        write_spill)."""
        from .spill import SpilledBatch
        n = gv.n_groups
        cols = list(gv.keys())
        for acc in accs:
            cols.extend(acc.state(n))
        if self._spill_schema is None:
            self._spill_schema = self._partial_schema()
        enc = group_sort_bytes(cols[: len(self.group_exprs)], n)
        order = np.argsort(enc, kind="stable")
        b = Batch(self._spill_schema, cols, n).take_host(order)
        return SpilledBatch(disk, b)

    def _emit_merged_spills(self, spills, m) -> Iterator[Batch]:
        """Streaming merge of sorted spilled runs: each round consumes all
        rows <= the smallest chunk-end key across runs, so every group in
        a round is complete and emits immediately — memory stays bounded
        by runs x chunk (reference: row_hash.rs:546 update_merged_stream:
        streaming_merge over spills + merge back through the accumulators
        in sorted order)."""
        k = len(self.group_exprs)
        runs = [s.load() for s in spills]
        encs = [group_sort_bytes(r.columns[:k], r.num_rows) for r in runs]
        # encoding widths can differ per run (string keys); numpy compares
        # 'S' values with zero padding, so cast all to the widest
        width = max(e.dtype.itemsize for e in encs)
        encs = [e.astype(f"S{width}") for e in encs]
        pos = [0] * len(runs)
        CHUNK = 1 << 16
        while True:
            active = [i for i in range(len(runs)) if pos[i] < runs[i].num_rows]
            if not active:
                return
            with m.elapsed_compute:
                thr = min(encs[i][min(pos[i] + CHUNK, runs[i].num_rows) - 1]
                          for i in active)
                gv = GroupValues(k)
                accs = [a.make_accumulator() for a in self.aggr_exprs]
                for i in active:
                    end = min(pos[i] + CHUNK, runs[i].num_rows)
                    cut = pos[i] + int(np.searchsorted(
                        encs[i][pos[i]: end], thr, side="right"))
                    if cut > pos[i]:
                        part = runs[i].take_host(np.arange(pos[i], cut))
                        self._merge_spilled(part, gv, accs)
                        pos[i] = cut
                out = self._emit_groups(gv, accs)
            if out is not None and out.num_rows:
                m.record_output(out.num_rows)
                yield out

    # ---- first stage: raw input -------------------------------------------
    def _update_batch(self, batch: Batch, gv: GroupValues,
                      accs: List[GroupsAccumulator]):
        keys = [e.evaluate(batch) for e, _ in self.group_exprs]
        ids = gv.intern(keys, batch.num_rows)
        n_groups = gv.n_groups if self.group_exprs else 1
        for a, acc in zip(self.aggr_exprs, accs):
            vals = [arg.evaluate(batch) for arg in a.args]
            ocols = [s.expr.evaluate(batch) for s in a.order_by] \
                if a.order_by and isinstance(acc, CollectingAcc) else None
            use_ids = ids
            if a.filter is not None:
                fmask = K.true_mask(a.filter.evaluate(batch))
                use_ids = ids[fmask]
                vals = [v.filter_host(fmask) for v in vals]
                if ocols:
                    ocols = [o.filter_host(fmask) for o in ocols]
            if ocols:
                acc.update(vals, use_ids, n_groups, order_cols=ocols)
            else:
                acc.update(vals, use_ids, n_groups)

    def _merge_spilled(self, batch: Batch, gv: GroupValues,
                       accs: List[GroupsAccumulator]):
        """Merge a chunk of spilled partial state. Unlike `_merge_batch`,
        keys are the chunk's leading columns (spilled layout), not
        `group_exprs` evaluated over the operator's input schema."""
        k = len(self.group_exprs)
        ids = gv.intern(list(batch.columns[:k]), batch.num_rows)
        n_groups = gv.n_groups if self.group_exprs else 1
        col_idx = k
        for a, acc in zip(self.aggr_exprs, accs):
            n_state = len(acc.state_fields(a.display))
            states = batch.columns[col_idx: col_idx + n_state]
            col_idx += n_state
            acc.merge(states, ids, n_groups)

    # ---- final stage: merge partial state ------------------------------------
    def _merge_batch(self, batch: Batch, gv: GroupValues,
                     accs: List[GroupsAccumulator]):
        k = len(self.group_exprs)
        keys = [e.evaluate(batch) for e, _ in self.group_exprs]
        ids = gv.intern(keys, batch.num_rows)
        n_groups = gv.n_groups if self.group_exprs else 1
        col_idx = k
        for a, acc in zip(self.aggr_exprs, accs):
            n_state = len(acc.state_fields(a.display))
            states = batch.columns[col_idx: col_idx + n_state]
            col_idx += n_state
            acc.merge(states, ids, n_groups)

    def display_line(self):
        gb = ", ".join(f"{n}" for _, n in self.group_exprs)
        ag = ", ".join(str(a) for a in self.aggr_exprs)
        return f"AggregateExec: mode={self.mode.value}, gby=[{gb}], aggr=[{ag}]"


class LeftCountZeroFillExec(ExecutionPlan):
    """Emit half of the count-over-LEFT-join rewrite (TPC-H Q13 shape;
    see physical_optimizer._try_fuse_left_count): the input aggregates
    the RIGHT side grouped by its join key; this exec appends one
    zero-count row per LEFT key with no match — exactly what the LEFT
    join's null-extended rows would have contributed to count(right)."""

    def __init__(self, input: ExecutionPlan, left: ExecutionPlan,
                 left_key: PhysicalExpr, schema: Schema):
        super().__init__()
        self.input = input
        self.left = left
        self.left_key = left_key
        self._schema = schema

    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return [self.input, self.left]

    def with_children(self, c):
        return LeftCountZeroFillExec(c[0], c[1], self.left_key,
                                     self._schema)

    def output_partitioning(self):
        from .base import Partitioning
        return Partitioning.unknown(1)

    def display_line(self):
        return f"LeftCountZeroFillExec: left_key={self.left_key}"

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from .base import collect_batch
        m = BaselineMetrics(self.metrics, partition)
        with m.elapsed_compute:
            agg = collect_batch(self.input, ctx)
            lb = collect_batch(self.left, ctx)
            lk = self.left_key.evaluate(lb)
            lkeys = lk.data_host()[:lb.num_rows]
            v = lk.validity_host()
            if v is not None:
                lkeys = lkeys[v[:lb.num_rows]]
            akeys = agg.columns[0].data_host()[:agg.num_rows]
            luniq = np.unique(lkeys)
            # LEFT join semantics: only LEFT keys appear — drop aggregate
            # groups for right keys with no left match, zero-fill left
            # keys with no right match
            keep = np.nonzero(np.isin(akeys, luniq))[0]
            missing = np.setdiff1d(luniq, akeys)
            cols = []
            for i, f in enumerate(self._schema):
                base = agg.columns[i]
                kept = base.take_host(keep)
                if i == 0:
                    extra = Column(base.dtype,
                                   missing.astype(base.data_host().dtype),
                                   None, base.dictionary)
                else:
                    extra = Column(base.dtype,
                                   np.zeros(len(missing),
                                            base.data_host().dtype),
                                   None, base.dictionary)
                cols.append(concat_columns([kept, extra]))
            out = Batch(self._schema, cols, len(keep) + len(missing))
        m.record_output(out.num_rows)
        yield out
