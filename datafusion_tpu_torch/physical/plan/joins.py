"""Join operators: HashJoinExec (all 8 join types), NestedLoopJoinExec,
CrossJoinExec.

Reference parity: `joins/hash_join.rs:298` (CollectLeft/Partitioned modes,
build + probe state machine, `lookup_join_hashmap` + `equal_rows_arr`
collision check), `joins/nested_loop_join.rs:261`, `joins/cross_join.rs:197`.

Host-path algorithm: the build side's key hashes are sorted once
(`argsort`), probes binary-search the sorted hash array
(vectorized `searchsorted`) and expand candidate ranges with
repeat/cumsum — a fully vectorized equivalent of the reference's chained
hash map walk, with the same exact-equality collision verification.
NULL join keys never match (SQL semantics); they are excluded from the
build index entirely.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ...common.batch import Batch, concat_batches
from ...common.column import Column
from ...common.errors import internal
from ...common.schema import Schema
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from ..expressions import PhysicalExpr
from ..hashing import create_hashes
from .base import ExecutionPlan, Partitioning

JOIN_TYPES = ("INNER", "LEFT", "RIGHT", "FULL",
              "LEFTSEMI", "LEFTANTI", "RIGHTSEMI", "RIGHTANTI")


def join_schema(left: Schema, right: Schema, join_type: str) -> Schema:
    import dataclasses
    if join_type in ("LEFTSEMI", "LEFTANTI"):
        return left
    if join_type in ("RIGHTSEMI", "RIGHTANTI"):
        return right
    lf = list(left.fields)
    rf = list(right.fields)
    if join_type in ("RIGHT", "FULL"):
        lf = [dataclasses.replace(f, nullable=True) for f in lf]
    if join_type in ("LEFT", "FULL"):
        rf = [dataclasses.replace(f, nullable=True) for f in rf]
    return Schema(lf + rf)


def _null_columns(schema: Schema, n: int) -> List[Column]:
    out = []
    for f in schema:
        from ...common.column import Dictionary
        dic = Dictionary(np.array([], dtype=object)) if f.dtype.is_string else None
        out.append(Column(f.dtype, np.zeros(n, f.dtype.device_dtype()),
                          np.zeros(n, bool), dic))
    return out


class _BuildSide:
    """Collected build input + sorted hash index + visited bitmap
    (reference: JoinLeftData, hash_join.rs:84)."""

    def __init__(self, batch: Batch, key_cols: List[Column],
                 null_equals_null: bool = False):
        self.batch = batch
        self.key_cols = key_cols
        n = batch.num_rows
        if key_cols:
            hashes = create_hashes(key_cols, n)
            valid = np.ones(n, bool)
            if not null_equals_null:
                for c in key_cols:
                    v = c.validity_host()
                    if v is not None:
                        valid &= v[:n]   # columns may be capacity-padded
        else:
            hashes = np.zeros(n, np.uint64)
            valid = np.ones(n, bool)
        self.rows = np.nonzero(valid)[0]
        h = hashes[self.rows]
        order = np.argsort(h, kind="stable")
        self.sorted_hashes = h[order]
        self.sorted_rows = self.rows[order]
        self.visited = np.zeros(n, bool)
        # direct-address index for a single bounded-span integer key:
        # probe becomes two O(1) table gathers (start, count) instead of
        # two binary searches over the sorted hashes, and the exact-key
        # verification pass is unnecessary (no hashing at all).
        # Reference contrast: hash_join.rs always hashes.
        self.direct = None
        if len(key_cols) == 1 and not key_cols[0].dtype.is_string and \
                key_cols[0].dtype.is_integer and len(self.rows):
            k = key_cols[0].data_host()[:n][self.rows].astype(np.int64)
            klo = int(k.min())
            span = int(k.max()) - klo + 1
            if span <= max(4 * len(k), 1 << 16) and span <= (1 << 26):
                kb = (k - klo).astype(np.int64)
                korder = np.argsort(kb, kind="stable")
                counts = np.bincount(kb, minlength=span)
                starts = np.concatenate(
                    [[0], np.cumsum(counts)[:-1]]).astype(np.int64)
                self.direct = (klo, span, starts, counts.astype(np.int64),
                               self.rows[korder])


class HashJoinExec(ExecutionPlan):
    """Equi hash join. CollectLeft mode: the left (build) side is collected
    once and probed by every right partition — the broadcast join of the
    distributed path."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 on: List[Tuple[PhysicalExpr, PhysicalExpr]],
                 join_type: str = "INNER",
                 filter: Optional[PhysicalExpr] = None,
                 filter_schema: Optional[Schema] = None,
                 partition_mode: str = "CollectLeft",
                 null_equals_null: bool = False):
        super().__init__()
        assert join_type in JOIN_TYPES, join_type
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter
        # filter is compiled against left_schema + right_schema concatenation
        self.filter_schema = filter_schema
        self.partition_mode = partition_mode
        self.null_equals_null = null_equals_null
        self._schema = join_schema(left.schema(), right.schema(), join_type)
        self._build: Optional[_BuildSide] = None

    def schema(self):
        return self._schema

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return HashJoinExec(c[0], c[1], self.on, self.join_type, self.filter,
                            self.filter_schema, self.partition_mode,
                            self.null_equals_null)

    def output_partitioning(self):
        return Partitioning.unknown(self.right.output_partitioning().n)

    def equivalence_properties(self):
        """INNER joins equate the equi-keys across sides and carry both
        children's classes/constants into the output column space
        (reference: join_equivalence_properties, properties.rs:2137)."""
        from ..equivalence import EquivalenceProperties
        from ..expressions import ColumnExpr
        jt = self.join_type
        if jt == "INNER":
            nleft = len(self.left.schema().fields)
            on_pairs = [(str(l), f"{r.name}@{r.index + nleft}")
                        for l, r in self.on
                        if isinstance(l, ColumnExpr)
                        and isinstance(r, ColumnExpr)]
            return EquivalenceProperties.join(
                self.left.equivalence_properties(),
                self.right.equivalence_properties(), nleft, on_pairs,
                self.output_orderings())
        if jt in ("LEFTSEMI", "LEFTANTI"):
            p = self.left.equivalence_properties().copy()
            p.orderings = [list(o) for o in self.output_orderings()]
            return p
        if jt in ("RIGHTSEMI", "RIGHTANTI"):
            p = self.right.equivalence_properties().copy()
            p.orderings = [list(o) for o in self.output_orderings()]
            return p
        return EquivalenceProperties(orderings=self.output_orderings())

    def reset_state(self):
        # CollectLeft build + visited bitmap are per-execution (ref OnceAsync
        # lives in stream state); RecursiveQueryExec resets before re-execute.
        self._build = None

    def _collect_build(self, ctx: TaskContext, partition: Optional[int]) -> _BuildSide:
        from .base import execute_stream
        from ...runtime import MemoryReservation
        schema = self.left.schema()
        reservation = MemoryReservation("HashJoinExec[build]", ctx.memory_pool)
        if partition is None:
            batches = []
            for b in execute_stream(self.left, ctx):
                reservation.try_grow(b.nbytes())
                batches.append(b)
        else:
            batches = []
            for b in self.left.execute(partition, ctx):
                reservation.try_grow(b.nbytes())
                batches.append(b)
        batch = concat_batches(schema, batches)
        keys = [l.evaluate(batch) for l, _ in self.on]
        side = _BuildSide(batch, keys, self.null_equals_null)
        side.reservation = reservation
        return side

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        if self.partition_mode == "CollectLeft":
            # share the build across probe partitions (OnceAsync analog)
            if self._build is None:
                self._build = self._collect_build(ctx, None)
            build = self._build
        else:
            build = self._collect_build(ctx, partition)

        probe_outer = self.join_type in ("RIGHT", "FULL")
        emit_pairs = self.join_type in ("INNER", "LEFT", "RIGHT", "FULL")

        for pb in self.right.execute(partition, ctx):
            m.record_bytes(pb.nbytes())     # host-path bytes touched
            with m.elapsed_compute:
                b_rows, p_rows, matched_probe = self._probe(build, pb)
                outs = []
                if emit_pairs and len(b_rows):
                    outs.append(self._emit_pairs(build.batch, pb, b_rows, p_rows))
                if probe_outer:
                    un = np.nonzero(~matched_probe)[0]
                    if len(un):
                        outs.append(self._emit_probe_unmatched(pb, un))
                if self.join_type == "RIGHTSEMI":
                    sel = np.nonzero(matched_probe)[0]
                    if len(sel):
                        outs.append(pb.take_host(sel))
                if self.join_type == "RIGHTANTI":
                    sel = np.nonzero(~matched_probe)[0]
                    if len(sel):
                        outs.append(pb.take_host(sel))
            for o in outs:
                m.record_output(o.num_rows)
                yield o

        # post-probe emission from the build side (visited bitmap)
        last = self.partition_mode != "CollectLeft" or \
            partition == self.right.output_partitioning().n - 1
        if last:
            with m.elapsed_compute:
                out = self._emit_build_tail(build)
            if out is not None and out.num_rows:
                m.record_output(out.num_rows)
                yield out

    # ---- probe ------------------------------------------------------------
    def _probe(self, build: _BuildSide, pb: Batch):
        """Returns (build_rows, probe_rows, matched_probe_mask) of verified
        join pairs for this probe batch."""
        n = pb.num_rows
        if not self.on:
            raise internal("HashJoinExec requires equi keys; use NestedLoopJoinExec")
        pkeys = [r.evaluate(pb) for _, r in self.on]
        valid = np.ones(n, bool)
        if not self.null_equals_null:
            for c in pkeys:
                v = c.validity_host()
                if v is not None:
                    valid &= v[:n]   # columns may be capacity-padded
        matched_probe = np.zeros(n, bool)
        direct = (build.direct is not None and len(pkeys) == 1 and
                  pkeys[0].dtype.is_integer and
                  not self.null_equals_null)
        if direct:
            # single bounded-int key: two O(1) table gathers replace the
            # binary searches, and keys are exact (no hash verification)
            klo, span, dstarts, dcounts, drows = build.direct
            pk = pkeys[0].data_host()[:n].astype(np.int64) - klo
            inr = valid & (pk >= 0) & (pk < span)
            idx = np.where(inr, pk, 0)
            counts = np.where(inr, dcounts[idx], 0)
            lo = dstarts[idx]
            sorted_rows = drows
        else:
            hashes = create_hashes(pkeys, n)
            lo = np.searchsorted(build.sorted_hashes, hashes, side="left")
            hi = np.searchsorted(build.sorted_hashes, hashes, side="right")
            counts = np.where(valid, hi - lo, 0)
            sorted_rows = build.sorted_rows
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), matched_probe)
        p_rows = np.repeat(np.arange(n), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - np.repeat(starts, counts)
        b_pos = np.repeat(lo, counts) + within
        b_rows = sorted_rows[b_pos]

        # exact key verification (hash-collision filter, equal_rows_arr);
        # the direct-address path compared exact keys already
        keep = np.ones(total, bool)
        if direct:
            keep_iter = ()
        else:
            keep_iter = zip(build.key_cols, pkeys)
        for (lc, pc) in keep_iter:
            lcc, pcc = lc, pc
            if lc.dtype.is_string and pc.dtype.is_string:
                lcc, pcc = K.unify_dictionaries(lc, pc)
            lv = lcc.data_host()[b_rows]
            pv = pcc.data_host()[p_rows]
            if lcc.dtype != pcc.dtype and lcc.dtype.is_numeric and pcc.dtype.is_numeric:
                common = K._comparison_type(lcc.dtype, pcc.dtype)
                lv = lv.astype(common.device_dtype())
                pv = pv.astype(common.device_dtype())
            eq = lv == pv
            if self.null_equals_null:
                lvm = K.valid_mask(lcc)[b_rows]
                pvm = K.valid_mask(pcc)[p_rows]
                eq = (lvm & pvm & eq) | (~lvm & ~pvm)
            keep &= eq
        b_rows, p_rows = b_rows[keep], p_rows[keep]

        # non-equi residual filter over the pair batch
        if self.filter is not None and len(b_rows):
            pair = self._pair_batch(build.batch, pb, b_rows, p_rows)
            fmask = K.true_mask(self.filter.evaluate(pair))
            b_rows, p_rows = b_rows[fmask], p_rows[fmask]

        if len(p_rows):
            matched_probe[p_rows] = True
            build.visited[b_rows] = True
        return b_rows, p_rows, matched_probe

    def _pair_batch(self, bb: Batch, pb: Batch, b_rows, p_rows) -> Batch:
        schema = self.filter_schema or join_schema(
            self.left.schema(), self.right.schema(), "INNER")
        cols = [c.take_host(b_rows) for c in bb.columns] + \
               [c.take_host(p_rows) for c in pb.columns]
        return Batch(schema, cols, len(b_rows))

    # ---- emission --------------------------------------------------------------
    def _emit_pairs(self, bb: Batch, pb: Batch, b_rows, p_rows) -> Batch:
        cols = [c.take_host(b_rows) for c in bb.columns] + \
               [c.take_host(p_rows) for c in pb.columns]
        return Batch(self._schema, cols, len(b_rows))

    def _emit_probe_unmatched(self, pb: Batch, rows) -> Batch:
        n = len(rows)
        cols = _null_columns(self.left.schema(), n) + \
               [c.take_host(rows) for c in pb.columns]
        return Batch(self._schema, cols, n)

    def _emit_build_tail(self, build: _BuildSide) -> Optional[Batch]:
        jt = self.join_type
        if jt in ("LEFT", "FULL"):
            rows = np.nonzero(~build.visited)[0]
            if not len(rows):
                return None
            cols = [c.take_host(rows) for c in build.batch.columns] + \
                   _null_columns(self.right.schema(), len(rows))
            return Batch(self._schema, cols, len(rows))
        if jt == "LEFTSEMI":
            rows = np.nonzero(build.visited)[0]
            return build.batch.take_host(rows)
        if jt == "LEFTANTI":
            rows = np.nonzero(~build.visited)[0]
            return build.batch.take_host(rows)
        return None

    def display_line(self):
        on = ", ".join(f"({l} = {r})" for l, r in self.on)
        f = f", filter={self.filter}" if self.filter is not None else ""
        return (f"HashJoinExec: mode={self.partition_mode}, "
                f"join_type={self.join_type}, on=[{on}]{f}")



def _align_to_schema(batch: Batch, schema: Schema) -> Batch:
    """Drop undeclared trailing columns (PlaceholderRowExec emits a dummy
    column its empty schema does not declare) so pair construction and
    column indexing line up with the plan schema."""
    if len(batch.columns) != len(schema):
        return Batch(schema, list(batch.columns[:len(schema)]),
                     batch.num_rows)
    return batch

class NestedLoopJoinExec(ExecutionPlan):
    """Non-equi join fallback (reference: nested_loop_join.rs:261).
    Vectorized as a blocked cross product + filter."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 filter: Optional[PhysicalExpr], join_type: str = "INNER",
                 filter_schema: Optional[Schema] = None):
        super().__init__()
        self.left = left
        self.right = right
        self.filter = filter
        self.join_type = join_type
        self.filter_schema = filter_schema
        self._schema = join_schema(left.schema(), right.schema(), join_type)

    def schema(self):
        return self._schema

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return NestedLoopJoinExec(c[0], c[1], self.filter, self.join_type,
                                  self.filter_schema)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from .base import collect_batch, execute_stream
        m = BaselineMetrics(self.metrics, partition)
        bb = _align_to_schema(collect_batch(self.left, ctx),
                              self.left.schema())
        visited_b = np.zeros(bb.num_rows, bool)
        probe_outer = self.join_type in ("RIGHT", "FULL")
        emit_pairs = self.join_type in ("INNER", "LEFT", "RIGHT", "FULL")

        for pb in execute_stream(self.right, ctx):
            pb = _align_to_schema(pb, self.right.schema())
            with m.elapsed_compute:
                nb, np_ = bb.num_rows, pb.num_rows
                b_rows = np.repeat(np.arange(nb), np_)
                p_rows = np.tile(np.arange(np_), nb)
                if self.filter is not None and len(b_rows):
                    pair_schema = self.filter_schema or join_schema(
                        self.left.schema(), self.right.schema(), "INNER")
                    cols = [c.take_host(b_rows) for c in bb.columns] + \
                           [c.take_host(p_rows) for c in pb.columns]
                    pair = Batch(pair_schema, cols, len(b_rows))
                    fmask = K.true_mask(self.filter.evaluate(pair))
                    b_rows, p_rows = b_rows[fmask], p_rows[fmask]
                matched_p = np.zeros(np_, bool)
                if len(p_rows):
                    matched_p[p_rows] = True
                    visited_b[b_rows] = True
                outs = []
                if emit_pairs and len(b_rows):
                    cols = [c.take_host(b_rows) for c in bb.columns] + \
                           [c.take_host(p_rows) for c in pb.columns]
                    outs.append(Batch(self._schema, cols, len(b_rows)))
                if probe_outer:
                    un = np.nonzero(~matched_p)[0]
                    if len(un):
                        cols = _null_columns(self.left.schema(), len(un)) + \
                               [c.take_host(un) for c in pb.columns]
                        outs.append(Batch(self._schema, cols, len(un)))
                if self.join_type == "RIGHTSEMI":
                    outs.append(pb.take_host(np.nonzero(matched_p)[0]))
                if self.join_type == "RIGHTANTI":
                    outs.append(pb.take_host(np.nonzero(~matched_p)[0]))
            for o in outs:
                if o.num_rows:
                    m.record_output(o.num_rows)
                    yield o

        jt = self.join_type
        if jt in ("LEFT", "FULL"):
            rows = np.nonzero(~visited_b)[0]
            if len(rows):
                cols = [c.take_host(rows) for c in bb.columns] + \
                       _null_columns(self.right.schema(), len(rows))
                out = Batch(self._schema, cols, len(rows))
                m.record_output(out.num_rows)
                yield out
        elif jt == "LEFTSEMI":
            out = bb.take_host(np.nonzero(visited_b)[0])
            if out.num_rows:
                yield out
        elif jt == "LEFTANTI":
            out = bb.take_host(np.nonzero(~visited_b)[0])
            if out.num_rows:
                yield out

    def display_line(self):
        f = f", filter={self.filter}" if self.filter is not None else ""
        return f"NestedLoopJoinExec: join_type={self.join_type}{f}"


class SortMergeJoinExec(HashJoinExec):
    """Sort-merge equi join (reference: sort_merge_join.rs; selected when
    ``datafusion.optimizer.prefer_hash_join = false``).  Matching runs on
    exact joint key codes instead of hashes: both sides' key columns
    factorize into one shared dense code space, the build side is sorted by
    code, and each probe batch merges with two binary-search passes — no
    hash collisions, so no pair verification pass.  Inherits the emission /
    visited-bitmap machinery (all 8 join types, residual filters)."""

    def with_children(self, c):
        return SortMergeJoinExec(c[0], c[1], self.on, self.join_type,
                                 self.filter, self.filter_schema,
                                 self.partition_mode, self.null_equals_null)

    def _collect_build(self, ctx: TaskContext, partition):
        side = super()._collect_build(ctx, partition)
        side.sorted_hashes = None      # unused; matching is code-based
        side.sorted_rows = None
        return side

    def _probe(self, build: _BuildSide, pb: Batch):
        from ..hashing import factorize_column
        from ...common.column import concat_columns
        n = pb.num_rows
        if not self.on:
            raise internal("SortMergeJoinExec requires equi keys")
        pkeys = [r.evaluate(pb) for _, r in self.on]
        nb = build.batch.num_rows

        valid_b = np.ones(nb, bool)
        valid_p = np.ones(n, bool)
        combined = np.zeros(nb + n, np.int64)
        for lc, pc in zip(build.key_cols, pkeys):
            lcc, pcc = lc, pc
            if lc.dtype.is_string and pc.dtype.is_string:
                lcc, pcc = K.unify_dictionaries(lc, pc)
            elif lc.dtype != pc.dtype and lc.dtype.is_numeric and pc.dtype.is_numeric:
                common = K._comparison_type(lc.dtype, pc.dtype)
                lcc = K.cast_column(lc, common)
                pcc = K.cast_column(pc, common)
            both = concat_columns([lcc, pcc])
            codes = factorize_column(both)
            card = int(codes.max(initial=0)) + 1
            # int64 overflow guard (same as hashing.factorize): re-densify
            # the accumulated codes before multiplying by the next cardinality
            if combined.max(initial=0) >= np.iinfo(np.int64).max // max(card, 1):
                from ..hashing import _dense_codes
                combined, _ = _dense_codes(combined)
            combined = combined * card + codes
            if not self.null_equals_null:
                for c, m_, lim in ((lcc, valid_b, nb), (pcc, valid_p, n)):
                    v = c.validity_host()
                    if v is not None:
                        m_ &= v
        bcodes, pcodes = combined[:nb], combined[nb:]

        rows_b = np.nonzero(valid_b)[0]
        order = np.argsort(bcodes[rows_b], kind="stable")
        sorted_codes = bcodes[rows_b][order]
        sorted_rows = rows_b[order]

        lo = np.searchsorted(sorted_codes, pcodes, side="left")
        hi = np.searchsorted(sorted_codes, pcodes, side="right")
        counts = np.where(valid_p, hi - lo, 0)
        total = int(counts.sum())
        matched_probe = np.zeros(n, bool)
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), matched_probe)
        p_rows = np.repeat(np.arange(n), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - np.repeat(starts, counts)
        b_rows = sorted_rows[np.repeat(lo, counts) + within]

        if self.filter is not None and len(b_rows):
            pair = self._pair_batch(build.batch, pb, b_rows, p_rows)
            fmask = K.true_mask(self.filter.evaluate(pair))
            b_rows, p_rows = b_rows[fmask], p_rows[fmask]

        if len(p_rows):
            matched_probe[p_rows] = True
            build.visited[b_rows] = True
        return b_rows, p_rows, matched_probe

    def display_line(self):
        on = ", ".join(f"({l} = {r})" for l, r in self.on)
        f = f", filter={self.filter}" if self.filter is not None else ""
        return (f"SortMergeJoin: join_type={self.join_type}, on=[{on}]{f}")


class CrossJoinExec(ExecutionPlan):
    def __init__(self, left: ExecutionPlan, right: ExecutionPlan):
        super().__init__()
        self.left = left
        self.right = right
        self._schema = join_schema(left.schema(), right.schema(), "INNER")

    def schema(self):
        return self._schema

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return CrossJoinExec(c[0], c[1])

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition, ctx) -> Iterator[Batch]:
        from .base import collect_batch, execute_stream
        m = BaselineMetrics(self.metrics, partition)
        bb = _align_to_schema(collect_batch(self.left, ctx),
                              self.left.schema())
        for pb in execute_stream(self.right, ctx):
            pb = _align_to_schema(pb, self.right.schema())
            with m.elapsed_compute:
                nb, np_ = bb.num_rows, pb.num_rows
                b_rows = np.repeat(np.arange(nb), np_)
                p_rows = np.tile(np.arange(np_), nb)
                cols = [c.take_host(b_rows) for c in bb.columns] + \
                       [c.take_host(p_rows) for c in pb.columns]
                out = Batch(self._schema, cols, len(b_rows))
            if out.num_rows:
                m.record_output(out.num_rows)
                yield out

    def display_line(self):
        return "CrossJoinExec"


def _physical_to_logical(pe):
    """Convert the supported PhysicalExpr shapes back to logical Exprs so
    the interval solver (optimizer/intervals.py) can analyze a join
    filter. Raises ValueError for unsupported shapes."""
    from ...expr import expr as E
    from ..expressions import (BinaryPhysExpr, CastExpr, ColumnExpr,
                               LiteralExpr, NegativeExpr)
    if isinstance(pe, ColumnExpr):
        return E.Column(pe.name)
    if isinstance(pe, LiteralExpr):
        return E.Literal(pe.value)
    if isinstance(pe, BinaryPhysExpr):
        return E.BinaryExpr(_physical_to_logical(pe.left), pe.op,
                            _physical_to_logical(pe.right))
    if isinstance(pe, CastExpr):
        return E.Cast(_physical_to_logical(pe.expr), pe.out_type, pe.safe)
    if isinstance(pe, NegativeExpr):
        return E.Negative(_physical_to_logical(pe.expr))
    raise ValueError(f"unsupported expr for interval analysis: {pe}")


class SymmetricHashJoinExec(HashJoinExec):
    """Streaming two-way hash join (reference:
    `joins/symmetric_hash_join.rs:381`): both inputs are consumed
    incrementally, each arriving batch probes everything buffered on the
    other side, and matches stream out as discovered — no build-side
    barrier. With a range join filter over ascending-sorted inputs,
    buffered state is pruned via interval constraint propagation (the
    cp_solver use in symmetric_hash_join.rs:18-26 — here
    optimizer/intervals.py): once the arriving side's watermark implies
    a bound the other side's chunk can no longer satisfy, the chunk is
    dropped from the probe state.

    Bounded inputs are interleaved batch-by-batch; on unbounded sources
    the identical loop applies back-pressure per batch.
    """

    def with_children(self, c):
        return SymmetricHashJoinExec(
            c[0], c[1], self.on, self.join_type, self.filter,
            self.filter_schema, self.partition_mode, self.null_equals_null)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import math
        from .base import execute_stream
        m = BaselineMetrics(self.metrics, partition)
        pruned = self.metrics.counter("state_pruned_rows", partition)
        li = iter(execute_stream(self.left, ctx))
        ri = iter(execute_stream(self.right, ctx))
        lkeys = [l for l, _ in self.on]
        rkeys = [r for _, r in self.on]
        plans = {"left": self._prune_plan("left"),
                 "right": self._prune_plan("right")}
        chunks = {"left": [], "right": []}
        arrived = {"left": [], "right": []}
        emit_pairs = self.join_type in ("INNER", "LEFT", "RIGHT", "FULL")

        def ingest(side, b):
            other = "right" if side == "left" else "left"
            my_keys = lkeys if side == "left" else rkeys
            outs, matched = self._shj_probe(
                chunks[other], b, my_keys, side == "left", emit_pairs)
            ch = _BuildSide(b, [e.evaluate(b) for e in my_keys],
                            self.null_equals_null)
            ch._matched_ref = matched
            if plans[side] is not None:
                d = plans[side][3].evaluate(b).data_host()
                ch._wm_max = float(d.max()) if len(d) else None
            else:
                ch._wm_max = None
            chunks[side].append(ch)
            arrived[side].append((b, ch))
            # prune the OTHER side's buffered chunks with this watermark
            plan = plans[side]
            if plan is not None and chunks[other]:
                my_col, other_col, filt, wm_expr = plan
                d = wm_expr.evaluate(b).data_host()
                if len(d):
                    from ...optimizer.intervals import (
                        Interval, propagate_predicate)
                    ranges = {my_col: Interval(float(d.min()), math.inf),
                              other_col: Interval(-math.inf, math.inf)}
                    shrunk = propagate_predicate(filt, ranges)
                    if shrunk is not None and                             shrunk[other_col].lower != -math.inf:
                        bound = shrunk[other_col].lower
                        keep = []
                        for c in chunks[other]:
                            if c._wm_max is not None and c._wm_max < bound:
                                pruned.add(c.batch.num_rows)
                            else:
                                keep.append(c)
                        chunks[other] = keep
            return outs

        done = {"left": False, "right": False}
        iters = {"left": li, "right": ri}
        while not (done["left"] and done["right"]):
            for side in ("left", "right"):
                if done[side]:
                    continue
                b = next(iters[side], None)
                if b is None:
                    done[side] = True
                    continue
                if not b.num_rows:
                    continue
                with m.elapsed_compute:
                    outs = ingest(side, b)
                for o in outs:
                    if o.num_rows:
                        m.record_output(o.num_rows)
                        yield o

        with m.elapsed_compute:
            finals = []
            for b, ch in arrived["left"]:
                finals.extend(self._shj_left_tail(
                    b, ch.visited | ch._matched_ref))
            for b, ch in arrived["right"]:
                finals.extend(self._shj_right_tail(
                    b, ch.visited | ch._matched_ref))
        for t in finals:
            if t is not None and t.num_rows:
                m.record_output(t.num_rows)
                yield t

    # ---- probe one arriving batch against buffered other-side chunks ----
    def _shj_probe(self, other_chunks, batch, my_key_exprs, batch_is_left,
                   emit_pairs):
        n = batch.num_rows
        matched = np.zeros(n, bool)
        outs = []
        pkeys = [e.evaluate(batch) for e in my_key_exprs]
        hashes = create_hashes(pkeys, n)
        valid = np.ones(n, bool)
        if not self.null_equals_null:
            for c in pkeys:
                v = c.validity_host()
                if v is not None:
                    valid &= v[:n]   # columns may be capacity-padded
        for ch in other_chunks:
            lo = np.searchsorted(ch.sorted_hashes, hashes, side="left")
            hi = np.searchsorted(ch.sorted_hashes, hashes, side="right")
            counts = np.where(valid, hi - lo, 0)
            total = int(counts.sum())
            if total == 0:
                continue
            p_rows = np.repeat(np.arange(n), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(total) - np.repeat(starts, counts)
            b_rows = ch.sorted_rows[np.repeat(lo, counts) + within]
            keep = np.ones(total, bool)
            for (bc, pc) in zip(ch.key_cols, pkeys):
                bcc, pcc = bc, pc
                if bc.dtype.is_string and pc.dtype.is_string:
                    bcc, pcc = K.unify_dictionaries(bc, pc)
                bv = bcc.data_host()[b_rows]
                pv = pcc.data_host()[p_rows]
                if bcc.dtype != pcc.dtype and bcc.dtype.is_numeric \
                        and pcc.dtype.is_numeric:
                    common = K._comparison_type(bcc.dtype, pcc.dtype)
                    bv = bv.astype(common.device_dtype())
                    pv = pv.astype(common.device_dtype())
                eq = bv == pv
                if self.null_equals_null:
                    bvm = K.valid_mask(bcc)[b_rows]
                    pvm = K.valid_mask(pcc)[p_rows]
                    eq = (bvm & pvm & eq) | (~bvm & ~pvm)
                keep &= eq
            b_rows, p_rows = b_rows[keep], p_rows[keep]
            if self.filter is not None and len(b_rows):
                if batch_is_left:
                    pair = self._pair_batch(batch, ch.batch, p_rows, b_rows)
                else:
                    pair = self._pair_batch(ch.batch, batch, b_rows, p_rows)
                fm = K.true_mask(self.filter.evaluate(pair))
                b_rows, p_rows = b_rows[fm], p_rows[fm]
            if not len(b_rows):
                continue
            matched[p_rows] = True
            ch.visited[b_rows] = True
            if emit_pairs:
                if batch_is_left:
                    outs.append(self._emit_pairs(batch, ch.batch,
                                                 p_rows, b_rows))
                else:
                    outs.append(self._emit_pairs(ch.batch, batch,
                                                 b_rows, p_rows))
        return outs, matched

    # ---- end-of-stream tails -------------------------------------------
    def _shj_left_tail(self, b: Batch, matched: np.ndarray):
        jt = self.join_type
        if jt in ("LEFT", "FULL"):
            rows = np.nonzero(~matched)[0]
            if len(rows):
                cols = [c.take_host(rows) for c in b.columns] + \
                    _null_columns(self.right.schema(), len(rows))
                return [Batch(self._schema, cols, len(rows))]
        if jt == "LEFTSEMI":
            return [b.take_host(np.nonzero(matched)[0])]
        if jt == "LEFTANTI":
            return [b.take_host(np.nonzero(~matched)[0])]
        return []

    def _shj_right_tail(self, b: Batch, matched: np.ndarray):
        jt = self.join_type
        if jt in ("RIGHT", "FULL"):
            rows = np.nonzero(~matched)[0]
            if len(rows):
                cols = _null_columns(self.left.schema(), len(rows)) + \
                    [c.take_host(rows) for c in b.columns]
                return [Batch(self._schema, cols, len(rows))]
        if jt == "RIGHTSEMI":
            return [b.take_host(np.nonzero(matched)[0])]
        if jt == "RIGHTANTI":
            return [b.take_host(np.nonzero(~matched)[0])]
        return []

    def _prune_plan(self, side: str):
        """For a batch arriving on `side`: (my_sort_col, other_sort_col,
        logical filter, watermark expr over my schema), or None when
        interval pruning is not applicable."""
        if self.filter is None:
            return None
        me = self.left if side == "left" else self.right
        other = self.right if side == "left" else self.left
        mo = me.output_ordering()
        oo = other.output_ordering()
        if not mo or not oo or not mo[0][1] or not oo[0][1]:
            return None          # need ascending orderings on both sides
        try:
            filt = _physical_to_logical(self.filter)
        except ValueError:
            return None
        my_name = mo[0][0].split("@")[0]
        other_name = oo[0][0].split("@")[0]
        from ..expressions import ColumnExpr
        me_schema = me.schema()
        idx = next((i for i, f in enumerate(me_schema)
                    if f.name == my_name), None)
        if idx is None or my_name == other_name:
            return None
        wm = ColumnExpr(idx, my_name, me_schema.fields[idx].dtype)
        return (my_name, other_name, filt, wm)

    def display_line(self):
        on = ", ".join(f"({l} = {r})" for l, r in self.on)
        f = f", filter={self.filter}" if self.filter is not None else ""
        return (f"SymmetricHashJoinExec: join_type={self.join_type}, "
                f"on=[{on}]{f}")
