"""SortExec / TopK / SortPreservingMergeExec.

Reference parity: `sorts/sort.rs:668` (ExternalSorter), `topk/mod.rs:75`
(ORDER BY + LIMIT k), `sorts/sort_preserving_merge.rs:67`.

TPU-first detail: every sort key column is first encoded into a *monotonic
uint64 order key* (sign-flip for ints, IEEE total-order trick for floats —
NaN sorts greatest like the reference, dictionary codes for strings,
bit-inversion for DESC, a leading null-rank word for NULLS FIRST/LAST).
After encoding, any comparison sort / bitonic device sort / radix partition
works on plain unsigned integers — no per-type comparators in the hot loop.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
from torch.profiler import record_function

from ...common.batch import Batch, concat_batches
from ...common.column import Column
from ...common.schema import Schema
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from ..expressions import PhysicalExpr
from .base import ExecutionPlan, Partitioning


@dataclasses.dataclass
class PhysSortExpr:
    expr: PhysicalExpr
    asc: bool = True
    nulls_first: bool = False

    def __str__(self):
        s = f"{self.expr} {'ASC' if self.asc else 'DESC'}"
        if self.nulls_first:
            s += " NULLS FIRST"
        return s


def encode_order_key(col, asc: bool, nulls_first: bool) -> np.ndarray:
    """Column -> uint64 such that np.sort order == SQL order."""
    data = col.data_host()
    if data.dtype.kind == "f":
        bits = data.astype(np.float64).view(np.uint64).copy()
        neg = (bits >> np.uint64(63)) == 1
        bits = np.where(neg, ~bits, bits | np.uint64(1 << 63))
        # NaN: IEEE trick already puts +NaN above +inf; normalize -NaN
        nan = np.isnan(data)
        bits = np.where(nan, np.uint64(0xFFFFFFFFFFFFFFFF), bits)
        key = bits
    elif data.dtype == np.bool_:
        key = data.astype(np.uint64)
    elif data.dtype == object and col.dictionary is None:
        # array/struct rows: dense lexicographic ranks via Python compare
        # (reference: arrow-ord compares List lexicographically by element,
        # element nulls last). Host fallback — nested types never reach the
        # device sort path.
        def _k(val):
            if isinstance(val, (list, tuple, np.ndarray)):
                return (0, tuple(_k(x) for x in val))
            if isinstance(val, dict):
                return (0, tuple(_k(x) for x in val.values()))
            if val is None or (isinstance(val, float) and np.isnan(val)):
                return (1, ())
            return (0, ((0, val),))
        order = sorted(range(len(data)), key=lambda i: _k(data[i]))
        key = np.empty(len(data), np.uint64)
        rank = 0
        prev = None
        for pos, i in enumerate(order):
            cur = _k(data[i])
            if pos and cur != prev:
                rank += 1
            key[i] = rank
            prev = cur
    else:
        key = (data.astype(np.int64).view(np.uint64)
               ^ np.uint64(1 << 63))  # sign flip -> unsigned monotonic
    if not asc:
        key = ~key
    v = col.validity_host()
    if v is not None:
        # Nulls take the extreme word.  This collides with a valid value that
        # already sits at that extreme (e.g. NaN / INT64_MAX under NULLS
        # LAST), so it is only safe for callers that never select the null
        # end (the sparse-table argopt below); exact total orders use
        # order_keys() which carries a separate null-rank word.
        null_key = np.uint64(0) if nulls_first else np.uint64(0xFFFFFFFFFFFFFFFF)
        key = np.where(v, key, null_key)
    return key


def order_keys(col, asc: bool, nulls_first: bool) -> List[np.ndarray]:
    """Column -> [null_rank(uint8), value_key(uint64)] lexsort words,
    most-significant first.  Lossless (unlike a single banded word, which
    cannot hold 2^64 values plus a null rank): np.lexsort over the flattened
    words of all sort exprs realizes the exact SQL order."""
    data = col.data_host()
    v = col.validity_host()
    key = encode_order_key(
        Column(col.dtype, data, None, col.dictionary), asc, nulls_first)
    if v is None:
        return [np.zeros(len(data), np.uint8), key]
    # null rows compare equal to each other (peers) and rank before/after
    # every valid row
    rank = np.where(v, np.uint8(1) if nulls_first else np.uint8(0),
                    np.uint8(0) if nulls_first else np.uint8(1))
    return [rank, np.where(v, key, np.uint64(0))]


def sort_indices(batch: Batch, sort_exprs: List[PhysSortExpr],
                 limit: Optional[int] = None, metrics=None, device=None,
                 config=None) -> np.ndarray:
    """Row permutation realizing the sort order (stable). Large inputs
    sort on the plan's device (`lexsort`), small ones on the host:
    identical results."""
    keys = []
    with record_function("dft.sort.encode"):
        for se in sort_exprs:
            col = se.expr.evaluate(batch)
            keys.extend(order_keys(col, se.asc, se.nulls_first))
    return lexsort(keys, batch.num_rows, limit=limit, device=device,
                   config=config)


def lexsort(keys: List[np.ndarray], n: int, limit: Optional[int] = None,
            device=None, config=None) -> np.ndarray:
    """Stable ascending permutation over key words (most-significant
    first), cut to `limit`: the radix sort kernel on `device` (the plan's,
    given by the `UseTorchSort` rule) when `n` reaches
    `datafusion.tpu.device_sort_min_rows`, else `np.lexsort` of the
    reversed words. The threshold is the JAX package's rule
    (`device_sort.py:119`)."""
    from .device_sort import device_lexsort, min_rows
    if device is not None and n >= min_rows(config):
        return device_lexsort(keys, n, limit, device)
    order = np.lexsort(tuple(reversed([k[:n] for k in keys])))
    if limit is not None:
        order = order[:limit]
    return order


class SortExec(ExecutionPlan):
    """Full per-partition sort; `fetch` switches to top-k
    (reference: sorts/sort.rs:668 + topk/mod.rs:75)."""

    def __init__(self, sort_exprs: List[PhysSortExpr], input: ExecutionPlan,
                 fetch: Optional[int] = None,
                 preserve_partitioning: bool = False, device=None):
        super().__init__()
        self.sort_exprs = sort_exprs
        self.input = input
        self.fetch = fetch
        self.preserve_partitioning = preserve_partitioning
        self.device = device     # large sorts run there (None: the host)

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return SortExec(self.sort_exprs, c[0], self.fetch,
                        self.preserve_partitioning, self.device)

    def output_partitioning(self):
        if self.preserve_partitioning:
            return self.input.output_partitioning()
        return Partitioning.unknown(1)

    def maintains_input_order(self):
        return False

    def output_ordering(self):
        return [(str(e.expr), e.asc, e.nulls_first)
                for e in self.sort_exprs]

    def equivalence_properties(self):
        """Classes/constants survive a sort; the sort keys become the
        known ordering (properties.rs with_reorder)."""
        return self.input.equivalence_properties().with_reorder(
            self.output_ordering())

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        spill_count = self.metrics.counter("spill_count", partition)
        from ...common.errors import ResourcesExhausted
        from ...runtime import MemoryReservation
        reservation = MemoryReservation("SortExec", ctx.memory_pool,
                                        can_spill=True)
        disk = ctx.runtime.disk_manager
        if self.preserve_partitioning:
            source = self.input.execute(partition, ctx)
        else:
            assert partition == 0
            from .base import execute_stream
            source = execute_stream(self.input, ctx)
        batches = []
        spilled = []    # SpilledBatch list (external sort runs)
        for b in source:
            try:
                reservation.try_grow(b.nbytes())
                batches.append(b)
            except ResourcesExhausted:
                if disk is None:
                    raise
                # externalize: everything buffered + the incoming batch
                from .spill import SpilledBatch
                for sb in batches + [b]:
                    spilled.append(SpilledBatch(disk, sb))
                    spill_count.add(1)
                reservation.shrink(reservation.size)
                batches = []
        if spilled:
            yield from self._emit_external(batches, spilled, m)
            return
        with m.elapsed_compute:
            if self.fetch is not None and len(batches) > 1:
                # top-k per batch, then final top-k over survivors: bounds
                # memory like the reference's TopK heap
                pruned = []
                for b in batches:
                    if b.num_rows > self.fetch:
                        idx = sort_indices(b, self.sort_exprs, self.fetch,
                                           metrics=m, device=self.device,
                                           config=ctx.config)
                        b = b.take_host(idx)
                    pruned.append(b)
                batches = pruned
            merged = concat_batches(self.schema(), batches)
            if merged.num_rows == 0:
                return
            idx = sort_indices(merged, self.sort_exprs, self.fetch, metrics=m,
                               device=self.device, config=ctx.config)
            out = merged.take_host(idx)
        m.record_output(out.num_rows)
        yield out

    def _emit_external(self, batches, spilled, m) -> Iterator[Batch]:
        """External sort assembly: only the encoded sort KEYS are held in
        RAM (8B/key/row); payload gathers go through memory-mapped spill
        files (reference: sort.rs:345 streaming merge of spilled runs)."""
        from .spill import SpilledBatch
        sources = list(spilled)
        for b in batches:
            sources.append(_InMemorySource(b))
        key_parts = [[] for _ in range(2 * len(self.sort_exprs))]
        sizes = []
        for s in sources:
            loaded = s.load()
            sizes.append(loaded.num_rows)
            for i, se in enumerate(self.sort_exprs):
                col = se.expr.evaluate(loaded)
                if col.dtype.is_string:
                    # code order is dictionary-local; cross-run string sort
                    # keys require decode-based keys — not yet supported
                    from ...common.errors import ExecutionError
                    raise ExecutionError(
                        "external sort on string keys is not yet supported")
                for j, w in enumerate(
                        order_keys(col, se.asc, se.nulls_first)):
                    key_parts[2 * i + j].append(w)
        keys = [np.concatenate(p) for p in key_parts]
        order = np.lexsort(tuple(reversed(keys)))
        if self.fetch is not None:
            order = order[: self.fetch]
        # map global positions back to (source, local row)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        src_of = np.searchsorted(bounds, order, side="right") - 1
        local = order - bounds[src_of]
        chunk = 1 << 16
        for start in range(0, len(order), chunk):
            sel_src = src_of[start:start + chunk]
            sel_local = local[start:start + chunk]
            parts = []
            emit_order = np.argsort(sel_src, kind="stable")
            for sid in np.unique(sel_src):
                mask = sel_src == sid
                parts.append(sources[sid].take(sel_local[mask]))
            block = concat_batches(self.schema(), parts)
            # parts are grouped by ascending source id, i.e. permuted by the
            # stable sort of sel_src; invert that to restore output order
            undo = np.empty(len(emit_order), np.int64)
            undo[emit_order] = np.arange(len(emit_order))
            block = block.take_host(undo)
            m.record_output(block.num_rows)
            yield block

    def display_line(self):
        ex = ", ".join(map(str, self.sort_exprs))
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortExec: expr=[{ex}]{f}"


class PartialSortExec(ExecutionPlan):
    """Sort exploiting an input already ordered on the first
    `common_prefix_length` sort keys: rows buffer only until the prefix
    value changes, then each run sorts on the remaining keys and emits —
    bounded memory + streaming output (reference: sorts/partial_sort.rs)."""

    def __init__(self, sort_exprs: List[PhysSortExpr], input: ExecutionPlan,
                 common_prefix_length: int, fetch: Optional[int] = None,
                 device=None):
        super().__init__()
        assert 0 < common_prefix_length < len(sort_exprs)
        self.sort_exprs = sort_exprs
        self.input = input
        self.common_prefix_length = common_prefix_length
        self.fetch = fetch
        self.device = device     # large runs sort there (None: the host)

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return PartialSortExec(self.sort_exprs, c[0],
                               self.common_prefix_length, self.fetch,
                               self.device)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def maintains_input_order(self):
        return True

    def output_ordering(self):
        return [(str(e.expr), e.asc, e.nulls_first)
                for e in self.sort_exprs]

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        m = BaselineMetrics(self.metrics, partition)
        from .base import execute_stream
        k = self.common_prefix_length
        pending: List[Batch] = []
        pending_last_key: Optional[tuple] = None
        emitted = 0
        suffix = self.sort_exprs[k:]

        def prefix_words(b: Batch):
            return [w for se in self.sort_exprs[:k]
                    for w in order_keys(se.expr.evaluate(b), se.asc,
                                        se.nulls_first)]

        def flush(run_batches):
            nonlocal emitted
            if not run_batches:
                return None
            merged = run_batches[0] if len(run_batches) == 1 else \
                concat_batches(self.schema(), run_batches)
            idx = sort_indices(merged, suffix,
                               None if self.fetch is None
                               else self.fetch - emitted,
                               device=self.device, config=ctx.config)
            out = merged.take_host(idx)
            emitted += out.num_rows
            return out

        for b in execute_stream(self.input, ctx):
            if not b.num_rows:
                continue
            with m.elapsed_compute:
                words = prefix_words(b)
                change = np.zeros(b.num_rows, bool)
                for w in words:
                    change[1:] |= w[1:] != w[:-1]
                first_key = tuple(w[0] for w in words)
                if pending_last_key is not None and first_key != pending_last_key:
                    change[0] = True
                bounds = np.nonzero(change)[0]
                start = 0
                outs = []
                for cut in bounds:
                    if cut > start:
                        pending.append(b.take_host(np.arange(start, cut)))
                    outs.append(flush(pending))
                    pending = []
                    start = cut
                tail = b.take_host(np.arange(start, b.num_rows))
                pending.append(tail)
                pending_last_key = tuple(w[-1] for w in words)
            for o in outs:
                if o is not None and o.num_rows:
                    m.record_output(o.num_rows)
                    yield o
            if self.fetch is not None and emitted >= self.fetch:
                pending = []
                break
        with m.elapsed_compute:
            out = flush(pending)
        if out is not None and out.num_rows:
            m.record_output(out.num_rows)
            yield out

    def display_line(self):
        ex = ", ".join(map(str, self.sort_exprs))
        return (f"PartialSortExec: expr=[{ex}], "
                f"common_prefix_length={self.common_prefix_length}")


class _InMemorySource:
    """Adapter so in-memory batches join spilled runs in external assembly."""

    def __init__(self, batch: Batch):
        self.batch = batch
        self.num_rows = batch.num_rows

    def load(self) -> Batch:
        return self.batch

    def take(self, indices: np.ndarray) -> Batch:
        return self.batch.take_host(indices)


class SortPreservingMergeExec(ExecutionPlan):
    """N sorted partitions -> 1 sorted stream
    (reference: sorts/sort_preserving_merge.rs:67). Host path: gather and
    merge via stable sort on the encoded order keys (k-way loser tree on
    already-sorted runs is a later optimization)."""

    def __init__(self, sort_exprs: List[PhysSortExpr], input: ExecutionPlan,
                 fetch: Optional[int] = None, device=None):
        super().__init__()
        self.sort_exprs = sort_exprs
        self.input = input
        self.fetch = fetch
        self.device = device     # large merges sort there (None: the host)

    def schema(self):
        return self.input.schema()

    def children(self):
        return [self.input]

    def with_children(self, c):
        return SortPreservingMergeExec(self.sort_exprs, c[0], self.fetch,
                                       self.device)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def maintains_input_order(self):
        return True

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        assert partition == 0
        m = BaselineMetrics(self.metrics, partition)
        n = self.input.output_partitioning().n
        per_part = []
        for p in range(n):
            bs = list(self.input.execute(p, ctx))
            if bs:
                per_part.append(concat_batches(self.schema(), bs))
        if not per_part:
            return
        with m.elapsed_compute:
            if self.fetch is not None and                     self.fetch <= 8192 and len(per_part) > 1:
                out = self._loser_tree_topk(per_part)
            else:
                merged = concat_batches(self.schema(), per_part)
                if merged.num_rows == 0:
                    return
                idx = sort_indices(merged, self.sort_exprs, self.fetch,
                                   metrics=m, device=self.device,
                                   config=ctx.config)
                out = merged.take_host(idx)
        m.record_output(out.num_rows)
        yield out

    def _loser_tree_topk(self, per_part):
        """Streaming k-way merge with early stop (reference: the loser
        tree of sorts/merge.rs:50 + cursor.rs:76): pop only `fetch` rows
        across already-sorted partitions instead of re-sorting the union.
        Cursor comparison uses the uint64 encoded order keys, so multi-
        column / descending / NULLS FIRST orders all reduce to tuple <."""
        import heapq
        keys = []     # per partition: [n, k] uint64 key matrix
        for b in per_part:
            cols = []
            for se in self.sort_exprs:
                col = se.expr.evaluate(b)
                cols.extend(order_keys(col, se.asc, se.nulls_first))
            keys.append(np.stack(cols, axis=1) if cols else
                        np.zeros((b.num_rows, 1), np.uint64))
        heap = []
        for pi, k in enumerate(keys):
            if len(k):
                heapq.heappush(heap, (tuple(k[0]), pi, 0))
        sel = [[] for _ in per_part]
        order = []    # (partition, row) emission order
        taken = 0
        while heap and taken < self.fetch:
            _, pi, ri = heapq.heappop(heap)
            order.append((pi, ri))
            sel[pi].append(ri)
            taken += 1
            if ri + 1 < len(keys[pi]):
                heapq.heappush(heap, (tuple(keys[pi][ri + 1]), pi, ri + 1))
        # one bulk gather per partition, then a single permutation take:
        # within a partition rows pop in ascending index order, so the
        # i-th pop from partition pi sits at offset[pi] + i in the concat
        gathered, offsets, off = [], {}, 0
        for pi, rows in enumerate(sel):
            if rows:
                offsets[pi] = off
                gathered.append(per_part[pi].take_host(
                    np.asarray(rows, np.int64)))
                off += len(rows)
        merged_small = concat_batches(self.schema(), gathered)
        counters = {pi: 0 for pi in offsets}
        perm = np.empty(len(order), np.int64)
        for i, (pi, _) in enumerate(order):
            perm[i] = offsets[pi] + counters[pi]
            counters[pi] += 1
        return merged_small.take_host(perm)

    def display_line(self):
        ex = ", ".join(map(str, self.sort_exprs))
        f = f", fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortPreservingMergeExec: [{ex}]{f}"
