"""TorchJoinAggregateExec — an INNER equi-join of any fanout fused with
grouped aggregation on the card; only the group table leaves it.

Counterpart of `datafusion_tpu.physical.plan.device_join_agg.
DeviceJoinAggregateExec` (`_execute_device` `:130-329`, `_prepare_slots`
`:333`, `_pair_planning_batch` `:373`), planned by the rule
`_try_fuse_join` of the port's `physical_optimizer.py` where the join
chain fuser declines: one INNER HashJoinExec whose keys are columns and
whose build key is not provably unique. Group keys, aggregates and the
residual (the aggregate's predicate and the join's own filter) are
written over the pair space: build source columns `0..n_build-1`, then
probe source columns.

The build side is collected as one batch and staged as a bucketed
multi-map (`join_build`); each probe batch is one `join_aggregate` launch
a pass of lanes, which walks each probe row's bucket and folds every pair
that passes the residual into the group table. The table then leaves as
TorchGroupAggregateExec's does (the fused HAVING, `compact_groups`, the
host or resident emit).

Parity with the reference's exec, which this port keeps:
- a float sum adds in float64 even over a float32 argument (`:505`);
- float min and max carry no NaN companion there (`:507-518`), so NaN
  reaches its group reduction: a dense table (<= 64 slots, `jnp.min`)
  gives NaN where any value is NaN, the sorted path (NaN sorts last) gives
  a min of NaN only where every value is; the port keeps a NaN count lane
  and restores NaN by the same rule for each route;
- DISTINCT and FILTER (`:341-342`), string min/max and a probe-side string
  group key over more than one probe batch (`:193-199`) are refused and
  run the host plan (`fallback`), adding one to `fallbacks`;
- NULL join keys never match (`:432-436`); a string key compares exactly,
  the probe's code remapped into the build's dictionary (`_remap_lut`,
  `:49`; a string absent there matches nothing).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ...device.groupby import AggregateSpec, dense_group_table, lane_kind
from ...device.join_agg import (JK_CODE, MAX_JOIN_KEYS, Join, JoinBuildSpec,
                                JoinDenseSpec, JoinHashSpec, join_aggregate,
                                join_build, key_kind, payload_of)
from ...device.lower import (OP_LUT, LoweringError, Pools, compile_expr,
                             compile_key)
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import ColumnExpr, PhysicalExpr, rewrite_columns
from .base import ExecutionPlan, collect_batch, execute_stream
from .device_aggregate import (DeviceLoweringUnsupported,
                               TorchGroupAggregateExec, check_overflow)
from .device_join_chain import _PairView
from .scan import MemoryExec

# a hash group table above this many slots runs the host plan
MAX_JOIN_GROUP_SLOTS = 1 << 30


def _remap_lut(from_dic, to_dic) -> np.ndarray:
    """LUT: code in `from_dic` -> code in `to_dic`, -1 when absent (exact
    cross-dictionary equality for string join keys; `device_join_agg.py:
    49`)."""
    if from_dic is None or len(from_dic) == 0:
        return np.full(1, -1, np.int64)
    tvals = to_dic.values.astype(str) if to_dic is not None and len(to_dic) \
        else np.array([], dtype=str)
    fvals = from_dic.values.astype(str)
    if not len(tvals):
        return np.full(len(fvals), -1, np.int64)
    pos = np.clip(np.searchsorted(tvals, fvals), 0, len(tvals) - 1)
    return np.where(tvals[pos] == fvals, pos, -1).astype(np.int64)


def _keeps(node) -> bool:
    """Whether a leaf source's columns stay on the card across queries."""
    return isinstance(node, MemoryExec) or \
        getattr(node, "table", None) is not None


class TorchJoinAggregateExec(TorchGroupAggregateExec):
    """group_exprs, aggs and predicate are over the pair space: build
    source columns 0..nb-1, then probe source columns. build_keys and
    probe_keys are ColumnExprs over their side's source schema."""

    def __init__(self, build_source: ExecutionPlan,
                 probe_source: ExecutionPlan,
                 build_keys: List[ColumnExpr], probe_keys: List[ColumnExpr],
                 build_predicate: Optional[PhysicalExpr],
                 probe_predicate: Optional[PhysicalExpr],
                 predicate: Optional[PhysicalExpr], group_exprs, aggs,
                 schema, fallback: ExecutionPlan, device: torch.device,
                 cache=None, max_groups: int = 1 << 22, topk=None,
                 post_filter=None):
        super().__init__(None, predicate, group_exprs, aggs, schema,
                         fallback, device, cache, max_groups, topk,
                         post_filter)
        self.build_source = build_source
        self.probe_source = probe_source
        self.build_keys = build_keys
        self.probe_keys = probe_keys
        self.build_predicate = build_predicate
        self.probe_predicate = probe_predicate
        self.n_build = len(build_source.schema())

    def children(self):
        return [self.build_source, self.probe_source]

    def with_children(self, c):
        return TorchJoinAggregateExec(
            c[0], c[1], self.build_keys, self.probe_keys,
            self.build_predicate, self.probe_predicate, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.device, self.cache, self.max_groups, self.topk,
            self.post_filter)

    def display_line(self):
        on = ", ".join(f"({b} = {p})" for b, p in
                       zip(self.build_keys, self.probe_keys))
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        # every predicate shows: the subtree cache keys on this text
        preds = "".join(
            f", {name}={e}" for name, e in (
                ("build_predicate", self.build_predicate),
                ("probe_predicate", self.probe_predicate),
                ("predicate", self.predicate),
                ("having", self.post_filter)) if e is not None)
        return (f"TorchJoinAggregateExec: on=[{on}], gby=[{gb}], "
                f"aggr=[{ag}]{preds}, device={self.device}")

    # ------------------------------------------------------------------
    def _probe_to_pair(self, e: PhysicalExpr) -> PhysicalExpr:
        """A probe-source expression over the pair space."""
        repl = [ColumnExpr(self.n_build + i, f.name, f.dtype)
                for i, f in enumerate(self.probe_source.schema())]
        return rewrite_columns(e, repl)

    def lower(self):
        """(pair pools, probe predicate, residual, group keys, slot defs,
        slot map, build spec's pools, build predicate, build keys, probe
        keys): every program of the join. Raises LoweringError."""
        if len(self.build_keys) > MAX_JOIN_KEYS:
            raise LoweringError(f"{len(self.build_keys)} join keys")
        pools = Pools()
        ppred = compile_expr(self._probe_to_pair(self.probe_predicate),
                             pools) \
            if self.probe_predicate is not None else None
        pred = compile_expr(self.predicate, pools) \
            if self.predicate is not None else None
        keys = [compile_key(e, pools) for e, _ in self.group_exprs]
        slot_defs, slot_map = self._compile_slots(pools, distinct=False)
        bpools = Pools()
        bpred = compile_expr(self.build_predicate, bpools) \
            if self.build_predicate is not None else None
        bkeys, pkeys = [], []
        for bk, pk in zip(self.build_keys, self.probe_keys):
            bt, pt = bk.out_type, pk.out_type
            if not (bt.is_integer and pt.is_integer) and bt != pt:
                raise LoweringError(f"join key {bt} against {pt}")
            kind = key_kind(bt)
            bkeys.append((compile_expr(bk, bpools), kind))
            prog = compile_expr(self._probe_to_pair(pk), pools)
            if kind == JK_CODE:
                # the probe code in the build's dictionary, -1 if absent;
                # the pair view holds both sides' columns
                def remap(view, p=self.n_build + pk.index, b=bk.index):
                    return _remap_lut(view.columns[p].dictionary,
                                      view.columns[b].dictionary)
                prog.code.append((OP_LUT, pools.add_aux(remap, "remap"), 0))
            pkeys.append((prog, kind))
        return (pools, ppred, pred, keys, slot_defs, slot_map, bpools, bpred,
                bkeys, pkeys)

    def build_input(self, lowered, build_batch):
        """(spec, device columns, aux) of the build side for `join_build`:
        its programs' columns and the payload, the build columns the pair
        programs read, which the table's records carry."""
        pools, *_pair, bpools, bpred, bkeys, _pkeys = lowered
        if build_batch.num_rows >= 1 << 31:
            raise DeviceLoweringUnsupported(
                "a join build side holds at most 2^31 - 1 rows")
        try:
            spec = JoinBuildSpec(bpools, bpred, bkeys,
                                 payload_of(pools, self.n_build))
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        cols = self._to_device(spec, {
            i: build_batch.columns[i]
            for i in sorted(set(bpools.columns) | set(spec.payload))},
            _keeps(self.build_source))
        aux = torch.from_numpy(bpools.aux_buffer(build_batch)).to(self.device)
        return spec, cols, aux

    def stage_build(self, lowered, build_batch):
        """The build side staged on the card (`join_build`)."""
        spec, cols, aux = self.build_input(lowered, build_batch)
        return join_build(spec, cols, aux, build_batch.num_rows)

    def _group_rows_bound(self, table, views) -> int:
        """At most this many groups: the rows of the side the group keys
        read, or the pairs there can be."""
        from ..physical_optimizer import _collect_cols
        refs = set()
        for e, _n in self.group_exprs:
            _collect_cols(e, refs)
        probe_rows = sum(v.num_rows for v in views)
        if all(r >= self.n_build for r in refs):
            return probe_rows
        if all(r < self.n_build for r in refs):
            return table.live
        return table.live * probe_rows

    def compile_join(self, lowered, table, views):
        """(spec, pack plan, lane names, slot map) of the fold over the
        pairs. A dense table restores NaN into a float min where any value
        is NaN (the "na" slot), as the reference's dense path does."""
        pools, ppred, pred, keys, slot_defs, slot_map, *_b, pkeys = lowered
        plan = self._plan_key_packing(views, keys)
        key_progs = [(k, off, bits) for k, off, bits in
                     zip(keys, plan.offsets, plan.bits)]
        lanes = [(p, lane_kind(cat, p)) for cat, p in slot_defs.values()]
        join = Join(self.n_build, ppred, pkeys, table)
        try:
            if sum(plan.bits) <= 6:
                spec = JoinDenseSpec(pools, pred, key_progs, lanes, join)
                for a in self.aggs:
                    s = slot_map[a.display]
                    if a.name == "min" and "nn" in s:
                        s["na"] = s.pop("nn")
            else:
                spec = JoinHashSpec(pools, pred, key_progs, lanes,
                                    self._group_rows_bound(table, views),
                                    join)
                if spec.cap > MAX_JOIN_GROUP_SLOTS:
                    raise LoweringError(f"{spec.cap} group slots")
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return spec, plan, list(slot_defs), slot_map

    def stage_pair(self, spec, build_batch, probe_batch, view):
        """The probe columns the programs read, on the card (the build
        columns are in the build table's records), and the batch's aux
        inputs."""
        cols = self._to_device(
            spec, {i: probe_batch.columns[i - self.n_build]
                   for i in spec.pools.columns if i >= self.n_build},
            _keeps(self.probe_source))
        aux = torch.from_numpy(spec.pools.aux_buffer(view)).to(self.device)
        return cols, aux

    def _execute_port(self, partition: int, ctx: TaskContext):
        m = BaselineMetrics(self.metrics, partition)
        with record_function("dft.compile"):
            try:
                lowered = self.lower()
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
        build_batch = collect_batch(self.build_source, ctx)
        probe = [b for b in execute_stream(self.probe_source, ctx)
                 if b.num_rows]
        if len(probe) > 1:
            for e, _n in self.group_exprs:
                if isinstance(e, ColumnExpr) and e.out_type.is_string and \
                        e.index >= self.n_build:
                    raise DeviceLoweringUnsupported(
                        "probe-side string group keys need a single batch")
        with record_function("dft.build"):
            table = self.stage_build(lowered, build_batch)
        views = [_PairView(list(build_batch.columns) + list(pb.columns),
                           pb.num_rows) for pb in probe]
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile_join(lowered, table,
                                                            views)
            having = self.having(spec, plan, names, slot_map)
        del table     # `spec` keeps the build table for the probe
        return self._finish(
            self._timed_fold(m, lambda: self.fold_pairs(spec, build_batch,
                                                        probe, views)),
            spec, plan, names, slot_map, having, m)

    def fold_pairs(self, spec, build_batch, probe, views):
        """Every probe batch's pairs folded into one group table, in the
        hash layout `[lanes + 2, slots]`."""
        groups = spec.new_table(self.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=self.device)
        for pb, view in zip(probe, views):
            cols, aux = self.stage_pair(spec, build_batch, pb, view)
            join_aggregate(spec, cols, aux, pb.num_rows, groups, overflow)
        if isinstance(spec, AggregateSpec):
            return dense_group_table(groups)
        check_overflow(overflow, spec)
        return groups
