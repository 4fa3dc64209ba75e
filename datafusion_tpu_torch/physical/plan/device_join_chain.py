"""TorchJoinChainAggregateExec — a multi-way fanout-1 join fused with
grouped aggregation on the card.

Counterpart of `datafusion_tpu.physical.plan.device_join_chain.
DeviceJoinChainAggregateExec` (`_execute_device` `:330-541`,
`_stage_chain_builds` `:543`, `_chain_slots` `:1449`, `_chain_pair_view`
`:1577`). The fusion rule (`_try_fuse_join_chain` in the port's
`physical_optimizer.py`) flattens the join tree under an aggregate and
re-anchors it on the largest relation, the spine; every other relation is
a build side joined through a key that is unique among its rows (INNER), or
a membership test (LEFTSEMI, LEFTANTI). Each build stages on the card as a
direct-address or hashed table (`chain_build`); one kernel per spine batch
then walks the chain and folds the surviving rows into the group table
(`chain_aggregate`), and the group table leaves as
TorchGroupAggregateExec's does (`compact_groups`, one copy, the host
emit).

The group keys pack whole. Where the reference would drop functionally
dependent keys (`_fd_reduce` `:1501`, `_fd_finalize` `:1359`: TPC-H Q10 and
Q18's wide keys), the packed key does not fit 62 bits and the exec raises
DeviceLoweringUnsupported, so the host plan (`fallback`) runs. So do count
DISTINCT, the SEMI min/max filter (`_mmx_exists` `:1325`, TPC-H Q21), an
INNER build with a duplicate key (fanout > 1), string or float join keys
(`:350-354`) and more than 8 hops. Each fallback adds one to
`self.fallbacks`.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.profiler import record_function

from ...common.column import DeviceColumnCache
from ...device.groupby import AggregateSpec, dense_group_table
from ...device.join_chain import (ChainDenseSpec, ChainHashSpec, Chain,
                                  BuildSpec, Hop, chain_aggregate,
                                  chain_build)
from ...device.lower import LoweringError, Pools, compile_expr
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import ColumnExpr, PhysicalExpr
from .base import ExecutionPlan, collect_batch, execute_stream
from .device_aggregate import (DeviceLoweringUnsupported, GroupTableOverflow,
                               TorchAggregate, _fold_inputs)
from .scan import MemoryExec


class ChainBuild:
    """One join step of the chain.

    probe_keys: exprs over the ACCUMULATED pair space (spine source
    columns first, then payloads of earlier builds in chain order).
    build_keys: ColumnExprs over the build source's OUTPUT schema.
    payload: build-output column indices appended to the pair space
    (INNER only; SEMI/ANTI contribute a mask and no columns).
    """

    __slots__ = ("source", "probe_keys", "build_keys", "payload",
                 "join_type", "sfilter")

    def __init__(self, source: ExecutionPlan,
                 probe_keys: List[PhysicalExpr],
                 build_keys: List[ColumnExpr],
                 payload: List[int], join_type: str = "INNER",
                 sfilter=None):
        self.source = source
        self.probe_keys = probe_keys
        self.build_keys = build_keys
        self.payload = payload
        self.join_type = join_type
        # SEMI/ANTI residual comparison `member_col OP probe_expr`:
        # (Op, member ColumnExpr over the build OUTPUT schema, pair-space
        # expr). Membership then means "any member row with this key
        # satisfying the comparison" — evaluated via per-key min/max LUTs.
        self.sfilter = sfilter


class _PairView:
    """The pair space of one spine batch as a batch-like view: the spine
    batch's columns, then each INNER build's payload columns in chain
    order. Key packing reads its columns' bounds and dictionaries, the
    programs' aux inputs its dictionaries."""

    def __init__(self, cols, num_rows: int):
        self.columns = cols
        self.num_rows = num_rows


class _BuildInput:
    """One build side ready for `chain_build`: its spec, device columns and
    aux inputs, whether it must be unique (INNER), its batch, the map from
    build output columns to batch columns, whether its columns stay
    resident, and once staged its `table`."""

    def __init__(self, spec, cols, aux, unique: bool, batch, col_map,
                 keep: bool):
        self.spec = spec
        self.cols = cols
        self.aux = aux
        self.unique = unique
        self.batch = batch
        self.col_map = col_map
        self.keep = keep
        self.table = None


class TorchJoinChainAggregateExec(TorchAggregate):

    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr],
                 group_exprs, aggs, schema, fallback: ExecutionPlan,
                 device: torch.device,
                 cache: Optional[DeviceColumnCache] = None,
                 max_groups: int = 1 << 22):
        super().__init__()
        self.source = probe_source
        self.probe_predicate = probe_predicate
        self.builds = builds
        self.predicate = predicate
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._schema = schema
        self.fallback = fallback
        self.max_groups = max_groups
        self.device = device
        self.cache = cache
        self.fallbacks = 0

    def children(self):
        return [self.source] + [b.source for b in self.builds]

    def with_children(self, c):
        builds = [ChainBuild(src, b.probe_keys, b.build_keys, b.payload,
                             b.join_type, b.sfilter)
                  for src, b in zip(c[1:], self.builds)]
        return TorchJoinChainAggregateExec(
            c[0], self.probe_predicate, builds, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.device, self.cache, self.max_groups)

    def display_line(self):
        steps = ", ".join(
            f"{b.join_type}[{', '.join(str(k) for k in b.probe_keys)}]"
            + (f" filter=({b.sfilter[1]} {b.sfilter[0].value} "
               f"{b.sfilter[2]})" if b.sfilter is not None else "")
            for b in self.builds)
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        return (f"TorchJoinChainAggregateExec: chain=[{steps}], "
                f"gby=[{gb}], aggr=[{ag}], device={self.device}")

    # ------------------------------------------------------------------
    @property
    def n_spine(self) -> int:
        return len(self.source.schema())

    def payload_ranges(self) -> List[List[int]]:
        """The pair-space indices of each build's payload columns."""
        out, off = [], self.n_spine
        for b in self.builds:
            n = len(b.payload) if b.join_type == "INNER" else 0
            out.append(list(range(off, off + n)))
            off += n
        return out

    def lower(self):
        """(pools, probe predicate, residual, group keys, slot defs, slot
        map, probe keys of each build): every pair-space program of the
        chain on one pool."""
        for b in self.builds:
            if b.sfilter is not None:
                raise LoweringError("SEMI min/max membership on device TBD")
            for pk, bk in zip(b.probe_keys, b.build_keys):
                if pk.out_type.is_string or bk.out_type.is_string or \
                        pk.out_type.is_float or bk.out_type.is_float:
                    raise LoweringError("non-integer chain join key")
        pools = Pools()
        ppred = compile_expr(self.probe_predicate, pools) \
            if self.probe_predicate is not None else None
        pred = compile_expr(self.predicate, pools) \
            if self.predicate is not None else None
        keys = [compile_expr(e, pools) for e, _ in self.group_exprs]
        slot_defs, slot_map = self._compile_slots(pools)
        probe_keys = [[compile_expr(k, pools) for k in b.probe_keys]
                      for b in self.builds]
        return pools, ppred, pred, keys, slot_defs, slot_map, probe_keys

    def build_inputs(self, ctx: TaskContext) -> List[_BuildInput]:
        """What `chain_build` takes for every build side. A Filter/Projection
        over a table scan stages from the table's own columns, which stay
        resident across queries, with the filter as the build predicate
        (evaluated on the card); any other build side runs on the host
        first (`_stage_chain_builds`, `:558-585`)."""
        from ..physical_optimizer import _unwrap_side
        out = []
        for b in self.builds:
            bb, col_map, pred, keep = None, None, None, False
            un = _unwrap_side(b.source)
            if un is not None:
                src, pred_u, exprs = un
                if all(isinstance(e, ColumnExpr) for e in exprs):
                    bb = collect_batch(src, ctx)
                    col_map = [e.index for e in exprs]
                    pred = pred_u
                    keep = isinstance(src, MemoryExec)
            if bb is None:
                bb = collect_batch(b.source, ctx)
                col_map = list(range(len(bb.columns)))
            pools = Pools()
            try:
                bpred = compile_expr(pred, pools) if pred is not None else None
                keys = [compile_expr(ColumnExpr(col_map[k.index], k.name,
                                                k.out_type), pools)
                        for k in b.build_keys]
                spec = BuildSpec(pools, bpred, keys)
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
            cols = self._to_device(spec, {i: bb.columns[i]
                                          for i in pools.columns}, keep)
            aux = torch.from_numpy(pools.aux_buffer(bb)).to(self.device)
            out.append(_BuildInput(spec, cols, aux, b.join_type == "INNER",
                                   bb, col_map, keep))
        return out

    def stage_builds(self, ctx: TaskContext) -> List[_BuildInput]:
        """Every build side staged on the card as a table (`chain_build`).
        An INNER build with a duplicate key, a build of 2^31 rows or more,
        or packed keys wider than 62 bits raise DeviceLoweringUnsupported
        (`:700`)."""
        out = self.build_inputs(ctx)
        for bi in out:
            if bi.batch.num_rows >= 1 << 31:
                raise DeviceLoweringUnsupported(
                    "a chain build side holds at most 2^31 - 1 rows")
            try:
                bi.table = chain_build(bi.spec, bi.cols, bi.aux,
                                       bi.batch.num_rows, bi.unique)
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
            if bi.table.duplicate:
                raise DeviceLoweringUnsupported(
                    "chain build keys not unique (fanout > 1)")
        return out

    def pair_view(self, spine_batch, staged: List[_BuildInput]) -> _PairView:
        cols = list(spine_batch.columns)
        for b, s in zip(self.builds, staged):
            if b.join_type == "INNER":
                cols += [s.batch.columns[s.col_map[i]] for i in b.payload]
        return _PairView(cols, spine_batch.num_rows)

    def compile(self, lowered, staged: List[_BuildInput], views):
        """(spec, pack plan, lane names, slot map) of the chain over the
        staged builds and the spine batches' pair views."""
        pools, ppred, pred, keys, slot_defs, slot_map, probe_keys = lowered
        plan = self._plan_key_packing(views, keys)
        try:
            key_progs, lanes, dense = _fold_inputs(keys, plan, slot_defs)
            hops = [Hop(s.table, b.join_type, pk, payload)
                    for b, s, pk, payload in zip(self.builds, staged,
                                                 probe_keys,
                                                 self.payload_ranges())]
            chain = Chain(self.n_spine, ppred, hops)
            if dense:
                spec = ChainDenseSpec(pools, pred, key_progs, lanes, chain)
            else:
                rows = sum(v.num_rows for v in views)
                spec = ChainHashSpec(pools, pred, key_progs, lanes, rows,
                                     chain)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return spec, plan, list(slot_defs), slot_map

    def stage(self, spec, spine_batch, view: _PairView,
              staged: List[_BuildInput], keep_spine: bool):
        """The pair-space columns the programs read, on the device (spine
        columns of this batch, payload columns of whole build batches),
        and the batch's aux inputs."""
        hop_of = spec.chain.hop_of
        cols = self._to_device(spec, {i: view.columns[i]
                                      for i in spec.pools.columns
                                      if i not in hop_of}, keep_spine)
        for i in spec.pools.columns:
            if i in hop_of:
                cols.update(self._to_device(
                    spec, {i: view.columns[i]}, staged[hop_of[i]].keep))
        aux = torch.from_numpy(spec.pools.aux_buffer(view)).to(self.device)
        return cols, aux

    def _execute_device(self, partition: int, ctx: TaskContext):
        # the inherited `execute` runs `self.fallback` on this exception
        try:
            return self._execute_port(partition, ctx)
        except DeviceLoweringUnsupported:
            self.fallbacks += 1
            raise

    def prepare(self, ctx: TaskContext):
        """Everything a run needs before the walk: the builds staged on the
        card, the chain compiled, each spine batch's columns staged.
        Returns (spec, pack plan, lane names, slot map, [(cols, aux, rows)
        per spine batch], staged builds)."""
        with record_function("dft.compile"):
            try:
                lowered = self.lower()
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
        with record_function("dft.build"):
            staged = self.stage_builds(ctx)
        spine = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        views = [self.pair_view(b, staged) for b in spine]
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile(lowered, staged, views)
        keep_spine = self._source_is_scan()
        inputs = [self.stage(spec, b, view, staged, keep_spine) + (b.num_rows,)
                  for b, view in zip(spine, views)]
        return spec, plan, names, slot_map, inputs, staged

    def _execute_port(self, partition: int, ctx: TaskContext):
        m = BaselineMetrics(self.metrics, partition)
        with m.elapsed_compute:
            spec, plan, names, slot_map, inputs, staged = self.prepare(ctx)
            with record_function("dft.aggregate"):
                table = spec.new_table(self.device)
                overflow = torch.zeros(1, dtype=torch.int32,
                                       device=self.device)
                for cols, aux, rows in inputs:
                    chain_aggregate(spec, cols, aux, rows, table, overflow)
                if isinstance(spec, AggregateSpec):
                    table = dense_group_table(table)
                elif int(overflow.item()):
                    raise GroupTableOverflow(
                        f"hash group table of {spec.cap} slots overflowed")
            host = self._fetch_groups(table)
            del table, inputs, staged
        return self._emit_groups(host, spec, plan, names, slot_map, m)
