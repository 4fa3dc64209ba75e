"""TorchGroupAggregateExec — filter, key packing and grouped aggregation in
one kernel launch per batch, then one compaction of the group table.

Counterpart of `datafusion_tpu.physical.plan.device_aggregate.
DeviceGroupAggregateExec` (`_execute_device`, `:251-511`). The subclass
reuses the reference's host halves, which are numpy: key packing
(`_plan_key_packing`), the subtree cache key, deferred-scalar binding,
the top-k lane choice (`_topk_lane`) and the finalisation `_emit_arrays`
(exact decimal avg, NaN restoration, the one-row result of an ungrouped
aggregate over empty input).

Two routes, by the packed key space:
- up to 64 slots, the dense kernel (`fused_dense_aggregate`) folds every
  batch into one `[lanes + 1, G]` table;
- above, the hash kernel (`hash_group_aggregate`) folds every batch into
  one `[lanes + 2, cap]` hash table, `cap` sized from the input so that
  it cannot fill. This stands for the reference's sort, row-space, merge,
  overflow and unbounded paths; the result is the same.
Then `compact_groups` keeps the live groups (those that pass the fused
HAVING, `post_filter`), or `group_topk` picks the fused `ORDER BY count
LIMIT k` (`topk`) and `compact_groups` gathers those slots. One `.cpu()`
of the compacted table feeds `_emit_arrays`.

Shapes outside this slice raise `DeviceLoweringUnsupported` and run
`self.fallback`, the host `AggregateExec`, as the reference does for SQL
it cannot lower: count DISTINCT, FILTER clauses, string min/max. Each
such fallback adds one to `self.fallbacks`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from datafusion_tpu.physical.plan.base import execute_stream
from datafusion_tpu.physical.plan.device_aggregate import (
    DeviceGroupAggregateExec, DeviceLoweringUnsupported)
from datafusion_tpu.runtime import BaselineMetrics

from ...common.column import DeviceColumnCache, to_device
from ...device.groupby import (
    FIN_AVG, FIN_COUNT, FIN_KEY, FIN_MAX, FIN_MIN, FIN_SUM, MAX_GROUPS,
    AggregateSpec, Finaliser, HashSpec, HavingSpec, compact_groups,
    dense_group_aggregate, dense_group_table, group_topk,
    hash_group_aggregate, lane_kind)
from ...device.lower import (LoweringError, Pools, check_having,
                             compile_expr)

_AGGS = {"count", "sum", "min", "max", "avg", "mean"}


class GroupTableOverflow(RuntimeError):
    """A row found no slot in the hash table. The table is sized so that
    this cannot happen; nothing carries on if it does."""


class TorchGroupAggregateExec(DeviceGroupAggregateExec):

    def __init__(self, source, predicate, group_exprs, aggs, schema,
                 fallback, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None,
                 max_groups: int = 1 << 22, topk: Optional[tuple] = None,
                 post_filter=None):
        super().__init__(source, predicate, group_exprs, aggs, schema,
                         fallback, max_groups, topk, post_filter)
        self.device = device
        self.cache = cache
        self.fallbacks = 0

    def with_children(self, c):
        return TorchGroupAggregateExec(
            c[0], self.predicate, self.group_exprs, self.aggs, self._schema,
            self.fallback, self.device, self.cache, self.max_groups,
            self.topk, self.post_filter)

    # ------------------------------------------------------------------
    def compile(self, batches):
        """Lower this aggregate for `batches`: (spec, pack plan, lane names,
        slot map). The spec is an `AggregateSpec` for key spaces up to 64
        slots, a `HashSpec` above. Raises DeviceLoweringUnsupported for
        shapes outside the slice."""
        pools = Pools()
        try:
            pred = compile_expr(self.predicate, pools) \
                if self.predicate is not None else None
            keys = [compile_expr(e, pools) for e, _ in self.group_exprs]
            slot_defs: Dict[str, tuple] = {}
            slot_map: Dict[str, Dict[str, str]] = {}
            uniq: Dict[tuple, str] = {}
            progs: Dict[str, object] = {}

            def slot(cat, a, suffix):
                # slot dedup of device_aggregate.py:303-336: aggregates that
                # share an argument share its sum/count/min/max lanes
                sig = str(a.args[0]) if a.args else "*"
                if (cat, sig) not in uniq:
                    name = f"v{len(uniq)}{suffix}"
                    uniq[(cat, sig)] = name
                    if sig not in progs:
                        progs[sig] = compile_expr(a.args[0], pools) \
                            if a.args else None
                    slot_defs[name] = (cat, progs[sig])
                return uniq[(cat, sig)]

            for a in self.aggs:
                kind = "avg" if a.name == "mean" else a.name
                if kind not in _AGGS or a.distinct or a.filter is not None:
                    raise LoweringError(f"{kind} not on the device path")
                if kind in ("min", "max") and a.out_type.is_dict_coded:
                    raise LoweringError("string min/max on device TBD")
                if len(a.args) > 1 or getattr(a, "order_by", None):
                    raise LoweringError("multi-arg/ordered agg on device TBD")
                m = {}
                if kind in ("sum", "avg"):
                    m["s"] = slot("sum", a, "#s")
                    m["c"] = slot("cnt", a, "#c")
                elif kind == "count":
                    m["c"] = slot("cnt", a, "#c")
                else:
                    tag = "n" if kind == "min" else "x"
                    m[tag] = slot(kind, a, "#" + tag)
                    m["c"] = slot("cnt", a, "#c")
                    if a.out_type is not None and a.out_type.is_float:
                        m["nn"] = slot("nancnt", a, "#nn")
                slot_map[a.display] = m
            plan = self._plan_key_packing(batches, keys)
            key_progs = [(k, off, bits) for k, off, bits in
                         zip(keys, plan.offsets, plan.bits)]
            dense = (1 << sum(plan.bits)) <= MAX_GROUPS
            lanes = [(p, lane_kind(cat, p, f32_sums=not dense))
                     for cat, p in slot_defs.values()]
            if dense:
                spec = AggregateSpec(pools, pred, key_progs, lanes)
            else:
                rows = sum(b.num_rows for b in batches)
                spec = HashSpec(pools, pred, key_progs, lanes, rows)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return spec, plan, list(slot_defs), slot_map

    def having(self, spec, plan, names, slot_map) -> Optional[HavingSpec]:
        """The fused HAVING as a compaction program: each output column it
        reads is finalised from its row of the group table, as
        `_apply_post_filter` (`device_aggregate.py:1301-1352`) does."""
        if self.post_filter is None:
            return None
        row = {n: 2 + i for i, n in enumerate(names)}
        kind = {n: k for n, (_p, k) in zip(names, spec.lanes)}
        fins = {}
        shift = 0
        for i, t in enumerate(plan.key_types):
            fins[i] = Finaliser(FIN_KEY, shift, plan.bits[i], plan.offsets[i],
                                t.is_boolean)
            shift += plan.bits[i]
        for j, a in enumerate(self.aggs):
            s = slot_map[a.display]
            c = row[s["c"]]
            if a.name == "count":
                f = Finaliser(FIN_COUNT, c)
            elif a.name in ("sum", "avg", "mean"):
                f = Finaliser(FIN_SUM if a.name == "sum" else FIN_AVG,
                              row[s["s"]], c, kind[s["s"]])
            else:
                v = s["n"] if a.name == "min" else s["x"]
                f = Finaliser(FIN_MIN if a.name == "min" else FIN_MAX,
                              row[v], c, kind[v], row.get(s.get("nn"), -1))
            fins[len(plan.key_types) + j] = f
        try:
            prog = check_having(self.post_filter,
                                [e.out_type for e, _ in self.group_exprs],
                                self.aggs)
            return HavingSpec(prog, {i: fins[i] for i in prog.pools.columns})
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

    def stage(self, spec, batch, cache: bool = True):
        """The batch's columns that the programs read, on the device, and
        its aux inputs."""
        cols = {}
        for idx in spec.pools.columns:
            c = batch.columns[idx]
            try:
                data, valid = to_device(c, self.device,
                                        self.cache if cache else None)
            except TypeError as e:
                raise DeviceLoweringUnsupported(str(e))
            if data.dtype != spec.column_dtype(idx):
                raise DeviceLoweringUnsupported(
                    f"column {idx} stored as {data.dtype}")
            cols[idx] = (data, valid)
        aux = torch.from_numpy(spec.pools.aux_buffer(batch)).to(self.device)
        return cols, aux

    def input_batches(self, ctx):
        """The non-empty batches of this aggregate's source."""
        return [b for b in execute_stream(self.source, ctx) if b.num_rows]

    def _execute_device(self, partition: int, ctx):
        # the inherited `execute` runs `self.fallback` on this exception
        try:
            return self._execute_port(partition, ctx)
        except DeviceLoweringUnsupported:
            self.fallbacks += 1
            raise

    def group_table(self, spec, batches, keep: bool) -> torch.Tensor:
        """Every batch folded into one group table, in the hash layout
        `[lanes + 2, slots]` (row 0 keys, EMPTY = -1; row 1 row counts)."""
        table = spec.new_table(self.device)
        if isinstance(spec, AggregateSpec):
            for b in batches:
                cols, aux = self.stage(spec, b, cache=keep)
                dense_group_aggregate(spec, cols, aux, b.num_rows, table)
            return dense_group_table(table)
        overflow = torch.zeros(1, dtype=torch.int32, device=self.device)
        for b in batches:
            cols, aux = self.stage(spec, b, cache=keep)
            hash_group_aggregate(spec, cols, aux, b.num_rows, table, overflow)
        # the port of _overflow_poison: one read after the last batch
        if int(overflow.item()):
            raise GroupTableOverflow(
                f"hash group table of {spec.cap} slots overflowed")
        return table

    def _execute_port(self, partition: int, ctx):
        m = BaselineMetrics(self.metrics, partition)
        batches = self.input_batches(ctx)
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile(batches)
            having = self.having(spec, plan, names, slot_map)
        # only registered tables keep their device copies across queries
        keep = self._source_is_scan()
        with m.elapsed_compute:
            with record_function("dft.aggregate"):
                table = self.group_table(spec, batches, keep)
            slots = None
            pick = self._topk_lane(slot_map) if self.topk else None
            if pick is not None and isinstance(spec, HashSpec):
                # a dense table of <= 64 groups goes out whole, as in the
                # reference: the SortExec above orders and cuts it
                lane, asc, k = pick
                with record_function("dft.topk"):
                    slots = group_topk(table, 2 + names.index(lane), asc, k)
            with record_function("dft.compact"):
                groups = compact_groups(table, having, slots)
            del table   # a hash table can take gigabytes: free it now
            with record_function("dft.d2h"):
                host = groups.cpu().numpy()
        with record_function("dft.emit"):
            aggs = dict(zip(names, spec.lane_arrays(host, first=2)))
            out = self._emit_arrays(host[0], np.ones(host.shape[1], bool),
                                    aggs, plan, slot_map, m)
        if out is not None:
            m.record_output(out.num_rows)
        return out

    def display_line(self):
        return super().display_line().replace(
            "DeviceGroupAggregateExec", "TorchGroupAggregateExec", 1) + \
            f", device={self.device}"
