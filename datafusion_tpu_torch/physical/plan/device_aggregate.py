"""TorchGroupAggregateExec — filter, key packing and grouped aggregation in
one kernel launch per batch, then one compaction of the group table.

Counterpart of `datafusion_tpu.physical.plan.device_aggregate.
DeviceGroupAggregateExec` (`_execute_device`, `:251-511`). `TorchAggregate`
below is the port's own copy of that class's host halves, which are
numpy and shared with the join-chain exec: the subtree cache, deferred
scalar binding, key packing (`_plan_key_packing`, `:624`), the top-k lane
choice (`_topk_lane`, `:1100`) and the finalisation `_emit_arrays`
(`:1382`: exact decimal avg, NaN restoration, the one-row result of an
ungrouped aggregate over empty input).

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
of the compacted table feeds `_emit_arrays`. A table of at least
RESIDENT_EMIT_MIN_GROUPS live groups with no HAVING and no top-k, whose
keys are integers or dictionary codes and whose aggregates are counts and
non-float sums (`_emit_device_ok`, the reference's gate at `:859-897`),
stays on the card instead: `group_emit_columns` writes its output columns
there as device-born columns (`_emit_device_resident`, `:899`), which a
consumer reads through `to_device` with no copy, or `data_host()` once.

Shapes outside this slice raise `DeviceLoweringUnsupported` and run
`self.fallback`, the host `AggregateExec`, as the reference does for SQL
it cannot lower: count DISTINCT, FILTER clauses, string min/max. Each
such fallback adds one to `self.fallbacks`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ...common import dt
from ...common.batch import Batch
from ...common.column import Column, DeviceColumnCache, to_device
from ...common.datatypes import TypeId
from ...device.groupby import (
    _NP_TO_TORCH, EMIT_COUNT, EMIT_DICT, EMIT_KEY, EMIT_SUM, FIN_AVG,
    FIN_COUNT, FIN_KEY, FIN_MAX, FIN_MIN, FIN_SUM, MAX_GROUPS,
    AggregateSpec, EmitField, Finaliser, HashSpec, HavingSpec,
    compact_groups, dense_group_aggregate, dense_group_table,
    group_emit_columns, group_topk, hash_group_aggregate, lane_kind)
from ...device.lower import (LoweringError, Pools, check_having,
                             compile_expr, compile_key)
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import PhysicalExpr
from .base import ExecutionPlan, Partitioning, execute_stream

_AGGS = {"count", "sum", "min", "max", "avg", "mean"}

# a group table of at least this many live groups stays on the card
# (`device_aggregate.py:859`)
RESIDENT_EMIT_MIN_GROUPS = 1 << 18


def _fold_inputs(keys, plan, slot_defs):
    """(key programs with their offsets and bits, lanes, dense) of a
    grouped fold: dense when the packed key space fits MAX_GROUPS slots;
    the hash path keeps float32 sums in float32 lanes."""
    key_progs = [(k, off, bits) for k, off, bits in
                 zip(keys, plan.offsets, plan.bits)]
    dense = (1 << sum(plan.bits)) <= MAX_GROUPS
    lanes = [(p, lane_kind(cat, p, f32_sums=not dense))
             for cat, p in slot_defs.values()]
    return key_progs, lanes, dense


class DeviceLoweringUnsupported(Exception):
    """The plan is outside what the port lowers to its kernels; the exec
    runs its host `fallback` plan instead."""


class GroupTableOverflow(RuntimeError):
    """A row found no slot in the hash table. The table is sized so that
    this cannot happen; nothing carries on if it does."""


class _PackPlan:
    """How the group keys pack: each packed key's offset, bits, type and
    dictionary. A join chain whose keys were reduced by functional
    dependence also sets the `kept` and `dropped` key positions and the
    emit's `finalize` hook that rebuilds the dropped keys."""

    def __init__(self, offsets, bits, key_types, key_dicts):
        self.offsets = offsets
        self.bits = bits
        self.key_types = key_types
        self.key_dicts = key_dicts
        self.kept = list(range(len(key_types)))
        self.dropped: List[int] = []
        self.finalize = None


class TorchDeviceExec(ExecutionPlan):
    """What every exec of the port that runs on the card shares: one
    output partition, deferred-scalar binding, and its input columns
    staged on the device (cached across queries when they come from a
    table scan)."""

    def schema(self):
        return self._schema

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def _attach_deferred_ctx(self, ctx):
        """Hand the query's TaskContext to every DeferredScalarExpr in
        this exec's expressions, so scalar subqueries run through the
        per-query subtree cache (shared CTE executions) instead of a
        fresh context."""
        from ..expressions import DeferredScalarExpr

        def walk(e):
            if isinstance(e, DeferredScalarExpr):
                e.bind_ctx(ctx)
            for c in e.children():
                walk(c)

        for e in self._deferred_expr_roots():
            if e is not None:
                walk(e)

    def _deferred_expr_roots(self):
        out = [getattr(self, "predicate", None),
               getattr(self, "probe_predicate", None),
               getattr(self, "build_predicate", None)]
        for e, _n in getattr(self, "group_exprs", []) or []:
            out.append(e)
        for a in getattr(self, "aggs", []) or []:
            out.extend(a.args)
            out.append(a.filter)
        for b in getattr(self, "builds", []) or []:
            out.extend(b.probe_keys)
            if b.sfilter is not None:
                out.append(b.sfilter[2])
        return out

    def _source_is_scan(self) -> bool:
        """True when the exec's input descends through stateless
        wrappers to table scans (whose columns cache their device copy
        across queries); joins/windows/etc. produce fresh batches."""
        from .projection import (CoalescePartitionsExec, FilterExec,
                                 GlobalLimitExec, ProjectionExec)
        from .scan import MemoryExec

        def walk(node):
            if isinstance(node, MemoryExec):
                return True
            if isinstance(node, (FilterExec, ProjectionExec,
                                 GlobalLimitExec, CoalescePartitionsExec)):
                return all(walk(c) for c in node.children())
            t = getattr(node, "table", None)
            return t is not None

        return walk(self.source)

    def _to_device(self, spec, columns: Dict[int, Column], cache: bool):
        """{index: (data, validity)} on the device of the columns
        `columns` gives by program column index, each at the dtype the
        programs read; cached across queries when `cache`."""
        cols = {}
        for idx, c in columns.items():
            try:
                data, valid = to_device(c, self.device,
                                        self.cache if cache else None)
            except TypeError as e:
                raise DeviceLoweringUnsupported(str(e))
            if data.dtype != spec.column_dtype(idx):
                raise DeviceLoweringUnsupported(
                    f"column {idx} stored as {data.dtype}")
            cols[idx] = (data, valid)
        return cols


class TorchAggregate(TorchDeviceExec):
    """The host halves of a device aggregate, the port's copy of
    `DeviceGroupAggregateExec`'s numpy code. Subclasses implement
    `_execute_device`; `execute` runs `self.fallback` when it raises
    DeviceLoweringUnsupported."""

    post_filter: Optional[PhysicalExpr] = None

    def execute(self, partition: int, ctx: TaskContext):
        self._attach_deferred_ctx(ctx)
        key = self._subtree_key(partition)
        cache = getattr(ctx, "subtree_cache", None)
        if cache is not None and key is not None and key in cache:
            out = cache[key]
            if out is not None:
                yield out
            return
        try:
            out = self._execute_device(partition, ctx)
        except DeviceLoweringUnsupported:
            yield from self.fallback.execute(partition, ctx)
            return
        if cache is not None and key is not None:
            cache[key] = out
        if out is not None:
            yield out

    def _subtree_key(self, partition: int):
        """Structural identity of this subtree + leaf source identities —
        two identical aggregates over the same tables (inlined CTEs, e.g.
        TPC-H Q15's revenue0) share one execution per query."""
        try:
            tables = []
            stable = [True]

            def leaves(node):
                from .scan import WorkTableExec
                if isinstance(node, WorkTableExec):
                    # work-table contents change every recursion iteration:
                    # caching would freeze the first iteration's result
                    stable[0] = False
                    return
                t = getattr(node, "table", None)
                if t is not None:
                    tables.append(id(t))
                for c in node.children():
                    leaves(c)
            leaves(self)
            if not tables or not stable[0]:
                return None

            def esig(e):
                # display text alone is ambiguous (a.c1 and b.c1 both print
                # "c1"); include column indices structurally
                return (type(e).__name__, getattr(e, "index", None),
                        tuple(esig(c) for c in e.children()))
            sig = (tuple(esig(e) for e, _ in self.group_exprs),
                   tuple(esig(a) for ag in self.aggs for a in ag.args),
                   esig(self.predicate) if self.predicate is not None else None)
            return (type(self).__name__, partition,
                    self.display_indent(), sig, tuple(tables))
        except Exception:  # noqa: BLE001
            return None

    # ---- shared by the port's device execs ---------------------------------
    def _compile_slots(self, pools: Pools):
        """(slot defs, slot map) of the aggregates: the slot scheme of
        `device_aggregate.py:303-336` (`_chain_slots`,
        `device_join_chain.py:1449`, is the same), where aggregates that
        share an argument share its sum/count/min/max lanes."""
        slot_defs: Dict[str, tuple] = {}
        slot_map: Dict[str, Dict[str, str]] = {}
        uniq: Dict[tuple, str] = {}
        progs: Dict[str, object] = {}

        def slot(cat, a, suffix):
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
        return slot_defs, slot_map

    def _fetch_groups(self, table, having=None, slots=None) -> np.ndarray:
        """The live groups of a `[lanes + 2, slots]` table (those that pass
        `having`, or among `slots`), compacted on the device and brought
        to the host in one copy."""
        with record_function("dft.compact"):
            groups = compact_groups(table, having, slots)
        with record_function("dft.d2h"):
            return groups.cpu().numpy()

    def _emit_groups(self, host, spec, plan, names, slot_map, m,
                     key_finalize=None):
        """The output batch of the compacted groups `host`; `key_finalize`
        as `_emit_arrays` takes it."""
        with record_function("dft.emit"):
            aggs = dict(zip(names, spec.lane_arrays(host, first=2)))
            out = self._emit_arrays(host[0], np.ones(host.shape[1], bool),
                                    aggs, plan, slot_map, m, key_finalize)
        if out is not None:
            m.record_output(out.num_rows)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _phys_int_bounds(e, batches):
        """(lo, hi) integer bounds for an INTEGRAL-VALUED key expr, or
        None. Lets COMPUTED group keys pack: only expression shapes that
        provably produce integers qualify — including date_part, whose
        Float64 output (reference: date_part.rs returns Float64) always
        carries whole numbers."""
        from ..expressions import (BinaryPhysExpr, CastExpr, ColumnExpr,
                                   LiteralExpr, ScalarFunctionExpr)
        from ...expr.operator import Op
        B = TorchAggregate._phys_int_bounds
        if isinstance(e, ColumnExpr):
            t = e.out_type
            if t.is_boolean:
                return (0, 1)
            if not (t.is_integer or t.is_decimal or
                    t.id in (TypeId.DATE, TypeId.TIMESTAMP)):
                return None
            lo = hi = None
            for b in batches:
                d = b.columns[e.index].data_host()
                if len(d) == 0:
                    continue
                bl, bh = int(d.min()), int(d.max())
                lo = bl if lo is None else min(lo, bl)
                hi = bh if hi is None else max(hi, bh)
            return (0, 0) if lo is None else (lo, hi)
        if isinstance(e, LiteralExpr):
            v = e.value.value
            if v is None:
                return (0, 0)
            if isinstance(v, (int, np.integer, bool)):
                return (int(v), int(v))
            return None
        if isinstance(e, CastExpr) and e.out_type.is_integer:
            return B(e.expr, batches)
        if isinstance(e, BinaryPhysExpr) and \
                e.op in (Op.PLUS, Op.MINUS, Op.MULTIPLY) and \
                e.out_type.is_integer and e.left.out_type.is_integer and \
                e.right.out_type.is_integer:
            # integers only: decimal raw values carry scales, and
            # date/interval arithmetic is calendar logic
            lb, rb = B(e.left, batches), B(e.right, batches)
            if lb is None or rb is None:
                return None
            if e.op == Op.PLUS:
                return (lb[0] + rb[0], lb[1] + rb[1])
            if e.op == Op.MINUS:
                return (lb[0] - rb[1], lb[1] - rb[0])
            ps = [lb[0] * rb[0], lb[0] * rb[1], lb[1] * rb[0],
                  lb[1] * rb[1]]
            return (min(ps), max(ps))
        if isinstance(e, ScalarFunctionExpr) and \
                e.name in ("date_part", "datepart") and len(e.args) == 2:
            lit = e.args[0]
            if not isinstance(lit, LiteralExpr) or lit.value.value is None:
                return None
            from ...functions.datetime_impl import (_PART_ALIASES,
                                                    _TS_SCALE,
                                                    _days_to_ymd)
            part = _PART_ALIASES.get(str(lit.value.value).lower())
            fixed = {"quarter": (1, 4), "month": (1, 12), "day": (1, 31),
                     "doy": (1, 366), "week": (1, 53), "dow": (0, 6),
                     "hour": (0, 23), "minute": (0, 59),
                     "second": (0, 59), "millisecond": (0, 59_999),
                     "microsecond": (0, 59_999_999),
                     "nanosecond": (0, 59_999_999_999)}
            if part in fixed:
                return fixed[part]
            if part != "year":
                return None
            ct = e.args[1].out_type
            if getattr(ct, "tz", None):
                return None
            ib = B(e.args[1], batches)
            if ib is None:
                return None
            if ct.id == TypeId.DATE:
                to_us = 1000 if ct.unit == "ms" else 86_400_000_000
            elif ct.id == TypeId.TIMESTAMP:
                scale = _TS_SCALE[ct.unit]
                to_us = (10**6 // scale) if scale <= 10**6 \
                    else -(scale // 10**6)
            else:
                return None
            ends = np.asarray(ib, np.int64)
            us = ends // (-to_us) if to_us < 0 else ends * to_us
            y, _, _ = _days_to_ymd(us // 86_400_000_000)
            return (int(y[0]), int(y[1]))   # year is monotone in time
        return None

    def _plan_key_packing(self, batches, key_l,
                          group_exprs=None) -> _PackPlan:
        from ..expressions import ColumnExpr
        offsets, bits, key_types, key_dicts = [], [], [], []
        for (e, _name) in (group_exprs if group_exprs is not None
                           else self.group_exprs):
            t = e.out_type
            key_types.append(t)
            if t.is_dict_coded:
                if not isinstance(e, ColumnExpr):
                    raise DeviceLoweringUnsupported("string key must be a column")
                dics = {id(b.columns[e.index].dictionary) for b in batches}
                if len(dics) > 1:
                    raise DeviceLoweringUnsupported(
                        "per-batch dictionaries need host remap")
                dic = batches[0].columns[e.index].dictionary if batches else None
                key_dicts.append(dic)
                # codes stored as code+1 (0 = NULL): domain is len(dic)+1
                card = (len(dic) if dic is not None else 0) + 1
                offsets.append(0)
                bits.append(max(int(np.ceil(np.log2(card + 1))), 1))
            elif t.is_boolean:
                key_dicts.append(None)
                offsets.append(0)
                bits.append(2)
            elif t.is_integer or t.is_decimal or t.is_float or \
                    t.id in (TypeId.DATE, TypeId.TIMESTAMP):
                rng = self._phys_int_bounds(e, batches)
                if rng is None:
                    raise DeviceLoweringUnsupported(
                        f"group key {'type ' + str(t) if t.is_float else 'expr'}"
                        " not integer-boundable")
                lo, hi = rng
                key_dicts.append(None)
                offsets.append(lo)
                span = hi - lo + 1   # values stored v-lo+1, 0 = NULL
                bits.append(max(int(np.ceil(np.log2(span + 2))), 1))
            else:
                raise DeviceLoweringUnsupported(f"group key type {t}")
        if sum(bits) > 62:
            raise DeviceLoweringUnsupported(f"key bits {sum(bits)} > 62")
        return _PackPlan(offsets, bits, key_types, key_dicts)


    def _topk_lane(self, slot_map):
        """Resolve the fused ORDER BY target to an int64 device lane.
        Returns (slot_name, asc, k) or None when the order key has no
        exact integer lane (float sums, avg)."""
        idx, asc, k = self.topk
        if idx >= len(self.aggs):
            return None
        a = self.aggs[idx]
        slots = slot_map.get(a.display)
        if not slots:
            return None
        if "d" in slots:
            lane = slots["d"]
        elif a.name == "count":
            lane = slots["c"]
        elif a.name == "sum" and not a.out_type.is_float:
            lane = slots.get("s")
        elif a.name == "min" and not a.out_type.is_float:
            lane = slots.get("n")
        elif a.name == "max" and not a.out_type.is_float:
            lane = slots.get("x")
        else:
            return None
        if lane is None:
            return None
        return (lane, asc, int(k))

    def _emit_arrays(self, keys_np, valid, aggs_np, plan: _PackPlan,
                     slot_map, m, key_finalize=None) -> Optional[Batch]:
        """key_finalize(sel, key_cols) -> key_cols: hook for emitters whose
        packed word carries a REDUCED key set (functional-dependence
        reduction in device_join_chain) — it reconstructs the dropped key
        columns and returns the full schema-ordered list."""
        n_keys = len(self.group_exprs)
        if keys_np is not None:
            sel = np.nonzero(valid)[0]
        else:
            sel = np.zeros(0, np.int64)
            keys_np = np.zeros(0, np.int64)
            aggs_np = {}

        if n_keys == 0 and len(sel) == 0:
            # scalar aggregate over empty input: one row of count=0 / NULLs
            keys_np = np.zeros(1, np.int64)
            sel = np.array([0])
            aggs_np = {}
            for slots in slot_map.values():
                for slot in slots.values():
                    aggs_np[slot] = np.zeros(
                        1, np.int64 if slot.endswith(("#c", "#d"))
                        else np.float64)
        elif n_keys > 0 and len(sel) == 0:
            return None

        cols: List[Column] = []
        keys_sel = keys_np[sel]
        shift = 0
        for i, t in enumerate(plan.key_types):
            b = plan.bits[i]
            raw = (keys_sel >> shift) & ((1 << b) - 1)
            shift += b
            is_null = raw == 0
            validity = None if not is_null.any() else ~is_null
            code = raw - 1 + plan.offsets[i]
            if t.is_dict_coded:
                cols.append(Column(t, np.maximum(raw - 1, 0).astype(np.int32),
                                   validity, plan.key_dicts[i]))
            elif t.is_boolean:
                cols.append(Column(t, (code != 0), validity))
            else:
                cols.append(Column(t, code.astype(t.device_dtype()), validity))

        if key_finalize is not None:
            cols = key_finalize(sel, cols, aggs_np)

        for a in self.aggs:
            slots = slot_map[a.display]
            if "d" in slots:               # count(DISTINCT x)
                d = aggs_np[slots["d"]][sel]
                cols.append(Column(dt.INT64, d.astype(np.int64)))
                continue
            cnt = aggs_np[slots["c"]][sel]
            has = cnt > 0
            v = None if has.all() else has
            if a.name == "count":
                cols.append(Column(dt.INT64, cnt.astype(np.int64)))
            elif a.name == "sum":
                s = aggs_np[slots["s"]][sel]
                cols.append(Column(a.out_type,
                                   s.astype(a.out_type.device_dtype()), v))
            elif a.name in ("avg", "mean"):
                s = aggs_np[slots["s"]][sel]
                safe = np.where(has, cnt, 1)
                if a.out_type.is_decimal:
                    at = a.args[0].out_type
                    in_scale = at.scale if at.is_decimal else 0
                    shift10 = 10 ** (a.out_type.scale - in_scale)
                    num = s.astype(object) * int(shift10)
                    den = safe.astype(object)
                    # reference divides in i128: truncation toward zero
                    # (DecimalAverager::avg, aggregate/utils.rs:213)
                    q = np.sign(num) * (np.abs(num) // den)
                    cols.append(Column(a.out_type, q.astype(np.int64), v))
                else:
                    cols.append(Column(dt.FLOAT64, s / safe, v))
            elif a.name == "min":
                x = aggs_np[slots["n"]][sel].astype(a.out_type.device_dtype())
                if "nn" in slots:
                    nn = aggs_np[slots["nn"]][sel]
                    x = np.where(has & (nn == cnt), np.nan, x)  # all-NaN group
                cols.append(Column(a.out_type, x, v))
            else:  # max
                x = aggs_np[slots["x"]][sel].astype(a.out_type.device_dtype())
                if "nn" in slots:
                    nn = aggs_np[slots["nn"]][sel]
                    x = np.where(has & (nn > 0), np.nan, x)     # NaN is greatest
                cols.append(Column(a.out_type, x, v))
        return Batch(self._schema, cols, len(sel))


class TorchGroupAggregateExec(TorchAggregate):

    def __init__(self, source, predicate, group_exprs, aggs, schema,
                 fallback, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None,
                 max_groups: int = 1 << 22, topk: Optional[tuple] = None,
                 post_filter=None):
        super().__init__()
        self.source = source
        self.predicate = predicate
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._schema = schema
        self.fallback = fallback
        self.max_groups = max_groups
        # (agg index, asc, k): a fused ORDER BY <count> LIMIT k
        self.topk = topk
        # a fused HAVING over this exec's output columns
        self.post_filter = post_filter
        self.device = device
        self.cache = cache
        self.fallbacks = 0
        self.resident_emits = 0   # runs whose output stayed on the card

    def children(self):
        return [self.source]

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
            keys = [compile_key(e, pools) for e, _ in self.group_exprs]
            slot_defs, slot_map = self._compile_slots(pools)
            plan = self._plan_key_packing(batches, keys)
            key_progs, lanes, dense = _fold_inputs(keys, plan, slot_defs)
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
                                t.is_boolean, t.is_float)
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
        cols = self._to_device(spec, {i: batch.columns[i]
                                      for i in spec.pools.columns}, cache)
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
            if having is None and slots is None and \
                    groups.shape[1] >= RESIDENT_EMIT_MIN_GROUPS and \
                    self._emit_device_ok(plan):
                with record_function("dft.emit"):
                    return self._emit_resident(groups, plan, names,
                                               slot_map, m)
            with record_function("dft.d2h"):
                host = groups.cpu().numpy()
        return self._emit_groups(host, spec, plan, names, slot_map, m)

    def _emit_device_ok(self, plan) -> bool:
        """The resident emit's shapes (`_emit_device_ok`, `:884-897`):
        integer, decimal, temporal or dictionary keys, count and non-float
        sum aggregates, all stored in int32 or int64 lanes."""
        def lane(t):
            try:
                return np.dtype(t.device_dtype()) in (np.int32, np.int64)
            except NotImplementedError:
                return False
        if not all(lane(t) and not t.is_boolean and not t.is_float
                   for t in plan.key_types):
            return False
        for a in self.aggs:
            if a.name == "count" and not a.distinct:
                continue
            if a.name == "sum" and not a.out_type.is_float and \
                    np.dtype(a.out_type.device_dtype()) == np.int64:
                continue
            return False
        return True

    def _emit_resident(self, groups, plan, names, slot_map, m) -> Batch:
        """The output batch of the compacted `groups` as device-born
        columns (`_emit_device_resident`, `:899-963`)."""
        outs = group_emit_columns(groups,
                                  self.emit_fields(plan, names, slot_map))
        types = list(plan.key_types) + \
            [dt.INT64 if a.name == "count" else a.out_type for a in self.aggs]
        dicts = list(plan.key_dicts) + [None] * len(self.aggs)
        cols = [Column(t, d, v, dic)
                for t, (d, v), dic in zip(types, outs, dicts)]
        ng = groups.shape[1]
        self.resident_emits += 1
        m.record_output(ng)
        return Batch(self._schema, cols, ng)

    def emit_fields(self, plan, names, slot_map) -> List[EmitField]:
        """The resident emit's output columns, in schema order: each group
        key unpacked from row 0, each count and sum from its lane row."""
        fields, shift = [], 0
        for t, bits, offset in zip(plan.key_types, plan.bits, plan.offsets):
            if t.is_dict_coded:
                fields.append(EmitField(EMIT_DICT, torch.int32, 0, shift,
                                        bits))
            else:
                fields.append(EmitField(
                    EMIT_KEY, _NP_TO_TORCH[np.dtype(t.device_dtype())], 0,
                    shift, bits, offset))
            shift += bits
        row = {n: 2 + i for i, n in enumerate(names)}
        for a in self.aggs:
            s = slot_map[a.display]
            if a.name == "count":
                fields.append(EmitField(EMIT_COUNT, torch.int64, row[s["c"]]))
            else:
                fields.append(EmitField(EMIT_SUM, torch.int64, row[s["s"]],
                                        count_row=row[s["c"]]))
        return fields

    def display_line(self):
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        p = f", predicate={self.predicate}" if self.predicate is not None else ""
        t = ""
        if self.topk is not None:
            i, asc, k = self.topk
            t = (f", topk=[{self.aggs[i].display} "
                 f"{'ASC' if asc else 'DESC'} LIMIT {k}]")
        pf = f", having={self.post_filter}" \
            if self.post_filter is not None else ""
        return (f"TorchGroupAggregateExec: gby=[{gb}], aggr=[{ag}]{p}{t}{pf}"
                f", device={self.device}")
