"""Distributed aggregation and join-aggregation over a mesh of shards.

Counterpart of `datafusion_tpu/physical/plan/distributed_aggregate.py`:
`TorchDistributedAggregateExec` (`DistributedAggregateExec`, `:55`) and
`TorchDistributedJoinAggregateExec` (`DistributedJoinAggregateExec`,
`:288`), planned by `UseTorchAggregate`'s mesh branch under
``SET datafusion.tpu.mesh_devices = N`` (N > 1) or the stats-driven
automatic mesh. The mesh is the session's (`SessionContext(mesh=...)`)
when it has N shards, else `make_mesh(N)` on the session's device.

The routes are the reference's, chosen by the same statistics:
- an aggregate whose packed key space (the reference's `_host_pack_plan`
  bits, `:225-253`) is at most min(max_groups, 2^13) takes the all_gather
  route (`distributed_group_aggregate`, `parallel/distributed.py`);
  above, up to n_dev x max_groups, the owned-slot shuffle
  (`distributed_shuffle_group_aggregate`, `parallel/exchange.py`) with the
  reference's table sizes (`:196-207`); beyond, the host plan;
- a join-aggregate whose build side keeps at most
  `hash_join_single_partition_threshold_rows` rows with a key takes the
  broadcast join (`distributed_join_group_aggregate`), else the
  partitioned join (`distributed_partitioned_join_aggregate`), salted as
  the reference salts it (`:615-628`).
Each run appends its route (and salt) to `routes`.

Unlike the reference, which evaluates keys and arguments on the host and
ships padded numpy (`:75-157`, `:398-583`), a shard is a row range (a
view) of the columns already on the device, and each shard's partial
fold runs the port's own kernels: `fused_dense_aggregate` or
`hash_group_aggregate` through the aggregate's spec, `join_build` and
`join_aggregate` for the joins. The statistics the route needs come from
the card too: the key bounds from a one-slot fold of a min and a max lane
a key, and a join side's rows with a key and its most rows of one key
from a hash fold grouped by the join key. The partitioned join packs its
join keys as the reference does (`:412-450`) into one int64 a row, which
K1 hashes to the owner and the build and probe join on.

The output leaves through `_finish`, as a single-device aggregate's does,
so a fused HAVING (`post_filter`) runs in `compact_groups` on the final
table. The reference drops it under a mesh (it calls `_emit_arrays`
directly, `:219`, `:659`); the port applies it.

Refused as the reference refuses them (`:109-117`, `:346-355`, `:420-460`)
and run on the host plan: DISTINCT, FILTER and string min/max; float group
or join keys; keys wider than 62 bits; a residual, a group key or an
argument over both join sides; an empty join side; a build key with more
than 64 rows; a final table's overflow.
"""
from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...common import dt
from ...common.column import to_device
from ...common.datatypes import TypeId
from ...device.groupby import (LANE_MAX_I64, LANE_MIN_I64, MAX_GROUPS,
                               AggregateSpec, HashSpec, dense_group_aggregate,
                               lane_kind)
from ...device.join_agg import (JK_INT, Join, JoinBuildSpec, JoinDenseSpec,
                                JoinHashSpec, payload_of)
from ...device.lower import LoweringError, Pools, compile_expr, compile_key
from ...parallel import distributed as D
from ...parallel import exchange as X
from ...parallel.mesh import make_mesh
from ...runtime import BaselineMetrics
from ..expressions import BinaryPhysExpr, ColumnExpr, rewrite_columns
from .base import collect_batch
from .device_aggregate import (DeviceLoweringUnsupported,
                               TorchGroupAggregateExec, _PackPlan,
                               check_overflow)
from .device_join_agg import TorchJoinAggregateExec, _keeps
from .device_join_chain import _PairView

_MAX_KEY_BITS = 62
# key spaces at or below this broadcast the whole table (`:281`)
BROADCAST_GROUP_LIMIT = 1 << 13
MAX_FANOUT = 64          # build rows of one key (`:555`)
_AGGS = ("count", "sum", "avg", "min", "max")


def _next_pow2(n: int) -> int:
    """The reference's `_next_pow2` (`:284`): at least 16."""
    return 1 << max(int(n - 1).bit_length(), 4)


def _int_like(t) -> bool:
    return t.is_integer or t.is_decimal or \
        t.id in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIME)


def _refuse(aggs) -> None:
    """The reference's admission of a distributed aggregate (`:109-117`)."""
    for a in aggs:
        kind = "avg" if a.name == "mean" else a.name
        if kind not in _AGGS:
            raise DeviceLoweringUnsupported(kind)
        if a.filter is not None or a.distinct:
            raise DeviceLoweringUnsupported("agg FILTER/DISTINCT")
        if kind in ("min", "max") and a.out_type.is_string:
            raise DeviceLoweringUnsupported("string min/max")


class TorchDistributedAggregateExec(TorchGroupAggregateExec):
    """A Single-mode aggregate over `mesh_devices` shards."""

    def __init__(self, source, predicate, group_exprs, aggs, schema,
                 fallback, device: torch.device, cache=None,
                 max_groups: int = 1 << 22, topk=None, post_filter=None,
                 mesh_devices: int = 0, mesh=None):
        super().__init__(source, predicate, group_exprs, aggs, schema,
                         fallback, device, cache, max_groups, topk,
                         post_filter)
        self.mesh_devices = mesh_devices
        self.mesh = mesh
        self.routes: List[Tuple[str, int]] = []

    def with_children(self, c):
        return TorchDistributedAggregateExec(
            c[0], self.predicate, self.group_exprs, self.aggs, self._schema,
            self.fallback, self.device, self.cache, self.max_groups,
            self.topk, self.post_filter, self.mesh_devices, self.mesh)

    def display_line(self):
        return super().display_line().replace(
            "TorchGroupAggregateExec",
            f"TorchDistributedAggregateExec(mesh={self.mesh_devices})")

    def the_mesh(self):
        """The session's mesh when it has `mesh_devices` shards, else a
        LocalMesh of that many on the session's device."""
        if self.mesh is not None and self.mesh.n == self.mesh_devices:
            return self.mesh
        return make_mesh(self.mesh_devices, self.device)

    # ---- statistics on the card ------------------------------------------
    def side_bounds(self, batches, exprs, pred, keep) -> List[Tuple[int, int]]:
        """(lo, hi) of each integer-valued expression over the valid values
        of the rows that pass `pred`: a one-slot fold of a min and a max
        lane an expression (`fused_dense_aggregate`); (0, 0) where no row
        has a value."""
        if not exprs:
            return []
        pools = Pools()
        try:
            p = compile_expr(pred, pools) if pred is not None else None
            lanes = []
            for e in exprs:
                prog = compile_key(e, pools)
                lanes += [(prog, LANE_MIN_I64), (prog, LANE_MAX_I64)]
            spec = AggregateSpec(pools, p, [], lanes)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        table = spec.new_table(self.device)
        for b in batches:
            cols, aux = self.stage(spec, b, keep)
            dense_group_aggregate(spec, cols, aux, b.num_rows, table)
        host = table[1:, 0].tolist()
        return [(0, 0) if host[2 * j] > host[2 * j + 1]
                else (host[2 * j], host[2 * j + 1])
                for j in range(len(exprs))]

    def mesh_plan(self, batches, group_exprs, bounds) -> _PackPlan:
        """The pack plan of `group_exprs` by the reference's mesh rule,
        `bounds` {id(expr): (lo, hi)} from `side_bounds`."""
        return self._plan_key_packing(batches, None, group_exprs,
                                      lambda e: bounds.get(id(e)), mesh=True)

    # ---- the aggregate ---------------------------------------------------
    def compile_mesh(self, batches, rows: int, keep: bool):
        """(spec of a shard's fold of `rows` rows, pack plan, lane names,
        slot map): the single-device lowering, with the reference's mesh
        bits and float sums in float64 (`:145-147`)."""
        _refuse(self.aggs)
        pools = Pools()
        try:
            pred = compile_expr(self.predicate, pools) \
                if self.predicate is not None else None
            keys = [compile_key(e, pools) for e, _ in self.group_exprs]
            slot_defs, slot_map = self._compile_slots(pools, distinct=False)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        ints = [e for e, _ in self.group_exprs if _int_like(e.out_type)]
        plan = self.mesh_plan(batches, self.group_exprs, dict(zip(
            map(id, ints), self.side_bounds(batches, ints, None, keep))))
        key_progs = list(zip(keys, plan.offsets, plan.bits))
        lanes = [(p, lane_kind(cat, p)) for cat, p in slot_defs.values()]
        try:
            if (1 << sum(plan.bits)) <= MAX_GROUPS:
                spec = AggregateSpec(pools, pred, key_progs, lanes)
            else:
                spec = HashSpec(pools, pred, key_progs, lanes, rows)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return spec, plan, list(slot_defs), slot_map

    def shard_partials(self, spec, staged, mesh) -> List[torch.Tensor]:
        """Each local shard's compacted partial table
        (`parallel.distributed.shard_partials`)."""
        partials, flags = D.shard_partials(spec, staged, mesh)
        if isinstance(spec, HashSpec):
            for f in flags:
                check_overflow(f, spec)
        return partials

    def _execute_port(self, partition: int, ctx):
        m = BaselineMetrics(self.metrics, partition)
        batches = self.input_batches(ctx)
        keep = self._source_is_scan()
        n = sum(b.num_rows for b in batches)
        n_dev = self.mesh_devices
        padded = n + ((-n) % n_dev) if n else n_dev
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile_mesh(
                batches, -(-padded // n_dev), keep)
            having = self.having(spec, plan, names, slot_map)
        key_space = 1 << sum(plan.bits)
        if key_space > n_dev * self.max_groups:
            raise DeviceLoweringUnsupported(
                f"key space {key_space} exceeds mesh group capacity "
                f"{n_dev}x{self.max_groups}")
        if n == 0:
            out = self._emit_arrays(None, None, {}, plan, slot_map, m)
            if out is not None:
                m.record_output(out.num_rows)
            return out
        mesh = self.the_mesh()
        kinds = D.lane_kinds(spec)
        with m.elapsed_compute, record_function("dft.aggregate"):
            staged = [(b.num_rows, *self.stage(spec, b, keep))
                      for b in batches]
            partials = self.shard_partials(spec, staged, mesh)
            del staged
        with m.elapsed_compute, record_function("dft.exchange"):
            if key_space <= min(self.max_groups, BROADCAST_GROUP_LIMIT):
                self.routes.append(("distributed_group_aggregate", 1))
                final, flags = D.merge_allgather(mesh, partials, kinds,
                                                 key_space)
                bad = D.overflowed(mesh, flags)
            else:
                self.routes.append(("distributed_shuffle_group_aggregate", 1))
                final_per_shard = max(64, _next_pow2(-(-key_space // n_dev)))
                part = min(key_space, max(final_per_shard,
                                          _next_pow2(max(1, padded // n_dev))))
                final, flags = X.shuffle_merge(
                    mesh, partials, kinds,
                    min(key_space, 2 * final_per_shard),
                    min(part, max(1, 4 * part // n_dev)))
                bad = D.overflowed(mesh, flags) or mesh.any(
                    [max(p.shape[1] for p in partials) > part])
            del partials
        if bad:
            raise DeviceLoweringUnsupported("mesh final group tables exceeded")
        return self._finish(final, spec, plan, names, slot_map, having, m)


def _and_expr(a, b):
    from ...expr.operator import Op
    return b if a is None else BinaryPhysExpr(a, Op.AND, b, dt.BOOL)


class TorchDistributedJoinAggregateExec(TorchJoinAggregateExec,
                                        TorchDistributedAggregateExec):
    """An INNER equi-join under a grouped aggregate over the mesh; the
    constructor mirrors TorchJoinAggregateExec's (group, aggregate and
    residual expressions over the pair space)."""

    def __init__(self, build_source, probe_source, build_keys, probe_keys,
                 build_predicate, probe_predicate, predicate, group_exprs,
                 aggs, schema, fallback, device: torch.device, cache=None,
                 max_groups: int = 1 << 20, topk=None, post_filter=None,
                 mesh_devices: int = 0, broadcast_threshold_rows: int = 131072,
                 mesh=None):
        TorchJoinAggregateExec.__init__(
            self, build_source, probe_source, build_keys, probe_keys,
            build_predicate, probe_predicate, predicate, group_exprs, aggs,
            schema, fallback, device, cache, max_groups, topk, post_filter)
        self.mesh_devices = mesh_devices
        self.mesh = mesh
        # `hash_join_single_partition_threshold_rows`: the build side
        # broadcasts at or below it, else both sides partition (`:321`)
        self.broadcast_threshold_rows = broadcast_threshold_rows
        self.routes = []

    def with_children(self, c):
        return TorchDistributedJoinAggregateExec(
            c[0], c[1], self.build_keys, self.probe_keys,
            self.build_predicate, self.probe_predicate, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.device, self.cache, self.max_groups, self.topk,
            self.post_filter, self.mesh_devices,
            self.broadcast_threshold_rows, self.mesh)

    def display_line(self):
        return TorchJoinAggregateExec.display_line(self).replace(
            "TorchJoinAggregateExec",
            f"TorchDistributedJoinAggregateExec(mesh={self.mesh_devices})")

    # ---- sides -----------------------------------------------------------
    def _side_of(self, e) -> str:
        idxs = e.column_indices()
        if not idxs or all(i >= self.n_build for i in idxs):
            return "p"          # literals ride the probe side
        if all(i < self.n_build for i in idxs):
            return "b"
        raise DeviceLoweringUnsupported("expression spans both join sides")

    def _to_side(self, e, side: str):
        """A pair-space expression over its side's source columns."""
        repl = [ColumnExpr(i if side == "b" else 0, f.name, f.dtype)
                for i, f in enumerate(self.build_source.schema())] + \
               [ColumnExpr(i if side == "p" else 0, f.name, f.dtype)
                for i, f in enumerate(self.probe_source.schema())]
        return rewrite_columns(e, repl)

    def _join_key_plan(self, bb, pb, bpred, ppred, keep_b, keep_p):
        """The reference's joint packing of the join keys (`:412-450`):
        (lo, bits, shift) a key and, for string keys, each side's code
        lookup into the union of the two dictionaries."""
        b_ints = [k for k in self.build_keys if not k.out_type.is_string]
        p_ints = [k for k, b in zip(self.probe_keys, self.build_keys)
                  if not b.out_type.is_string]
        bb_bounds = iter(self.side_bounds([bb], b_ints, bpred, keep_b))
        pb_bounds = iter(self.side_bounds([pb], p_ints, ppred, keep_p))
        plan, shift = [], 0
        for bk, pk in zip(self.build_keys, self.probe_keys):
            bt, pt = bk.out_type, pk.out_type
            luts = (None, None)
            if bt.is_string and pt.is_string:
                bd = bb.columns[bk.index].dictionary
                pd = pb.columns[pk.index].dictionary
                bv = bd.values.astype(str) if bd is not None else \
                    np.zeros(0, str)
                pv = pd.values.astype(str) if pd is not None else \
                    np.zeros(0, str)
                union = np.unique(np.concatenate([bv, pv]))
                luts = (np.searchsorted(union, bv), np.searchsorted(union, pv))
                lo, hi = 0, max(len(union) - 1, 0)
            elif _int_like(bt) or bt.is_boolean:
                (blo, bhi), (plo, phi) = next(bb_bounds), next(pb_bounds)
                lo, hi = min(blo, plo), max(bhi, phi)
            else:
                raise DeviceLoweringUnsupported(f"join key type {bt} on mesh")
            bits = max(int(hi - lo + 1).bit_length(), 1)
            if shift + bits > _MAX_KEY_BITS:
                raise DeviceLoweringUnsupported("join key space too wide")
            plan.append((lo, bits, shift, luts))
            shift += bits
        return plan

    def key_stats(self, batch, keys, pred, plan, keep) -> Tuple[int, int]:
        """(rows that pass `pred` with every join key valid, the most such
        rows of one key): `parallel.distributed.key_stats` grouped by the
        side's join keys."""
        pools = Pools()
        try:
            p = compile_expr(pred, pools) if pred is not None else None
            progs = []
            for k, (lo, bits, _s, luts) in zip(keys, plan):
                if luts[0] is not None:
                    lo = 0
                    dic = batch.columns[k.index].dictionary
                    bits = max(int((len(dic) if dic else 0) + 1)
                               .bit_length(), 1)
                else:
                    bits = max(int(bits + 1), 1)
                progs.append((compile_key(k, pools), lo, bits))
            if sum(b for _p, _l, b in progs) > _MAX_KEY_BITS:
                raise LoweringError("join key stats too wide")
            spec = HashSpec(pools, p, progs, [], batch.num_rows)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        cols, aux = self.stage(spec, batch, keep)
        return D.key_stats(spec, cols, aux, batch.num_rows,
                           [b for _p, _l, b in progs])

    def packed_keys(self, batch, keys, plan, side: int, keep):
        """(the packed join key of every row, whether every key is valid)
        on the device: `sum(clip(raw - lo, 0, 2^bits - 1) << shift)`, a
        string key's code first looked up in the union dictionary."""
        n = batch.num_rows
        packed = torch.zeros(n, dtype=torch.int64, device=self.device)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        for k, (lo, bits, shift, luts) in zip(keys, plan):
            try:
                data, v = to_device(batch.columns[k.index], self.device,
                                    self.cache if keep else None)
            except TypeError as e:
                raise DeviceLoweringUnsupported(str(e))
            raw = data.to(torch.int64)
            if luts[side] is not None:
                lut = torch.from_numpy(np.asarray(luts[side], np.int64)) \
                    .to(self.device)
                raw = lut[raw.clamp(0, max(lut.numel() - 1, 0))] \
                    if lut.numel() else torch.zeros_like(raw)
            packed |= (raw - lo).clamp(0, (1 << bits) - 1) << shift
            if v is not None:
                valid &= v
        return packed, valid

    # ---- lowering --------------------------------------------------------
    def _lower_packed(self, bpred, ppred):
        """The programs of the partitioned join: the broadcast's, with the
        join on one packed int64 key column appended to each side (build
        column `nb`, pair column `n_build + np`)."""
        nb = self.n_build
        npc = len(self.probe_source.schema())
        pools = Pools()
        try:
            pp = compile_expr(self._probe_to_pair(ppred), pools) \
                if ppred is not None else None
            keys = [compile_key(e, pools) for e, _ in self.group_exprs]
            slot_defs, slot_map = self._compile_slots(pools, distinct=False)
            pkey = compile_expr(ColumnExpr(nb + npc, "__key", dt.INT64),
                                pools)
            bpools = Pools()
            bp = compile_expr(bpred, bpools) if bpred is not None else None
            bkey = compile_expr(ColumnExpr(nb, "__key", dt.INT64), bpools)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return (pools, pp, None, keys, slot_defs, slot_map, bpools, bp,
                [(bkey, JK_INT)], [(pkey, JK_INT)])

    def _lower_columns(self, bpred, ppred):
        """The programs of the broadcast join (TorchJoinAggregateExec's)."""
        low = copy.copy(self)
        low.build_predicate, low.probe_predicate = bpred, ppred
        low.predicate = None
        try:
            return TorchJoinAggregateExec.lower(low)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

    def _pair_spec(self, lowered, plan, key_space: int, made: list):
        """spec(table): the fold of the pairs against a build table."""
        pools, ppred, pred, keys, slot_defs, _sm, *_b, pkeys = lowered
        key_progs = list(zip(keys, plan.offsets, plan.bits))
        lanes = [(p, lane_kind(cat, p)) for cat, p in slot_defs.values()]

        def make(table):
            join = Join(self.n_build, ppred, pkeys, table)
            try:
                if sum(plan.bits) <= 6:
                    spec = JoinDenseSpec(pools, pred, key_progs, lanes, join)
                else:
                    spec = JoinHashSpec(pools, pred, key_progs, lanes,
                                        key_space, join)
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
            made.append(spec)
            return spec
        return make

    def _columns(self, batch, idxs, base: int, keep):
        """{pair index: device column} of `batch`'s columns `idxs`."""
        out = {}
        for i in idxs:
            try:
                out[i] = to_device(batch.columns[i - base], self.device,
                                   self.cache if keep else None)
            except TypeError as e:
                raise DeviceLoweringUnsupported(str(e))
        return out

    def _execute_port(self, partition: int, ctx):
        m = BaselineMetrics(self.metrics, partition)
        _refuse(self.aggs)
        bb = collect_batch(self.build_source, ctx)
        pb = collect_batch(self.probe_source, ctx)
        if bb.num_rows == 0 or pb.num_rows == 0:
            raise DeviceLoweringUnsupported("empty join side on mesh")
        keep_b, keep_p = _keeps(self.build_source), _keeps(self.probe_source)
        nb, n_dev = self.n_build, self.mesh_devices
        npc = len(self.probe_source.schema())
        # the residual folds into the one side it reads (`:388-396`)
        bpred, ppred = self.build_predicate, self.probe_predicate
        if self.predicate is not None:
            side = self._side_of(self.predicate)
            p = self._to_side(self.predicate, side)
            if side == "b":
                bpred = _and_expr(bpred, p)
            else:
                ppred = _and_expr(ppred, p)
        for a in self.aggs:
            for x in a.args:
                self._side_of(x)
        with record_function("dft.compile"):
            jplan = self._join_key_plan(bb, pb, bpred, ppred, keep_b, keep_p)
            # group keys: each side's over its rows that pass its predicate
            sides = [self._side_of(e) for e, _ in self.group_exprs]
            exprs = [self._to_side(e, s) for (e, _), s in
                     zip(self.group_exprs, sides)]
            bounds = {}
            for s, batch, pred, keep in (("b", bb, bpred, keep_b),
                                         ("p", pb, ppred, keep_p)):
                mine = [x for x, si in zip(exprs, sides) if si == s and
                        _int_like(x.out_type)]
                bounds.update(zip(map(id, mine), self.side_bounds(
                    [batch], mine, pred, keep)))
            pairs = _PairView(list(bb.columns) + list(pb.columns),
                              pb.num_rows)
            plan = self.mesh_plan([pairs], self.group_exprs, {
                id(e): bounds.get(id(x))
                for (e, _), x in zip(self.group_exprs, exprs)})
            key_space = 1 << sum(plan.bits)
            if key_space > self.max_groups:
                raise DeviceLoweringUnsupported(
                    f"key space {key_space} exceeds mesh group table")
            live_b, fanout = self.key_stats(bb, self.build_keys, bpred, jplan,
                                            keep_b)
            if live_b == 0:
                raise DeviceLoweringUnsupported("empty join side on mesh")
            if fanout > MAX_FANOUT:
                raise DeviceLoweringUnsupported(f"build fanout {fanout} > 64")
        mesh = self.the_mesh()
        made: list = []
        if live_b <= self.broadcast_threshold_rows:
            lowered = self._lower_columns(bpred, ppred)
            pools = lowered[0]
            bspec, bcols, baux = self.build_input(lowered, bb)
            bcols.update(self._columns(bb, [i for i in pools.columns
                                            if i < nb], 0, keep_b))
            pcols = self._columns(pb, [i for i in pools.columns if i >= nb],
                                  nb, keep_p)
            paux = torch.from_numpy(pools.aux_buffer(_PairView(
                list(bb.columns) + list(pb.columns), pb.num_rows))) \
                .to(self.device)
            self.routes.append(("distributed_join_group_aggregate", 1))
            with m.elapsed_compute, record_function("dft.aggregate"):
                spec, partials, flags = D.broadcast_join_partials(
                    mesh, bspec, bcols, baux, bb.num_rows,
                    self._pair_spec(lowered, plan, key_space, made), pcols,
                    paux, pb.num_rows)
                kinds = D.lane_kinds(spec)
            with m.elapsed_compute, record_function("dft.exchange"):
                final, fflags = D.merge_allgather(mesh, partials, kinds,
                                                  key_space)
                del partials
                bad = D.overflowed(mesh, flags + fflags)
        else:
            lowered = self._lower_packed(bpred, ppred)
            pools, bpools = lowered[0], lowered[6]
            with record_function("dft.compile"):
                live_p, hot = self.key_stats(pb, self.probe_keys, ppred,
                                             jplan, keep_p)
            if live_p == 0:
                raise DeviceLoweringUnsupported("empty join side on mesh")
            salt = 1
            kbits = sum(b for _l, b, _s, _t in jplan)
            bkey, bvalid = self.packed_keys(bb, self.build_keys, jplan, 0,
                                            keep_b)
            kmax = 0 if kbits <= 59 else int(torch.where(
                bvalid, bkey, 0).max().item())
            avg = max(1, live_p // n_dev)
            if kmax <= (1 << 59) and hot > 2 * avg:
                salt = int(min(_next_pow2(-(-hot // avg)), n_dev, 8))
            pkey, pvalid = self.packed_keys(pb, self.probe_keys, jplan, 1,
                                            keep_p)
            bcols = self._columns(bb, sorted({i for i in bpools.columns
                                              if i < nb} |
                                             {i for i in pools.columns
                                              if i < nb}), 0, keep_b)
            pcols = self._columns(pb, [i for i in pools.columns
                                       if nb <= i < nb + npc], nb, keep_p)
            baux = torch.from_numpy(bpools.aux_buffer(bb)).to(self.device)
            paux = torch.from_numpy(pools.aux_buffer(_PairView(
                list(bb.columns) + list(pb.columns), pb.num_rows))) \
                .to(self.device)
            np_pad = max(_next_pow2(live_p), n_dev)
            np_pad += (-np_pad) % n_dev
            final_per_shard = max(64, _next_pow2(-(-key_space // n_dev)))
            final_groups = min(key_space, 2 * final_per_shard)
            partial = final_groups * n_dev
            self.routes.append(("distributed_partitioned_join_aggregate",
                                salt))
            with m.elapsed_compute, record_function("dft.aggregate"):
                partials, flags, _per = X.partitioned_join_partials(
                    mesh, bkey, bvalid, bcols, nb, JoinBuildSpec(
                        bpools, lowered[7], lowered[8],
                        payload_of(pools, nb)), baux, pkey, pvalid,
                    pcols, nb + npc,
                    self._pair_spec(lowered, plan, key_space, made), paux,
                    salt, _next_pow2(max(8, 4 * (np_pad // n_dev) // n_dev)))
                del bkey, bvalid, pkey, pvalid, bcols, pcols
            spec = made[0]
            with m.elapsed_compute, record_function("dft.exchange"):
                final, fflags = X.shuffle_merge(
                    mesh, partials, D.lane_kinds(spec), final_groups,
                    max(1, min(partial, 4 * partial // n_dev)))
                bad = D.overflowed(mesh, flags + fflags) or mesh.any(
                    [max(p.shape[1] for p in partials) > partial])
                del partials
        if bad:
            raise DeviceLoweringUnsupported(
                "partitioned join capacity exceeded on mesh")
        names, slot_map = list(lowered[4]), lowered[5]
        having = self.having(spec, plan, names, slot_map)
        return self._finish(final, spec, plan, names, slot_map, having, m)
