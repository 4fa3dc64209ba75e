"""Distributed two-phase aggregation and the broadcast join over a mesh.

Counterpart of `datafusion_tpu/parallel/distributed.py` (row 21 of the
TPU kernels): the per-shard partial fold, the `all_gather` of the partial
tables, the ownership filter `splitmix64(key) % n == my`, the owner's
final fold and the `all_gather` of the owned results, in one `shard_map`
program each (`:67`, `:130`, `:204`). Here the shard step runs once for
each shard this process holds (`parallel/mesh.py`):

    per shard: a partial group table (the aggregate's own fold kernels,
               or the join's probe-and-fold against a build table)
    exchange:  mesh.all_gather of the compacted partial tables
    final:     K2 `merge_partials` folds the entries each shard owns,
               the ownership test inline, into its own table
    result:    mesh.all_gather of the compacted owned tables

A partial or final table is the hash layout of `device/groupby.py`
(`[lanes + 2, m]` int64: row 0 the keys, row 1 the counts, then the
lanes), so `compact_groups`, the fused HAVING and the emit read the result
like any group table. The broadcast join builds its table once per device
and every shard of the device probes it (`broadcast_join_partials`).

The public functions keep the reference's signatures over raw rows (keys,
validity, value arrays): the arrays are staged as device columns and take
the execs' own path (`shard_partials` or the join's partials, then the
exchange); the results are the replicated group tables, compacted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import dt
from ..device.exchange import MergeTable, merge_partials
from ..device.groupby import (LANE_MAX_F64, LANE_MIN_F64, LANE_SUM_F64,
                              AggregateSpec, HashSpec, compact_groups,
                              dense_group_aggregate, dense_group_table,
                              hash_group_aggregate, lane_kind)
from ..device.join_agg import (JK_INT, Join, JoinBuildSpec, JoinDenseSpec,
                               JoinHashSpec, join_aggregate, join_build,
                               payload_of)
from ..device.lower import Pools, compile_expr, compile_key
from ..physical.expressions import ColumnExpr

Columns = Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor]]]


def row_ranges(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """Shard s's rows [lo, hi): ceil(n / shards) rows a shard, the last
    shards shorter (the reference pads to a multiple of the mesh instead,
    `distributed_aggregate.py:158-165`; padding rows are invalid, so the
    groups are the same)."""
    per = -(-n_rows // n_shards) if n_rows else 0
    return [(min(s * per, n_rows), min((s + 1) * per, n_rows))
            for s in range(n_shards)]


def view_rows(cols: Columns, lo: int, hi: int) -> Columns:
    """The rows [lo, hi) of every column, as views."""
    return {i: (d[lo:hi], None if v is None else v[lo:hi])
            for i, (d, v) in cols.items()}


def as_group_table(spec, table: torch.Tensor) -> torch.Tensor:
    """A fold's table in the hash layout `[lanes + 2, slots]`."""
    return dense_group_table(table) if isinstance(spec, AggregateSpec) \
        else table


def lane_kinds(spec) -> List[int]:
    return [k for _p, k in spec.lanes]


def shard_partials(spec, staged, mesh):
    """Each local shard's compacted partial table and its hash fold's
    overflow flag: the shard's row range of the staged batches (`staged`:
    (rows, device columns, aux) a batch), every piece folded into one
    table by the spec's kernel (`fused_dense_aggregate` for an
    AggregateSpec, `hash_group_aggregate` for a HashSpec)."""
    total = sum(n for n, _c, _a in staged)
    ranges = row_ranges(total, mesh.n)
    out, flags = [], []
    for s in mesh.local:
        lo, hi = ranges[s]
        table = spec.new_table(mesh.device)
        overflow = torch.zeros(1, dtype=torch.int32, device=mesh.device)
        at = 0
        for n, cols, aux in staged:
            a, z = max(lo, at), min(hi, at + n)
            if a < z:
                views = view_rows(cols, a - at, z - at)
                if isinstance(spec, AggregateSpec):
                    dense_group_aggregate(spec, views, aux, z - a, table)
                else:
                    hash_group_aggregate(spec, views, aux, z - a, table,
                                         overflow)
            at += n
        out.append(compact_groups(as_group_table(spec, table)))
        flags.append(overflow)
    return out, flags


def key_stats(spec: HashSpec, cols: Columns, aux: torch.Tensor, n: int,
              parts: Sequence[int]) -> Tuple[int, int]:
    """(rows that pass the spec's predicate with every key part non-NULL,
    the most such rows of one key): `spec` groups by the key parts
    (`parts` their bits, lowest first) with no lanes, folded by
    `hash_group_aggregate` and compacted."""
    table = spec.new_table(aux.device)
    overflow = torch.zeros(1, dtype=torch.int32, device=aux.device)
    hash_group_aggregate(spec, cols, aux, n, table, overflow)
    groups = compact_groups(table)
    live = torch.ones(groups.shape[1], dtype=torch.bool, device=aux.device)
    shift = 0
    for bits in parts:
        live &= ((groups[0] >> shift) & ((1 << bits) - 1)) != 0
        shift += bits
    c = groups[1][live]
    zero = torch.zeros((), dtype=torch.int64, device=aux.device)
    rows, most, bad = torch.stack([c.sum(), c.max() if c.numel() else zero,
                                   overflow[0].to(torch.int64)]).tolist()
    if bad:
        raise RuntimeError(f"key table of {spec.cap} slots overflowed")
    return int(rows), int(most)


def merge_allgather(mesh, partials: Sequence[torch.Tensor],
                    kinds: Sequence[int], limit: int):
    """Row 21's exchange: every shard's compacted partial table gathered,
    each shard's owned entries merged (K2, the ownership test inline),
    the owned tables gathered. Returns (the replicated final table, the
    overflow flags of the local shards, device int32)."""
    every = mesh.all_gather(partials)
    owned, flags = [], []
    for s in mesh.local:
        t = merge_partials(every, MergeTable(kinds, limit, mesh.device),
                           my=s, n_owner=mesh.n)
        owned.append(compact_groups(t.table))
        flags.append(t.overflow)
    del every
    return mesh.all_gather(owned), flags


def overflowed(mesh, flags) -> bool:
    """Whether any shard of the mesh raised one of `flags` (one read of
    the local flags, one all_reduce)."""
    local = bool(torch.stack([f.reshape(-1)[0].to(torch.int64)
                              for f in flags]).max().item()) if flags \
        else False
    return mesh.any([local])


# ---- the broadcast join's shard step ------------------------------------

def broadcast_join_partials(mesh, bspec: JoinBuildSpec, bcols: Columns,
                            baux: torch.Tensor, n_build: int, pair_spec,
                            pcols: Columns, paux: torch.Tensor,
                            n_probe: int):
    """Each local shard's compacted partial table of a broadcast join:
    the build table built once on the device (`join_build`), each shard's
    probe rows (its range of `pcols`, pair-space probe columns; `bcols`
    the build columns, whose indices are the pair space's too) folded by
    `join_aggregate`. `pair_spec(table)` gives the fold's spec over that
    build table. Returns (partials, overflow flags)."""
    table = join_build(bspec, bcols, baux, n_build)
    spec = pair_spec(table)
    partials, flags = [], []
    ranges = row_ranges(n_probe, mesh.n)
    for s in mesh.local:
        lo, hi = ranges[s]
        cols = dict(bcols)
        cols.update(view_rows(pcols, lo, hi))
        t = spec.new_table(mesh.device)
        flag = torch.zeros(1, dtype=torch.int32, device=mesh.device)
        join_aggregate(spec, cols, paux, hi - lo, t, flag)
        partials.append(compact_groups(as_group_table(spec, t)))
        flags.append(flag)
    return spec, partials, flags


# ---- the public functions over raw rows ----------------------------------

_CATS = {"sum": "sum", "count": "cnt", "min": "min", "max": "max"}


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def column(i: int, a: torch.Tensor) -> ColumnExpr:
    """Column i of a raw array's type."""
    t = dt.FLOAT64 if a.dtype.is_floating_point else \
        (dt.BOOL if a.dtype == torch.bool else dt.INT64)
    return ColumnExpr(i, f"c{i}", t)


def pack_of(keys: torch.Tensor) -> Tuple[int, int]:
    """(lo, bits) of raw int64 keys by the mesh rule (the span's bits +
    1); ValueError past 62 bits."""
    lo = int(keys.min()) if keys.numel() else 0
    hi = int(keys.max()) if keys.numel() else 0
    bits = max(int(hi - lo + 1).bit_length() + 1, 2)
    if bits > 62:
        raise ValueError(f"keys span {bits} bits > 62")
    return lo, bits


def aux_of(pools: Pools, device) -> torch.Tensor:
    return torch.from_numpy(pools.aux_buffer(None)).to(device)


def _unpack(packed: torch.Tensor, bounds) -> torch.Tensor:
    """Packed keys back to the raw values ORed: part i `v - lo + 1` in its
    bits."""
    out, shift = torch.zeros_like(packed), 0
    for lo, bits in bounds:
        out |= ((packed >> shift) & ((1 << bits) - 1)) - 1 + lo
        shift += bits
    return out


def table_result(final: torch.Tensor, names: Sequence[str],
                 kinds: Sequence[int], bounds):
    """(group keys, group validity, {name: values}) of a final table, as
    the reference's functions return them (compacted: every group valid),
    the keys unpacked by `bounds`, (lo, bits) a part."""
    aggs = {}
    for i, (n, k) in enumerate(zip(names, kinds)):
        row = final[2 + i]
        aggs[n] = row.view(torch.float64) if k in (
            LANE_SUM_F64, LANE_MIN_F64, LANE_MAX_F64) else row
    return _unpack(final[0], bounds), torch.ones(
        final.shape[1], dtype=torch.bool, device=final.device), aggs


def raw_partials(mesh, keys, valid, values: Dict[str, Tuple[str, object]]):
    """Raw rows folded as the aggregate exec folds its columns: column 0
    the keys, 1 the validity (the predicate), then a value a column; a
    HashSpec grouped by the keys, each local shard's range folded by
    `shard_partials`. Returns (partials, hash overflow flags, lane kinds,
    the keys' (lo, bits))."""
    dev = mesh.device
    k = _tensor(keys, dev).to(torch.int64)
    v = _tensor(valid, dev).to(torch.bool)
    cols: Columns = {0: (k, None), 1: (v, None)}
    pools = Pools()
    pred = compile_expr(column(1, v), pools)
    lo, bits = pack_of(k[v])
    lanes = []
    for j, (kind, a) in enumerate(values.values()):
        cols[2 + j] = (_tensor(a, dev), None)
        prog = compile_expr(column(2 + j, cols[2 + j][0]), pools)
        lanes.append((prog, lane_kind(_CATS[kind], prog)))
    spec = HashSpec(pools, pred, [(compile_key(column(0, k), pools), lo,
                                   bits)], lanes, -(-k.numel() // mesh.n))
    partials, flags = shard_partials(spec, [(k.numel(), cols,
                                             aux_of(pools, dev))], mesh)
    return partials, flags, lane_kinds(spec), (lo, bits)


def distributed_group_aggregate(mesh, keys, row_valid,
                                values: Dict[str, Tuple[str, object]],
                                max_groups: int):
    """`distributed_group_aggregate` (`distributed.py:67`): rows sharded
    by range; value kinds "sum", "count", "min", "max". Returns the
    replicated (group keys, group validity, {name: agg})."""
    partials, _f, kinds, pack = raw_partials(mesh, keys, row_valid, values)
    final, _flags = merge_allgather(mesh, partials, kinds, max_groups)
    return table_result(final, list(values), kinds, [pack])


class RawJoin:
    """A join over raw rows laid out as columns for the port's join
    kernels. Build columns: 0 the key, 1 the group part, then the values;
    probe columns follow in the pair space in the same order, then the
    probe validity and key. The group key is the pair (probe part, build
    part), each packed from its bounds; `result` ORs them back into the
    reference's `pg | bg` (the callers' parts occupy disjoint bits)."""

    def __init__(self, device, bkey: torch.Tensor, bgroup: torch.Tensor,
                 bvals: Dict, pkey: torch.Tensor, pgroup: torch.Tensor,
                 pvals: Dict, pvalid: torch.Tensor, kinds: Dict[str, str]):
        self.device = device
        b_names, p_names = list(bvals), list(pvals)
        self.nb = pb = 2 + len(b_names)
        self.bcols: Columns = {0: (bkey, None), 1: (bgroup, None)}
        self.pcols: Columns = {pb + 1: (pgroup, None)}
        for j, n in enumerate(b_names):
            self.bcols[2 + j] = (bvals[n], None)
        for j, n in enumerate(p_names):
            self.pcols[pb + 2 + j] = (pvals[n], None)
        at = pb + 2 + len(p_names)
        self.pcols[at] = (pvalid, None)
        self.pkey_at = at + 1
        self.pcols[self.pkey_at] = (pkey, None)
        self.bpools, self.pools = Pools(), Pools()
        self.ppred = compile_expr(column(at, pvalid), self.pools)
        self.bounds, self.keys = [], []
        for i, g in ((pb + 1, pgroup), (1, bgroup)):
            lo, bits = pack_of(g)
            self.keys.append((compile_key(column(i, g), self.pools), lo,
                              bits))
            self.bounds.append((lo, bits))
        self.names = sorted(set(b_names) | set(p_names))
        self.lanes = []
        for n in self.names:
            i, a = (2 + b_names.index(n), bvals[n]) if n in bvals else \
                (pb + 2 + p_names.index(n), pvals[n])
            prog = compile_expr(column(i, a), self.pools)
            self.lanes.append((prog, lane_kind(_CATS[kinds[n]], prog)))
        self.kinds = [k for _p, k in self.lanes]
        self.bkey = compile_expr(column(0, bkey), self.bpools)
        self.pkey = compile_expr(column(self.pkey_at, pkey), self.pools)

    def build_spec(self) -> JoinBuildSpec:
        return JoinBuildSpec(self.bpools, None, [(self.bkey, JK_INT)],
                             payload_of(self.pools, self.nb))

    def pair_spec(self, rows: int):
        """spec(table): the fold of the pairs with a build table."""
        def make(table):
            join = Join(self.nb, self.ppred, [(self.pkey, JK_INT)], table)
            if sum(b for _l, b in self.bounds) <= 6:
                return JoinDenseSpec(self.pools, None, self.keys, self.lanes,
                                     join)
            return JoinHashSpec(self.pools, None, self.keys, self.lanes,
                                rows, join)
        return make

    def result(self, final: torch.Tensor):
        """(keys as `pg | bg`, validity, {slot: agg}, pairs) of a final
        table."""
        gk, gv, aggs = table_result(final, self.names, self.kinds,
                                    self.bounds)
        return gk, gv, aggs, final[1]


def raw_join(device, bkey, bgroup, bvals, pkey, pvalid, pgroup, pvals,
             kinds) -> RawJoin:
    return RawJoin(device, _tensor(bkey, device).to(torch.int64),
                   _tensor(bgroup, device).to(torch.int64),
                   {n: _tensor(a, device) for n, a in bvals.items()},
                   _tensor(pkey, device).to(torch.int64),
                   _tensor(pgroup, device).to(torch.int64),
                   {n: _tensor(a, device) for n, a in pvals.items()},
                   _tensor(pvalid, device).to(torch.bool), kinds)


def _join_group(mesh, rj: RawJoin, max_groups: int):
    bk, pk = rj.bcols[0][0], rj.pcols[rj.pkey_at][0]
    _spec, partials, _flags = broadcast_join_partials(
        mesh, rj.build_spec(), rj.bcols, aux_of(rj.bpools, mesh.device),
        bk.shape[0], rj.pair_spec(max_groups), rj.pcols,
        aux_of(rj.pools, mesh.device), pk.shape[0])
    final, _f = merge_allgather(mesh, partials, rj.kinds, max_groups)
    return rj.result(final)


def distributed_join_group_aggregate(mesh, sb_keys, sb_group,
                                     sb_values: Dict[str, object],
                                     probe_keys, probe_valid, probe_group,
                                     probe_values: Dict[str, object],
                                     kinds: Dict[str, str],
                                     fills: Dict[str, float],
                                     max_groups: int, fanout_cap: int):
    """`distributed_join_group_aggregate` (`distributed.py:204`): the build
    side replicated, the probe rows sharded by range, every pair folded
    (no fanout cap: each probe row walks its whole bucket), then the
    all_gather exchange. `fills` are not needed: a row that does not match
    is never folded. Returns the replicated (keys as `pg | bg`, validity,
    {slot: agg})."""
    rj = raw_join(mesh.device, sb_keys, sb_group, sb_values, probe_keys,
                  probe_valid, probe_group, probe_values, kinds)
    gk, gv, aggs, _pairs = _join_group(mesh, rj, max_groups)
    return gk, gv, aggs


def first_rows_of_key(keys: torch.Tensor, cap: int) -> torch.Tensor:
    """Whether each row is among the first `cap` rows of its key, in row
    order: the matches the reference keeps, probing a stably sorted build
    for at most `cap` a probe row."""
    srt, idx = torch.sort(keys, stable=True)
    rank = torch.arange(keys.numel(), device=keys.device) - \
        torch.searchsorted(srt, srt)
    keep = torch.empty_like(keys, dtype=torch.bool)
    keep[idx] = rank < cap
    return keep


def distributed_join_aggregate(mesh, build_keys, build_payload, probe_keys,
                               probe_values, group_keys, max_groups: int,
                               fanout_cap: int = 4):
    """`distributed_join_aggregate` (`distributed.py:130`): per group,
    "s" = sum(build_payload + probe_values) over the pairs and "c" = the
    pairs, each probe row matching at most the first `fanout_cap` build
    rows of its key, as the reference's do."""
    dev = mesh.device
    bk = _tensor(build_keys, dev).to(torch.int64)
    keep = first_rows_of_key(bk, fanout_cap)
    bp, pv = _tensor(build_payload, dev), _tensor(probe_values, dev)
    wide = torch.float64 if bp.dtype.is_floating_point or \
        pv.dtype.is_floating_point else torch.int64
    n = int(np.asarray(probe_keys).shape[0])
    rj = raw_join(dev, bk[keep], torch.zeros_like(bk[keep]),
                  {"b": bp[keep].to(wide)}, probe_keys, np.ones(n, bool),
                  group_keys, {"p": pv.to(wide)}, {"b": "sum", "p": "sum"})
    gk, gv, aggs, pairs = _join_group(mesh, rj, max_groups)
    return gk, gv, {"s": aggs["b"] + aggs["p"], "c": pairs}
