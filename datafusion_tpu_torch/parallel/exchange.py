"""The all_to_all exchange: the owned-slot aggregation and the partitioned
hash join.

Counterpart of `datafusion_tpu/parallel/exchange.py` (row 22 of the TPU
kernels). The reference ships fixed blocks of `cap` slots a destination
in chained `lax.while_loop` rounds inside one SPMD program, because its
shapes are static; `build_cap`, `probe_cap`, `fanout_cap` and the
`rows x fanout_cap` pair expansion exist for the same reason. Here:

- each round, K1 `partition_rows` buckets every shard's pending rows by
  owner with exact split sizes, at most `cap` a destination (a memory
  bound: a skewed destination costs rounds, not a bigger buffer), and
  `mesh.all_to_all` ships them; a `mesh.any` of the "rows left" flags
  decides another round;
- the owners fold what arrived at once: one K2 `merge_partials` launch
  into every local shard's group table (`shuffle_merge`), or
  `join_aggregate` against its build partition into its partial table,
  which persists across the rounds (`partitioned_join_partials`);
- the build partition ships once (salted: S replicas keyed (key, s)),
  sized by K1's histogram, and `join_build` stages it; the probe walks
  each row's whole bucket, so there is no fanout cap and no expansion.

The overflow flags that mark a capacity the caller set stay: the final
tables (`final_groups_per_shard`), the partial tables, a build key beyond
`fanout_cap` and a `build_cap` below the rows a shard sends one owner, so
that callers fall back where the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device.exchange import (SALT_REPLICA, SALT_ROW, MergeTables,
                               host_owner, merge_partials, partition_rows,
                               shard_owner)
from ..device.groupby import EMPTY, HashSpec, compact_groups
from ..device.join_agg import join_aggregate, join_build
from ..device.lower import Pools, compile_expr, compile_key
from .distributed import (Columns, _tensor, as_group_table, aux_of, column,
                          key_stats, overflowed, pack_of, raw_join,
                          raw_partials, row_ranges, table_result, view_rows)

__all__ = ["shard_owner", "host_owner", "shuffle_merge",
           "partitioned_join_partials", "distributed_shuffle_group_aggregate",
           "distributed_partitioned_join_aggregate"]

# rounds of the last exchange of each kind, for the tests
ROUNDS: Dict[str, int] = {}


def _lanes_of(cols: Columns):
    """The columns as shippable lanes, and their layout (index, has
    validity) to rebuild them."""
    lanes, layout = [], []
    for i in sorted(cols):
        d, v = cols[i]
        lanes.append(d)
        if v is not None:
            lanes.append(v)
        layout.append((i, v is not None))
    return lanes, layout


def _cols_of(lanes: Sequence[torch.Tensor], layout) -> Columns:
    out, at = {}, 0
    for i, has_v in layout:
        out[i] = (lanes[at], lanes[at + 1] if has_v else None)
        at += 1 + has_v
    return out


def shuffle_merge(mesh, partials: Sequence[torch.Tensor],
                  kinds: Sequence[int], final_groups_per_shard: int,
                  slot_cap: int):
    """Row 22's owned-slot exchange of compacted partial tables: K1
    buckets each shard's entries by owner, at most `slot_cap` a
    destination a round, `mesh.all_to_all` ships them, the local owners
    merge their arrivals (one K2 launch) each into its table of at most
    `final_groups_per_shard` groups; rounds until no shard has entries
    left, then the owned tables are gathered. Returns (the replicated
    final table, the local overflow flags)."""
    tables = MergeTables(kinds, final_groups_per_shard, len(mesh.local),
                         mesh.device)
    pending = [p[0] != EMPTY for p in partials]
    rounds = 0
    while True:
        sends, splits, left = [], [], []
        for p, pend in zip(partials, pending):
            part = partition_rows(p[0], pend, mesh.n, slot_cap,
                                  [p[r] for r in range(1, p.shape[0])])
            sends.append([part.keys] + part.lanes)
            splits.append(part.splits)
            left.append(part.left)
        recv = mesh.all_to_all(sends, splits)
        del sends
        merge_partials([torch.stack(lanes) for lanes in recv], tables)
        rounds += 1
        if not mesh.any(left):
            break
    ROUNDS["shuffle"] = rounds
    owned = [compact_groups(t) for t in tables.tables]
    return mesh.all_gather(owned), list(tables.overflow)


def partitioned_join_partials(mesh, bkey: torch.Tensor, bvalid: torch.Tensor,
                              bcols: Columns, bkey_at: int, bspec, baux,
                              pkey: torch.Tensor, pvalid: torch.Tensor,
                              pcols: Columns, pkey_at: int, pair_spec, paux,
                              salt: int, probe_cap: int):
    """Each local shard's compacted partial table of the partitioned join.

    The build rows (`bkey` int64 join keys, `bvalid` the rows that can
    match, `bcols` the build columns the programs read) ship once to
    their key's owner (salted: S replicas, replica r keyed `key * S + r`);
    each shard stages what it received with `join_build` (`bspec`, its
    key program reading column `bkey_at`). The probe rows stream in
    rounds of at most `probe_cap` a destination (salted: s = local row %
    S), each shard folding its arrivals with `join_aggregate` (the spec
    `pair_spec(table)` over its build table, the probe key at pair column
    `pkey_at`) into its partial table. Returns (partials, overflow flags,
    rows each (sender, owner) shipped of the build, summed over
    replicas)."""
    dev, n = mesh.device, mesh.n
    branges, pranges = row_ranges(bkey.numel(), n), row_ranges(pkey.numel(), n)
    blanes_layout = None
    got_build = [[] for _ in mesh.local]
    per_owner = [np.zeros(n, np.int64) for _ in mesh.local]
    for r in range(max(salt, 1)):
        sends, splits = [], []
        for i, s in enumerate(mesh.local):
            lo, hi = branges[s]
            lanes, blanes_layout = _lanes_of(view_rows(bcols, lo, hi))
            part = partition_rows(bkey[lo:hi], bvalid[lo:hi].clone(), n,
                                  max(hi - lo, 1), lanes, salt,
                                  SALT_REPLICA, r)
            per_owner[i] += np.asarray(part.splits, np.int64)
            sends.append([part.keys] + part.lanes)
            splits.append(part.splits)
        for i, g in enumerate(mesh.all_to_all(sends, splits)):
            got_build[i].append(g)
        del sends
    state = []
    for i in range(len(mesh.local)):
        reps = got_build[i]
        lanes = [torch.cat([g[j] for g in reps]) for j in range(len(reps[0]))]
        cols = _cols_of(lanes[1:], blanes_layout)
        cols[bkey_at] = (lanes[0], None)
        table = join_build(bspec, cols, baux, lanes[0].numel())
        spec = pair_spec(table)
        del cols[bkey_at]
        state.append((cols, spec, spec.new_table(dev),
                      torch.zeros(1, dtype=torch.int32, device=dev)))
    del got_build
    pending = [pvalid[lo:hi].clone() for lo, hi in
               (pranges[s] for s in mesh.local)]
    rounds = 0
    while True:
        sends, splits, left = [], [], []
        for i, s in enumerate(mesh.local):
            lo, hi = pranges[s]
            lanes, players = _lanes_of(view_rows(pcols, lo, hi))
            part = partition_rows(pkey[lo:hi], pending[i], n, probe_cap,
                                  lanes, salt, SALT_ROW)
            sends.append([part.keys] + part.lanes)
            splits.append(part.splits)
            left.append(part.left)
        recv = mesh.all_to_all(sends, splits)
        del sends
        for (bc, spec, group, flag), g in zip(state, recv):
            cols = dict(bc)
            cols.update(_cols_of(g[1:], players))
            cols[pkey_at] = (g[0], None)
            join_aggregate(spec, cols, paux, g[0].numel(), group, flag)
        del recv
        rounds += 1
        if not mesh.any(left):
            break
    ROUNDS["probe"] = rounds
    partials = [compact_groups(as_group_table(spec, group))
                for _c, spec, group, _f in state]
    return partials, [f for *_s, f in state], per_owner


# ---- the public functions over raw rows ----------------------------------

def _slot_cap(partial_groups: int, n: int) -> int:
    # expected L/n a destination; 4x slack makes one round typical
    return max(1, min(partial_groups, 4 * partial_groups // n))


def distributed_shuffle_group_aggregate(
        mesh, keys, row_valid, values: Dict[str, Tuple[str, object]],
        partial_groups: int, final_groups_per_shard: int,
        slot_cap: Optional[int] = None):
    """`distributed_shuffle_group_aggregate` (`exchange.py:243`): each
    shard's rows folded into a partial table (at most `partial_groups`
    groups), then the owned-slot exchange into tables of at most
    `final_groups_per_shard` groups a shard. Returns the replicated
    (keys, validity, {name: agg}) and `overflow` > 0 when a partial or
    final table's capacity was exceeded."""
    slot_cap = slot_cap or _slot_cap(partial_groups, mesh.n)
    partials, pflags, kinds, pack = raw_partials(mesh, keys, row_valid,
                                                 values)
    final, fflags = shuffle_merge(mesh, partials, kinds,
                                  final_groups_per_shard, slot_cap)
    gk, gv, aggs = table_result(final, list(values), kinds, [pack])
    bad = overflowed(mesh, pflags + fflags) or mesh.any(
        [max(p.shape[1] for p in partials) > partial_groups])
    return gk, gv, aggs, int(bad)


def build_fanout(bkey: torch.Tensor, bvalid: torch.Tensor) -> int:
    """The most valid rows of one build key, by `key_stats`' hash fold."""
    pools = Pools()
    pred = compile_expr(column(1, bvalid), pools)
    lo, bits = pack_of(bkey[bvalid])
    spec = HashSpec(pools, pred, [(compile_key(column(0, bkey), pools), lo,
                                   bits)], [], bkey.numel())
    return key_stats(spec, {0: (bkey, None), 1: (bvalid, None)},
                     aux_of(pools, bkey.device), bkey.numel(), [bits])[1]


def distributed_partitioned_join_aggregate(
        mesh, build_keys, build_valid, build_group,
        build_values: Dict[str, object], probe_keys, probe_valid,
        probe_group, probe_values: Dict[str, object],
        kinds: Dict[str, str], fills: Dict[str, float],
        final_groups_per_shard: int, build_cap: int, probe_cap: int,
        fanout_cap: int, partial_groups: Optional[int] = None,
        slot_cap: Optional[int] = None, salt: int = 1):
    """`distributed_partitioned_join_aggregate` (`exchange.py:319`):
    neither side replicated; the build ships once to its key's owner, the
    probe in rounds of at most `probe_cap` rows a destination, each owner
    joins and folds into its partial table, and the partial tables take
    the owned-slot exchange. `fills` are not needed (no pair is padded).
    Returns the replicated (keys as `pg | bg`, validity, {slot: agg}) and
    `overflow` > 0 where the reference's is: a build key with more than
    `fanout_cap` rows, more build rows from one shard to one owner than
    `build_cap`, a partial table past `partial_groups` or a final table
    past `final_groups_per_shard` groups."""
    dev, n = mesh.device, mesh.n
    partial_groups = partial_groups or final_groups_per_shard * n
    slot_cap = slot_cap or _slot_cap(partial_groups, n)
    rj = raw_join(dev, build_keys, build_group, build_values, probe_keys,
                  probe_valid, probe_group, probe_values, kinds)
    bk, pk = rj.bcols[0][0], rj.pcols[rj.pkey_at][0]
    bv = _tensor(build_valid, dev).to(torch.bool)
    pv = rj.pcols[rj.pkey_at - 1][0]
    bcols = {i: c for i, c in rj.bcols.items() if i != 0}
    pcols = {i: c for i, c in rj.pcols.items() if i != rj.pkey_at}
    partials, flags, per_owner = partitioned_join_partials(
        mesh, bk, bv, bcols, 0, rj.build_spec(), aux_of(rj.bpools, dev), pk,
        pv, pcols, rj.pkey_at, rj.pair_spec(partial_groups),
        aux_of(rj.pools, dev), salt, probe_cap)
    ovf = build_fanout(bk, bv) > fanout_cap
    ovf |= any(int(p.max()) > build_cap for p in per_owner)
    ovf |= any(p.shape[1] > partial_groups for p in partials)
    final, fflags = shuffle_merge(mesh, partials, rj.kinds,
                                  final_groups_per_shard, slot_cap)
    gk, gv, aggs, _pairs = rj.result(final)
    bad = overflowed(mesh, flags + fflags) or mesh.any([ovf])
    return gk, gv, aggs, int(bad)
