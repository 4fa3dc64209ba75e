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

A filtered SEMI or ANTI hop (`member_col OP probe_expr`, TPC-H Q21's
`l2.l_suppkey <> l1.l_suppkey`) stages a min/max table and tests membership
in the walk (`_stage_semi_member_lut` `:1158`, `_mmx_exists` `:1325`).

Staging-time composition and folding (`compose_builds`; the reference's
`_compose_staged_hops` `:786` and `_fold_lut_pmat` `:719`, called at
`:712-714`). After the tables are staged, the reference's test runs over
them in chain order: a hop whose probe keys are all integer payload
columns of one earlier INNER hop (or of hops already composed into it) is
composed into that owner when the owner has a payload and at most 2^22
build rows (`chain_compose`, one launch a composed hop), and an INNER hop
the reference would stage as a direct-address table is folded when its
span x (1 + its lanes, composed ones included) is at most 2^24
(`chain_fold` in `chain()`, over the payload columns the walk reads).
Spans and lanes are counted as the reference counts them, so both
packages compose and fold the same hops at every scale. Tables, composed
words and records are built per execution; the reference's cross-query
cache of them (`_CMP_CACHE`) is not ported.

Functional dependence (`_fd_reduce` `:1501`, `_fd_finalize` `:1359`). A
group key that is a payload column of a unique-key INNER build leaves the
packed key when the remaining keys determine that build's probe keys
(TPC-H Q18: five keys reduce to `o_orderkey`; Q10: to `c_custkey`). The
walk then also folds a representative spine row per group (a max lane
over `OP_ROWID`), and the emit replays the INNER hops on the host for
those rows only and evaluates the dropped keys over them. As in the
reference, this needs a single spine batch.

count(DISTINCT x) folds through the distinct lane of the grouped fold
(`_chain_slots` `:1459-1460`), its pairs in a `DistinctSet` sized at twice
the spine rows; unlike the reference (`:445-449`) it takes any number of
spine batches.

A shape outside the port raises DeviceLoweringUnsupported and runs the
host plan (`fallback`), as the reference does: an INNER
build with a duplicate key (fanout > 1), string or float join keys
(`:350-354`), a min/max filter over a non-integer member column, more than
8 hops, and group keys wider than 62 bits after the reduction. Each
fallback adds one to `self.fallbacks`.

TorchJoinChainRowsExec is the row-returning sibling
(`DeviceJoinChainRowsExec`, `:2142-2397`), planned by `UseTorchJoinRows`
for a join tree with no aggregate above it. Both extend TorchChainExec,
which holds what they share: the builds and their staging, and the pair
space. In the rows exec one `chain_rows` call per spine batch returns
the surviving rows' output columns, which leave as device-born columns (one `Batch` a
spine batch that keeps any row). A build side whose columns are
device-born (a large aggregate's resident emit, TPC-H Q20) stages from
them with no host round trip.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ...common.batch import Batch, round_capacity
from ...common.column import Column, DeviceColumnCache
from ...device.groupby import _NP_TO_TORCH, AggregateSpec, dense_group_table
from ...device.join_chain import (ChainDenseSpec, ChainHashSpec,
                                  ChainRowsSpec, Chain, BuildSpec, Compose,
                                  ComposeSpec, Fold, Hop, chain_aggregate,
                                  chain_build, chain_compose, chain_fold,
                                  chain_rows, stub_hop)
from ...device.lower import (_CMP, OP_COL, OP_NULL, OP_ROWID, LoweringError,
                             Pools, Program, compile_expr, compile_key)
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import ColumnExpr, PhysicalExpr
from .base import ExecutionPlan, collect_batch, execute_stream
from .device_aggregate import (DeviceLoweringUnsupported, TorchAggregate,
                               TorchDeviceExec, _fold_inputs,
                               check_distinct_overflow, check_overflow)
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
    resident, and once staged its `table`, its `compose` record when it
    was composed into an earlier hop, and `fold`, the reference's (span,
    width) of its fold when it folds."""

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
        self.compose: Optional[Compose] = None
        self.fold = None


class _PoolColumns:
    """The device dtype each program of a pool reads a column at."""

    def __init__(self, pools: Pools):
        self.pools = pools

    def column_dtype(self, idx: int) -> torch.dtype:
        return _NP_TO_TORCH[self.pools.columns[idx]]


def _lanes(col: Column) -> Tuple[int, bool, bool]:
    """How the reference's payload matrix holds a column
    (`_stage_payload_matrix`, `:1007`): (its int32 lanes: two for int64,
    none for float64, else one, and one more for a validity; whether it is
    an integer lane, `i64` or `int`, which a composed hop may probe by;
    whether it is float64)."""
    dt = np.dtype(col.dtype.device_dtype())
    n = 2 if dt in (np.int64, np.uint64) else 0 if dt == np.float64 else 1
    return n + col.has_nulls, dt.kind in "iu", dt == np.float64


class TorchChainExec(TorchDeviceExec):
    """The chain layer both chain execs share: the spine source and its
    probe predicate, the builds and the residual; the builds staged on
    the card (`chain_build`), the pair space of a spine batch and its
    columns staged on the card. Subclasses implement `_execute_port`; a
    DeviceLoweringUnsupported from it adds one to `fallbacks`."""

    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr], schema,
                 fallback: ExecutionPlan, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None):
        super().__init__()
        self.source = probe_source
        self.probe_predicate = probe_predicate
        self.builds = builds
        self.predicate = predicate
        self._schema = schema
        self.fallback = fallback
        self.device = device
        self.cache = cache
        self.fallbacks = 0

    def children(self):
        return [self.source] + [b.source for b in self.builds]

    def _builds_over(self, sources) -> List[ChainBuild]:
        """The chain's builds over new build sources (`with_children`)."""
        return [ChainBuild(src, b.probe_keys, b.build_keys, b.payload,
                           b.join_type, b.sfilter)
                for src, b in zip(sources, self.builds)]

    def chain_display(self) -> str:
        steps = ", ".join(
            f"{b.join_type}[{', '.join(str(k) for k in b.probe_keys)}]"
            + (f" filter=({b.sfilter[1]} {b.sfilter[0].value} "
               f"{b.sfilter[2]})" if b.sfilter is not None else "")
            for b in self.builds)
        return f"chain=[{steps}]"

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

    def check_builds(self) -> None:
        """Raise LoweringError for a build the walk cannot take: a string
        or float join key, or a min/max filter over a non-integer member
        column or a string probe expression (`:350-363`)."""
        for b in self.builds:
            for pk, bk in zip(b.probe_keys, b.build_keys):
                if pk.out_type.is_string or bk.out_type.is_string or \
                        pk.out_type.is_float or bk.out_type.is_float:
                    raise LoweringError("non-integer chain join key")
            if b.sfilter is not None:
                _op, ocol, pexpr = b.sfilter
                if not ocol.out_type.is_integer or pexpr.out_type.is_string:
                    raise LoweringError("semi filter needs int member col")

    def lower_mfilters(self, pools: Pools):
        """Each build's min/max test as (comparison code, program of the
        probe expression over the pair space; integer, as the reference's
        `astype(int64)` makes it), or None."""
        out = []
        for b in self.builds:
            if b.sfilter is None:
                out.append(None)
                continue
            op, _ocol, pexpr = b.sfilter
            out.append((_CMP[op], compile_key(pexpr, pools)))
        return out

    def chain(self, ppred, staged: List[_BuildInput], probe_keys,
              mfilters, pools: Pools, reads) -> Chain:
        """The walk over the staged builds: one hop a build, with its
        lowered probe keys, its payload's pair-space indices, its min/max
        test and its composition; then each folding hop's records
        (`chain_fold`) over the payload columns that the chain's programs
        and `reads` (the walk's other programs) read."""
        hops = [Hop(s.table, b.join_type, pk, payload, mf, s.compose)
                for b, s, pk, payload, mf in zip(
                    self.builds, staged, probe_keys, self.payload_ranges(),
                    mfilters)]
        chain = Chain(self.n_spine, ppred, hops)
        read = {a for prog in list(reads) + chain.programs()
                if prog is not None for op, a, _b in prog.code
                if op == OP_COL}
        dtypes = _PoolColumns(pools)
        for h, (hop, s) in enumerate(zip(hops, staged)):
            if s.fold is None:
                continue
            idxs = [p for p in hop.payload if p in read]
            cols = {}
            for p in idxs:
                cols.update(self._to_device(
                    dtypes, {p: self._pair_column(staged, p)}, s.keep))
            comp = next((o.compose.words for o in hops
                         if o.compose is not None and o.compose.owner == h),
                        None)
            fold = Fold(0 if comp is None else comp.shape[1],
                        [(p, cols[p][1] is not None) for p in idxs], *s.fold)
            fold.records, fold.valid = chain_fold(
                s.table, comp, [cols[p] for p in idxs], fold)
            hop.fold = fold
        return chain

    def _pair_column(self, staged: List[_BuildInput], idx: int) -> Column:
        """The build column behind pair-space payload column `idx`."""
        for b, s, r in zip(self.builds, staged, self.payload_ranges()):
            if idx in r:
                return s.batch.columns[s.col_map[b.payload[r.index(idx)]]]
        raise KeyError(idx)

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
                member = None
                if b.sfilter is not None:
                    ocol = b.sfilter[1]
                    member = compile_expr(ColumnExpr(
                        col_map[ocol.index], ocol.name, ocol.out_type), pools)
                spec = BuildSpec(pools, bpred, keys, member)
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
            cols = self._to_device(spec, {i: bb.columns[i]
                                          for i in pools.columns}, keep)
            aux = torch.from_numpy(pools.aux_buffer(bb)).to(self.device)
            out.append(_BuildInput(spec, cols, aux, b.join_type == "INNER",
                                   bb, col_map, keep))
        return out

    def stage_builds(self, ctx: TaskContext,
                     compose: bool = True) -> List[_BuildInput]:
        """Every build side staged on the card as a table (`chain_build`),
        then, unless `compose` is false, the hops composed and the folds
        chosen (`compose_builds`). An INNER build with a duplicate key, a
        build of 2^31 rows or more, or packed keys wider than 62 bits raise
        DeviceLoweringUnsupported (`:700`)."""
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
        if compose:
            self.compose_builds(out)
        return out

    def compose_plan(self, staged: List[_BuildInput]):
        """The reference's choice (`_compose_staged_hops` `:812-839`, then
        `_fold_lut_pmat` `:729-737`): ({composed hop: (owner, tag)},
        {folded hop: (span, width)}), hops in chain order. `registry` maps a
        pair-space payload column to the hop whose lanes hold it (an
        uncomposed INNER hop, or the owner of a composed one) and whether
        it is an integer lane; `lanes` counts each such hop's int32 lanes
        as the reference's payload matrix does, composed ones included."""
        n_spine = self.n_spine
        ranges = self.payload_ranges()
        registry, lanes, has_matrix = {}, {}, set()
        composed = {}
        for bi, (b, s) in enumerate(zip(self.builds, staged)):
            inner = b.join_type == "INNER"
            pcols = [_lanes(s.batch.columns[s.col_map[i]])
                     for i in b.payload] if inner else []
            keys = b.probe_keys
            owner = None
            if keys and all(isinstance(k, ColumnExpr) and k.index >= n_spine
                            and k.index in registry for k in keys):
                owners = {registry[k.index][0] for k in keys}
                if len(owners) == 1:
                    owner = owners.pop()
            if owner is not None and not (
                    owner in has_matrix and
                    all(registry[k.index][1] for k in keys) and
                    not any(f64 for _n, _i, f64 in pcols) and
                    round_capacity(len(staged[owner].batch.columns[0])
                                   if staged[owner].batch.columns else 0)
                    <= (1 << 22)):
                owner = None
            if owner is None:
                if inner and pcols:
                    for p, (_n, key_ok, _f) in zip(ranges[bi], pcols):
                        registry[p] = (bi, key_ok)
                    lanes[bi] = sum(n for n, _i, _f in pcols)
                    if lanes[bi]:
                        has_matrix.add(bi)
                continue
            if b.sfilter is not None:
                tag, new = "mmx", 1 + 2 * self._mmx_lanes(b, s)
            elif inner and pcols:
                tag, new = "inner", 1 + sum(n for n, _i, _f in pcols)
                for p, (_n, key_ok, _f) in zip(ranges[bi], pcols):
                    registry[p] = (owner, key_ok)
            else:
                tag, new = "member", 1
            composed[bi] = (owner, tag)
            lanes[owner] += new
        folded = {}
        for bi, (b, s) in enumerate(zip(self.builds, staged)):
            if bi in composed or bi not in has_matrix:
                continue
            span = self._lut_span(b, s, lanes[bi])
            if span is not None:
                folded[bi] = (span, 1 + lanes[bi])
        return composed, folded

    @staticmethod
    def _mmx_lanes(b: ChainBuild, s: _BuildInput) -> int:
        """The int32 lanes the reference gives each of a composed min/max
        hop's min and max (`:858-863`): one when its table is
        direct-address (unfiltered key bits at most 26, `:1245`) and the
        member column fits int32 (`:1211-1215`), else two."""
        n = s.batch.num_rows
        if n == 0:
            return 2
        bits = 0
        for k in b.build_keys:
            a = s.batch.columns[s.col_map[k.index]].data_host()[:n]
            bits += max(int(np.ceil(np.log2(int(a.max()) - int(a.min())
                                            + 2))), 1)
        if bits > 26:
            return 2
        fa = s.batch.columns[s.col_map[b.sfilter[1].index]].data_host()[:n]
        fit32 = int(fa.min()) > np.iinfo(np.int32).min + 1 and \
            int(fa.max()) < np.iinfo(np.int32).max
        return 1 if fit32 else 2

    @staticmethod
    def _lut_span(b: ChainBuild, s: _BuildInput,
                  lanes: int) -> Optional[int]:
        """The span of the direct-address table the reference stages for
        the INNER build `b` (`_unfiltered_lut`, `:177`): 1 << the bits of
        its unfiltered keys' ranges, when they are unique non-null integers
        spanning at most 2^24 and 16 x its rows, and it is not a build the
        reference stages from device-born columns (`_stage_build_device`,
        `:1069`: 4 MB or more and no predicate); and only when the fold's
        budget, span x (1 + `lanes`) <= 2^24, holds. Else None. A build
        whose every row is live (no predicate, no NULL key) has its key
        ranges and uniqueness in its table already; another takes them on
        the card."""
        bb = s.batch
        n = bb.num_rows
        keys = [bb.columns[s.col_map[k.index]] for k in b.build_keys]
        if n == 0 or any(c.has_nulls or not c.dtype.is_integer
                         for c in keys):
            return None
        if s.spec.pred is None and bb.nbytes() >= (4 << 20) and all(
                c.device_born and getattr(c, "_host_cache", None) is None
                for c in keys):
            return None
        whole = s.table.live == n      # the table knows the unfiltered keys
        vals = [s.cols[s.col_map[k.index]][0][:n].to(torch.int64)
                for k in b.build_keys]
        ext = list(zip(s.table.los, s.table.his)) if whole else \
            torch.stack([torch.stack([v.min(), v.max()])
                         for v in vals]).cpu().tolist()
        bits = [max(int(np.ceil(np.log2(hi - lo + 2))), 1) for lo, hi in ext]
        span = 1 << sum(bits)
        if span > min(1 << 24, 16 * n) or span * (1 + lanes) > (1 << 24):
            return None
        if whole:                      # an INNER table has no duplicate
            return span
        packed, shift = torch.zeros_like(vals[0]), 0
        for v, (lo, _hi), w in zip(vals, ext, bits):
            packed |= (v - lo) << shift
            shift += w
        return span if torch.unique(packed).numel() == n else None

    def compose_builds(self, staged: List[_BuildInput]) -> None:
        """Compose and mark for folding the hops `compose_plan` picks: each
        owner's composed words (int64 [its build rows, words]: one a hop,
        three for a min/max hop), filled by one `chain_compose` a composed
        hop in chain order, so a later one reads an earlier one's rows."""
        composed, folded = self.compose_plan(staged)
        width = {}
        for owner, tag in composed.values():
            width[owner] = width.get(owner, 0) + (3 if tag == "mmx" else 1)
        words = {o: torch.zeros((staged[o].batch.num_rows, w),
                                dtype=torch.int64, device=self.device)
                 for o, w in width.items()}
        used = {o: 0 for o in width}
        for bi, (owner, tag) in composed.items():
            spec, cols, aux, n = self.compose_input(staged, bi, owner)
            chain_compose(spec, cols, aux, n, words[owner], used[owner])
            staged[bi].compose = Compose(owner, tag, words[owner],
                                         used[owner])
            used[owner] += 3 if tag == "mmx" else 1
        for bi, budget in folded.items():
            staged[bi].fold = budget

    def compose_input(self, staged: List[_BuildInput], bi: int, owner: int):
        """What `chain_compose` takes to compose hop `bi` into `owner`: (its
        ComposeSpec, the pair-space columns its probe keys read, aux, the
        owner's build rows). The hops composed into `owner` before `bi`
        enter the spec's chain as they are staged (their payload may be a
        key); every other earlier hop is a stub."""
        b, s = self.builds[bi], staged[bi]
        ranges = self.payload_ranges()
        pools = Pools()
        try:
            keys = [compile_expr(k, pools) for k in b.probe_keys]
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        hops = []
        for h in range(bi):
            c = staged[h].compose
            if c is not None and c.owner == owner and ranges[h]:
                hops.append(Hop(staged[h].table, "INNER", [], ranges[h],
                                compose=c))
            else:
                hops.append(stub_hop(ranges[h], staged[h].table.rows))
        hops.append(Hop(s.table, b.join_type, keys, ranges[bi]))
        spec = ComposeSpec(pools, Chain(self.n_spine, None, hops), owner)
        cols = {}
        for p in pools.columns:
            h = spec.chain.hop_of[p]
            cols.update(self._to_device(
                spec, {p: self._pair_column(staged, p)}, staged[h].keep))
        aux = torch.zeros(0, dtype=torch.int64, device=self.device)
        return spec, cols, aux, staged[owner].batch.num_rows

    def pair_view(self, spine_batch, staged: List[_BuildInput]) -> _PairView:
        cols = list(spine_batch.columns)
        for b, s in zip(self.builds, staged):
            if b.join_type == "INNER":
                cols += [s.batch.columns[s.col_map[i]] for i in b.payload]
        return _PairView(cols, spine_batch.num_rows)

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
        # `execute` runs `self.fallback` on this exception
        try:
            return self._execute_port(partition, ctx)
        except DeviceLoweringUnsupported:
            self.fallbacks += 1
            raise


class TorchJoinChainAggregateExec(TorchChainExec, TorchAggregate):

    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr],
                 group_exprs, aggs, schema, fallback: ExecutionPlan,
                 device: torch.device,
                 cache: Optional[DeviceColumnCache] = None,
                 max_groups: int = 1 << 22):
        super().__init__(probe_source, probe_predicate, builds, predicate,
                         schema, fallback, device, cache)
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.max_groups = max_groups

    def with_children(self, c):
        return TorchJoinChainAggregateExec(
            c[0], self.probe_predicate, self._builds_over(c[1:]),
            self.predicate, self.group_exprs, self.aggs, self._schema,
            self.fallback, self.device, self.cache, self.max_groups)

    def display_line(self):
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        return (f"TorchJoinChainAggregateExec: {self.chain_display()}, "
                f"gby=[{gb}], aggr=[{ag}], device={self.device}")

    def lower(self):
        """(pools, probe predicate, residual, group keys, slot defs, slot
        map, probe keys of each build, min/max test of each build): every
        pair-space program of the chain on one pool."""
        self.check_builds()
        pools = Pools()
        ppred = compile_expr(self.probe_predicate, pools) \
            if self.probe_predicate is not None else None
        pred = compile_expr(self.predicate, pools) \
            if self.predicate is not None else None
        keys = [compile_key(e, pools) for e, _ in self.group_exprs]
        slot_defs, slot_map = self._compile_slots(pools)
        probe_keys = [[compile_expr(k, pools) for k in b.probe_keys]
                      for b in self.builds]
        return (pools, ppred, pred, keys, slot_defs, slot_map, probe_keys,
                self.lower_mfilters(pools))

    def compile(self, lowered, staged: List[_BuildInput], views):
        """(spec, pack plan, lane names, slot map) of the chain over the
        staged builds and the spine batches' pair views. With one spine
        batch the group keys are reduced by functional dependence
        (`_fd_reduce`, wired as `:395-420`): the plan's `kept` and
        `dropped` key positions, and a `__rep#x` lane of the
        representative spine row when any key was dropped."""
        (pools, ppred, pred, keys, slot_defs, slot_map, probe_keys,
         mfilters) = lowered
        kept, dropped = self._fd_reduce() if len(views) == 1 else \
            (list(range(len(self.group_exprs))), [])
        if dropped:
            keys = [keys[p] for p in kept]
            slot_defs = dict(slot_defs)
            slot_defs["__rep#x"] = ("rowid", Program(
                [(OP_ROWID, 0, 0)], pools, np.dtype(np.int64)))
        self._check_distinct_dicts(views)
        plan = self._plan_key_packing(
            views, keys, [self.group_exprs[p] for p in kept])
        plan.kept, plan.dropped = kept, dropped
        try:
            key_progs, lanes, dense = _fold_inputs(keys, plan, slot_defs)
            chain = self.chain(ppred, staged, probe_keys, mfilters, pools,
                               [pred] + [k for k, _o, _b in key_progs] +
                               [p for p, _k in lanes])
            rows = sum(v.num_rows for v in views)
            if dense:
                spec = ChainDenseSpec(pools, pred, key_progs, lanes, chain)
            else:
                spec = ChainHashSpec(pools, pred, key_progs, lanes, rows,
                                     chain)
            spec.check_distinct_set(rows)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        return spec, plan, list(slot_defs), slot_map

    def prepare(self, ctx: TaskContext, compose: bool = True):
        """Everything a run needs before the walk: the builds staged on the
        card (composed and folded unless `compose` is false), the chain
        compiled, each spine batch's columns staged. Returns (spec, pack
        plan, lane names, slot map, [(cols, aux, rows) per spine batch],
        staged builds)."""
        with record_function("dft.compile"):
            try:
                lowered = self.lower()
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
        with record_function("dft.build"):
            staged = self.stage_builds(ctx, compose)
        spine = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        views = [self.pair_view(b, staged) for b in spine]
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile(lowered, staged, views)
        if plan.dropped:
            plan.finalize = self._fd_finalize(plan.kept, plan.dropped,
                                              spine[0], staged)
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
                dset = spec.distinct_set(sum(r for _c, _a, r in inputs),
                                         self.device)
                for cols, aux, rows in inputs:
                    chain_aggregate(spec, cols, aux, rows, table, overflow,
                                    dset)
                if isinstance(spec, AggregateSpec):
                    table = dense_group_table(table)
                else:
                    check_overflow(overflow, spec)
                check_distinct_overflow(dset)
                del dset
            host = self._fetch_groups(table)
            del table, inputs, staged
        return self._emit_groups(host, spec, plan, names, slot_map, m,
                                 plan.finalize)

    def _fd_reduce(self):
        """(kept positions, dropped positions) of the group keys under
        functional dependence, as the reference's `_fd_reduce` (`:1501`):
        a group key that is a payload column of a unique-key INNER build
        whose probe keys the remaining keys determine is constant within
        a group, so it needs no bits in the packed key. Candidates go from
        the widest pair-space index down; at least one key stays."""
        every = list(range(len(self.group_exprs)))
        if self.post_filter is not None or len(self.group_exprs) < 2:
            return every, []
        ranges = self.payload_ranges()
        payload_idx = {p: bi for bi, r in enumerate(ranges) for p in r}
        gk = {}
        for pos, (e, _nm) in enumerate(self.group_exprs):
            if not isinstance(e, ColumnExpr):
                return every, []
            gk[pos] = e.index
        # probe key <-> payload equivalences (o_orderkey payload ==
        # l_orderkey probe value on matched rows)
        inner = [(bi, b) for bi, b in enumerate(self.builds)
                 if b.join_type == "INNER"]
        equiv = []
        for bi, b in inner:
            for pk, bk in zip(b.probe_keys, b.build_keys):
                if isinstance(pk, ColumnExpr) and bk.index in b.payload:
                    equiv.append((pk.index,
                                  ranges[bi][b.payload.index(bk.index)]))

        def closure(S):
            S = set(S)
            changed = True
            while changed:
                changed = False
                for a_, b_ in equiv:
                    for x, y in ((a_, b_), (b_, a_)):
                        if x in S and y not in S:
                            S.add(y)
                            changed = True
                for bi, b in inner:
                    if all(isinstance(pk, ColumnExpr) and pk.index in S
                           for pk in b.probe_keys) and \
                            not set(ranges[bi]) <= S:
                        S |= set(ranges[bi])
                        changed = True
            return S

        kept = dict(gk)
        dropped = []
        for pos in sorted(gk, key=lambda p: -gk[p]):
            if gk[pos] not in payload_idx:
                continue            # spine keys stay
            others = {v for k, v in kept.items() if k != pos}
            if not others:
                break               # keep at least one key
            if gk[pos] in closure(others):
                dropped.append(pos)
                kept.pop(pos)
        if not dropped:
            return every, []
        return sorted(kept), sorted(dropped)

    def _fd_finalize(self, kept, dropped, spine_batch, staged):
        """The emit's key hook (`_fd_finalize`, `:1359`): each group's
        representative spine row (the `__rep#x` lane) replays the INNER
        hops on the host (the probe keys evaluated over the row's pair
        space so far, each looked up in the staged table), and the dropped
        group keys are evaluated over the rebuilt pair rows. Only the
        pair-space columns that a probe key or a dropped key reads are
        gathered."""
        from ..physical_optimizer import _collect_cols
        need = set()
        for b in self.builds:
            if b.join_type == "INNER":
                for pk in b.probe_keys:
                    _collect_cols(pk, need)
        for p in dropped:
            _collect_cols(self.group_exprs[p][0], need)

        def take(i, c, idx):
            if i not in need:
                return None
            v = c.validity_host()
            return Column(c.dtype, c.data_host()[idx],
                          None if v is None else v[idx], c.dictionary)

        def finalize(sel, cols, aggs_np):
            rep = aggs_np["__rep#x"][sel].astype(np.int64)
            n = len(rep)
            pair = [take(i, c, rep)
                    for i, c in enumerate(spine_batch.columns)]
            for b, s in zip(self.builds, staged):
                if b.join_type != "INNER":
                    continue
                view = _PairView(pair, n)
                vals = [pk.evaluate(view).data_host().astype(np.int64)
                        for pk in b.probe_keys]
                brow = np.maximum(s.table.find(vals), 0)
                pair += [take(len(pair) + j, s.batch.columns[s.col_map[i]],
                              brow) for j, i in enumerate(b.payload)]
            view = _PairView(pair, n)
            full = [None] * len(self.group_exprs)
            for j, p in enumerate(kept):
                full[p] = cols[j]
            for p in dropped:
                full[p] = self.group_exprs[p][0].evaluate(view)
            return full

        return finalize


def _nullable(prog, cols) -> bool:
    """Whether a row the walk keeps can give `prog` a NULL: it pushes a
    NULL or reads a column with a validity. (A kept row found a build row
    at every INNER hop, so a payload column is NULL only where its build
    column is.)"""
    return any(op == OP_NULL or (op == OP_COL and cols[a][1] is not None)
               for op, a, _b in prog.code)


class TorchJoinChainRowsExec(TorchChainExec):
    """A row-returning join chain on the card: the spine's rows that
    survive the probe predicate, every hop and the residual, as one batch
    of device-born output columns per spine batch that keeps any row.

    Counterpart of `DeviceJoinChainRowsExec` (`device_join_chain.py:
    2142-2397`). Builds stage as the aggregate chain's do
    (`stage_builds`); each spine batch is one `chain_rows` call (the mark
    pass with its scan, one read of the row count, the emit). A dictionary-coded
    output column takes the dictionary of the pair-space column it reads
    (`:2386-2390`): a build column's, for a payload. A shape the lowering
    does not cover raises DeviceLoweringUnsupported, which runs the host
    plan (`fallback`) and adds one to `fallbacks`; a kernel or build
    failure raises."""

    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr],
                 out_exprs: List[PhysicalExpr], schema,
                 fallback: ExecutionPlan, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None):
        super().__init__(probe_source, probe_predicate, builds, predicate,
                         schema, fallback, device, cache)
        self.out_exprs = out_exprs

    def with_children(self, c):
        return TorchJoinChainRowsExec(
            c[0], self.probe_predicate, self._builds_over(c[1:]),
            self.predicate, self.out_exprs, self._schema, self.fallback,
            self.device, self.cache)

    def display_line(self):
        out = ", ".join(str(e) for e in self.out_exprs)
        return (f"TorchJoinChainRowsExec: {self.chain_display()}, "
                f"out=[{out}], device={self.device}")

    def _deferred_expr_roots(self):
        return super()._deferred_expr_roots() + list(self.out_exprs)

    def execute(self, partition: int, ctx: TaskContext):
        self._attach_deferred_ctx(ctx)
        try:
            outs = self._execute_device(partition, ctx)
        except DeviceLoweringUnsupported:
            yield from self.fallback.execute(partition, ctx)
            return
        yield from outs

    def lower_rows(self):
        """(pools, probe predicate, residual, outputs, probe keys of each
        build, min/max test of each build): every pair-space program of
        the walk on one pool (`:2226-2252`)."""
        self.check_builds()
        if not self.out_exprs:
            raise LoweringError("a row-returning chain with no output")
        pools = Pools()
        ppred = compile_expr(self.probe_predicate, pools) \
            if self.probe_predicate is not None else None
        pred = compile_expr(self.predicate, pools) \
            if self.predicate is not None else None
        outs = []
        for e in self.out_exprs:
            if e.out_type.is_string and not isinstance(e, ColumnExpr):
                raise LoweringError("computed string output on device")
            prog = compile_expr(e, pools)
            if prog.out_dtype != e.out_type.device_dtype():
                raise LoweringError(f"output {e} computed as "
                                    f"{prog.out_dtype}")
            outs.append(prog)
        probe_keys = [[compile_expr(k, pools) for k in b.probe_keys]
                      for b in self.builds]
        return pools, ppred, pred, outs, probe_keys, \
            self.lower_mfilters(pools)

    def prepare_rows(self, ctx: TaskContext, compose: bool = True):
        """Everything a run needs before the walk: the builds staged on the
        card (composed and folded unless `compose` is false), the walk's
        spec, and each spine batch's staged columns. Returns (spec, [(cols,
        aux, rows, pair view) per spine batch], staged builds)."""
        with record_function("dft.compile"):
            try:
                (pools, ppred, pred, outs, probe_keys,
                 mfilters) = self.lower_rows()
            except LoweringError as e:
                raise DeviceLoweringUnsupported(str(e))
        with record_function("dft.build"):
            staged = self.stage_builds(ctx, compose)
        spine = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        try:
            spec = ChainRowsSpec(pools, pred, outs,
                                 self.chain(ppred, staged, probe_keys,
                                            mfilters, pools, [pred] + outs))
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        keep_spine = self._source_is_scan()
        inputs = []
        for b in spine:
            view = self.pair_view(b, staged)
            cols, aux = self.stage(spec, b, view, staged, keep_spine)
            inputs.append((cols, aux, b.num_rows, view))
        return spec, inputs, staged

    def _execute_port(self, partition: int, ctx: TaskContext):
        m = BaselineMetrics(self.metrics, partition)
        with m.elapsed_compute:
            spec, inputs, staged = self.prepare_rows(ctx)
            batches = []
            for cols, aux, rows, view in inputs:
                with record_function("dft.rows"):
                    res = chain_rows(spec, cols, aux, rows)
                total = res[0][0].shape[0]
                if total == 0:
                    continue
                out_cols = []
                for e, prog, (data, valid) in zip(self.out_exprs,
                                                  spec.outputs, res):
                    dic = view.columns[e.index].dictionary \
                        if e.out_type.is_dict_coded else None
                    out_cols.append(Column(
                        e.out_type, data,
                        valid if _nullable(prog, cols) else None, dic))
                batches.append(Batch(self._schema, out_cols, total))
                m.record_output(total)
            del inputs, staged
        return batches
