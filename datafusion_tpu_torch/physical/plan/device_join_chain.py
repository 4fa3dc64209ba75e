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
build rows, and an INNER hop the reference would stage as a
direct-address table is folded when its span x (1 + its lanes, composed
ones included) is at most 2^24, over the payload columns the walk reads.
Spans and lanes are counted as the reference counts them, so both
packages compose and fold the same hops at every scale; the extremes of
the build columns that the count needs come from the staged tables or
from one fold on the card a chain. A chain's compositions and folds are
staged when its walk is assembled (`chain`), which knows the columns the
walk reads, by one `chain_stage` call: one compose launch and one fold
launch. Tables, composed words and records are built per execution; the
reference's cross-query cache of them (`_CMP_CACHE`) is not ported.

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
the surviving rows' output columns, which leave as device-born columns
(one `Batch` a spine batch that keeps any row). A build side whose columns are
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
                                  Fold, Hop, StageSpec, chain_aggregate,
                                  chain_build, chain_rows, chain_stage,
                                  new_stage_outputs, stub_hop)
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


class _ColumnDtypes:
    """The device dtype of each payload column a fold holds: its type's
    own, as a program reading it would load it."""

    def __init__(self):
        self.dtypes = {}

    def add(self, idx: int, col: Column) -> None:
        """Take column `idx`, unless its type has no device lane (no
        program can read it then)."""
        try:
            d = np.dtype(col.dtype.device_dtype())
        except NotImplementedError:
            return
        if d in _NP_TO_TORCH:
            self.dtypes[idx] = _NP_TO_TORCH[d]

    def column_dtype(self, idx: int) -> torch.dtype:
        return self.dtypes[idx]


def _program_columns(progs) -> set:
    """The pair-space columns the programs `progs` (None skipped) read."""
    return {a for prog in progs if prog is not None
            for op, a, _b in prog.code if op == OP_COL}


def _any_duplicate(vals: List[torch.Tensor]) -> torch.Tensor:
    """Whether two rows hold the same tuple of `vals` (equal-length int64
    tensors), as a bool tensor on their device: the rows sorted by the
    tuple (stable sorts from the last key to the first), then neighbours
    compared."""
    order = None
    for v in reversed(vals):
        key = v if order is None else v[order]
        idx = torch.sort(key, stable=True).indices
        order = idx if order is None else order[idx]
    same = torch.ones(max(len(order) - 1, 0), dtype=torch.bool,
                      device=vals[0].device)
    for v in vals:
        w = v[order]
        same &= w[1:] == w[:-1]
    return same.any()


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
              mfilters, pools: Pools, reads, compose: bool) -> Chain:
        """The walk over the staged builds: one hop a build, with its
        lowered probe keys, its payload's pair-space indices, its min/max
        test, its composition and its fold. With `compose`, the hops are
        composed and folded first (`compose_builds`), a folded hop's records
        holding the payload columns that `reads` (the walk's programs other
        than the chain's own) and the chain's programs read."""
        if compose:
            self.compose_builds(staged, _program_columns(
                list(reads) + [ppred] +
                [mf[1] for mf in mfilters if mf is not None]))
        hops = [Hop(s.table, b.join_type, pk, payload, mf, s.compose, s.fold)
                for b, s, pk, payload, mf in zip(
                    self.builds, staged, probe_keys, self.payload_ranges(),
                    mfilters)]
        return Chain(self.n_spine, ppred, hops)

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
        then, unless `compose` is false, the hops composed and folded
        (`compose_builds`, a fold holding every payload column; a run
        composes and folds in `chain`, which knows what the walk reads). An
        INNER build with a duplicate key, a build of 2^31 rows or more, or
        packed keys wider than 62 bits raise DeviceLoweringUnsupported
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
        as the reference's payload matrix does, composed ones included.
        The extremes the reference reads from the build columns of a
        composed min/max hop and of a hop that may fold come from the
        staged tables or from the card, in one read-back (`_plan_stats`)."""
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
                tag, new = "mmx", 0      # its lanes once the stats are in
            elif inner and pcols:
                tag, new = "inner", 1 + sum(n for n, _i, _f in pcols)
                for p, (_n, key_ok, _f) in zip(ranges[bi], pcols):
                    registry[p] = (owner, key_ok)
            else:
                tag, new = "member", 1
            composed[bi] = (owner, tag)
            lanes[owner] += new
        mmx = [bi for bi, (_o, tag) in composed.items() if tag == "mmx"]
        with record_function("dft.stage.stats"):
            stats = self._plan_stats(staged, mmx, has_matrix - set(composed))
        for bi in mmx:
            lanes[composed[bi][0]] += \
                1 + 2 * self._mmx_lanes(staged[bi], stats.get(bi))
        folded = {}
        for bi, (b, s) in enumerate(zip(self.builds, staged)):
            if bi in composed or bi not in has_matrix:
                continue
            span = self._lut_span(b, s, lanes[bi], stats.get(bi))
            if span is not None:
                folded[bi] = (span, 1 + lanes[bi])
        return composed, folded

    def _plan_stats(self, staged: List[_BuildInput], mmx, folds) -> dict:
        """{build: (key ranges, member range, duplicate)} of what
        `compose_plan` reads of a build's unfiltered rows (`[:n]`, as the
        reference reads them) and the staged table cannot give: the ranges
        of the keys, and the uniqueness of the key tuples, of each build of
        `folds` the reference might stage as a direct-address table
        (`_lut_span`), and the ranges of the keys and the member column of
        each composed min/max build of `mmx` (`_mmx_lanes`). A table whose
        every row is live knows its keys' ranges (and, for an INNER build,
        their uniqueness) already; a filtered one covers only its live
        rows, so the ranges come from the columns. All of it is folded on
        the card and read back together: one synchronisation a chain, none
        when no build needs it."""
        queued, parts = [], {}
        for bi, (b, s) in enumerate(zip(self.builds, staged)):
            n = s.batch.num_rows
            whole = s.table.live == n
            if n == 0:
                continue
            if bi in mmx:
                cols = [] if whole else [s.col_map[k.index]
                                         for k in b.build_keys]
                cols.append(s.col_map[b.sfilter[1].index])
            elif bi in folds and not whole and self._lut_candidate(b, s):
                cols = [s.col_map[k.index] for k in b.build_keys]
            else:
                continue
            vals = [s.cols[c][0][:n].to(torch.int64) for c in cols]
            at = len(queued)
            queued += [x for v in vals for x in (v.min(), v.max())]
            dup = bi not in mmx
            if dup:
                queued.append(_any_duplicate(vals).to(torch.int64))
            parts[bi] = (at, len(cols), dup)
        if not queued:
            return {}
        host = torch.stack(queued).tolist()
        out = {}
        for bi, (at, k, dup) in parts.items():
            ext = [tuple(host[at + 2 * j:at + 2 * j + 2]) for j in range(k)]
            if dup:
                out[bi] = (ext, None, bool(host[at + 2 * k]))
            else:
                out[bi] = (ext[:-1], ext[-1], False)
        return out

    @staticmethod
    def _mmx_lanes(s: _BuildInput, stats) -> int:
        """The int32 lanes the reference gives each of a composed min/max
        hop's min and max (`:858-863`): one when its table is
        direct-address (unfiltered key bits at most 26, `:1245`) and the
        member column fits int32 (`:1211-1215`), else two."""
        if s.batch.num_rows == 0:
            return 2
        ranges, (flo, fhi), _dup = stats
        if s.table.live == s.batch.num_rows:
            ranges = list(zip(s.table.los, s.table.his))
        bits = sum(max(int(np.ceil(np.log2(hi - lo + 2))), 1)
                   for lo, hi in ranges)
        if bits > 26:
            return 2
        fit32 = flo > np.iinfo(np.int32).min + 1 and \
            fhi < np.iinfo(np.int32).max
        return 1 if fit32 else 2

    @staticmethod
    def _lut_candidate(b: ChainBuild, s: _BuildInput) -> bool:
        """Whether the INNER build `b` may be one the reference stages as a
        direct-address table (`_unfiltered_lut`, `:177`), as far as its
        columns' kinds and the filtered table show: unique non-null integer
        keys, not a build the reference stages from device-born columns
        (`_stage_build_device`, `:1069`: 4 MB or more and no predicate),
        at most 2^24 rows (unique keys span at least their rows), and a
        live span that already fits (the unfiltered one is no narrower)."""
        bb = s.batch
        n = bb.num_rows
        keys = [bb.columns[s.col_map[k.index]] for k in b.build_keys]
        if n == 0 or n > (1 << 24) or any(
                c.has_nulls or not c.dtype.is_integer for c in keys):
            return False
        if s.spec.pred is None and bb.nbytes() >= (4 << 20) and all(
                c.device_born and getattr(c, "_host_cache", None) is None
                for c in keys):
            return False
        t = s.table
        if t.live:
            span = 1 << sum(max(int(np.ceil(np.log2(hi - lo + 2))), 1)
                            for lo, hi in zip(t.los, t.his))
            if span > min(1 << 24, 16 * n):
                return False
        return True

    def _lut_span(self, b: ChainBuild, s: _BuildInput, lanes: int,
                  stats) -> Optional[int]:
        """The span of the direct-address table the reference stages for
        the INNER build of `s` (`_unfiltered_lut`, `:177`): 1 << the bits
        of its unfiltered keys' ranges, when they are unique non-null
        integers spanning at most 2^24 and 16 x its rows; and only when the
        fold's budget, span x (1 + `lanes`) <= 2^24, holds. Else None. A
        build whose every row is live (no predicate, no NULL key) has its
        key ranges and uniqueness in its table already; another's come
        from `_plan_stats`."""
        n = s.batch.num_rows
        if not self._lut_candidate(b, s):
            return None
        if s.table.live == n:        # an INNER table has no duplicate
            ext, dup = list(zip(s.table.los, s.table.his)), False
        else:
            ext, _m, dup = stats
        bits = [max(int(np.ceil(np.log2(hi - lo + 2))), 1) for lo, hi in ext]
        span = 1 << sum(bits)
        if span > min(1 << 24, 16 * n) or span * (1 + lanes) > (1 << 24):
            return None
        return None if dup else span

    def stage_spec(self, staged: List[_BuildInput],
                   reads: Optional[set] = None):
        """What `chain_stage` takes to compose and fold the hops
        `compose_plan` picks: (its StageSpec, the pair-space columns its
        programs and folds read, aux), or None when no hop composes or
        folds. The owners' words hold one word a composed hop, three for a
        min/max hop, in chain order; a fold holds the payload columns in
        `reads` and those the probe keys of the hops the walk probes read
        (every payload column with a device lane when `reads` is None)."""
        with record_function("dft.stage.plan"):
            composed, folded = self.compose_plan(staged)
        if not composed and not folded:
            return None
        with record_function("dft.stage.spec"):
            return self._stage_spec(staged, composed, folded, reads)

    def _stage_spec(self, staged: List[_BuildInput], composed, folded,
                    reads: Optional[set]):
        """`stage_spec` past the choice: the hops lowered, the folds' and
        the probe keys' columns on the card."""
        from ..physical_optimizer import _collect_cols
        ranges = self.payload_ranges()
        at, width = {}, {}
        for bi, (owner, tag) in composed.items():
            at[bi] = width.get(owner, 0)
            width[owner] = at[bi] + (3 if tag == "mmx" else 1)
        if reads is not None:
            reads = set(reads)
            for bi, b in enumerate(self.builds):
                if bi not in composed:
                    for k in b.probe_keys:
                        _collect_cols(k, reads)
        pools = Pools()
        hops = []
        try:
            for h, (b, s) in enumerate(zip(self.builds, staged)):
                if h in composed:
                    keys = [compile_expr(k, pools) for k in b.probe_keys]
                    hops.append(Hop(s.table, b.join_type, keys, ranges[h]))
                else:
                    hops.append(stub_hop(ranges[h], s.table.rows))
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))
        chain = Chain(self.n_spine, None, hops)
        folds, cols = [], {}
        for bi, budget in folded.items():
            s = staged[bi]
            dtypes = _ColumnDtypes()
            for p in ranges[bi]:
                if reads is None or p in reads:
                    dtypes.add(p, self._pair_column(staged, p))
            cols.update(self._to_device(
                dtypes, {p: self._pair_column(staged, p)
                         for p in dtypes.dtypes}, s.keep))
            fold = Fold(width.get(bi, 0),
                        [(p, cols[p][1] is not None) for p in dtypes.dtypes],
                        *budget)
            folds.append((bi, s.table, fold))
        spec = StageSpec(pools, chain,
                         {bi: (o, at[bi], tag)
                          for bi, (o, tag) in composed.items()},
                         {o: staged[o].batch.num_rows for o in width}, folds)
        for p in pools.columns:
            cols.update(self._to_device(
                spec, {p: self._pair_column(staged, p)},
                staged[chain.hop_of[p]].keep))
        return spec, cols, torch.zeros(0, dtype=torch.int64,
                                       device=self.device)

    def compose_builds(self, staged: List[_BuildInput],
                       reads: Optional[set] = None) -> None:
        """Compose and fold the hops `compose_plan` picks (`stage_spec`), in
        one `chain_stage` call: one compose launch and one fold launch a
        chain on the card, into outputs that need no zeroing. Spans:
        `dft.stage` the whole, `dft.stage.plan` the choice (with
        `dft.stage.stats`, its fold of build columns and one read-back),
        `dft.stage.spec` the descriptor's hops and columns, and
        `dft.stage.launch` the outputs' allocation, the descriptor's upload
        and the launches."""
        with record_function("dft.stage"):
            made = self.stage_spec(staged, reads)
            if made is None:
                return
            spec, cols, aux = made
            with record_function("dft.stage.launch"):
                words, outs = new_stage_outputs(spec, self.device)
                chain_stage(spec, cols, aux, words, outs)
        for bi, (owner, word, tag) in spec.composed.items():
            staged[bi].compose = Compose(owner, tag, words[owner], word)
        for (bi, _t, fold), (rec, valid) in zip(spec.folds, outs):
            fold.records, fold.valid = rec, valid
            staged[bi].fold = fold

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

    def compile(self, lowered, staged: List[_BuildInput], views,
                compose: bool = True):
        """(spec, pack plan, lane names, slot map) of the chain over the
        staged builds (composed and folded here unless `compose` is false,
        `chain`) and the spine batches' pair views. With one spine
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
                               [p for p, _k in lanes], compose)
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
        spine = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        with record_function("dft.build"):
            staged = self.stage_builds(ctx, compose=False)
        views = [self.pair_view(b, staged) for b in spine]
        with record_function("dft.compile"):
            spec, plan, names, slot_map = self.compile(lowered, staged, views,
                                                       compose)
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
    (`stage_builds`); each spine batch is one `chain_rows` call (the tile
    walk, one read of the row count, the emit). A dictionary-coded
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
            staged = self.stage_builds(ctx, compose=False)
        spine = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        try:
            spec = ChainRowsSpec(pools, pred, outs,
                                 self.chain(ppred, staged, probe_keys,
                                            mfilters, pools, [pred] + outs,
                                            compose))
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
