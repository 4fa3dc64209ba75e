"""Physical optimizer rules of the port.

Reference parity: `datafusion/core/src/physical_optimizer/optimizer.rs:81`.
The host rules are the port's copies of the JAX package's
(`datafusion_tpu/physical/physical_optimizer.py`): `RemoveRedundantSort`
(`:1034`), `RepartitionFileScans` (`:1073`), `UseSymmetricHashJoin`
(`:1109`), `_pipeline_check` (`:1174`), the aggregate input unwrapping
(`_unwrap_chain` `:229`, `_unwrap_side` `:353`) and the join-tree
flattening of the chain fuser (`:454-893`). The device rules are the
port's own, in the reference's order (`default_physical_rules`,
`:1352`): `UseTorchAggregate` in place of `UseDeviceAggregate` (it tries
the count-over-LEFT-join rewrite, then the join-chain fusion, as `:88-100`
does), `UseTorchJoinRows` in place of `UseDeviceJoinRows` (`:985`), the
host rules, then `FuseTopKIntoTorchAggregate` and
`FuseFilterIntoTorchAggregate`, and last `UseTorchSort`, which hands the
session's device to the sorts and windows (the JAX package reads its one
device from module state instead). There is no mesh branch and no fanout-N
join fusion.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import torch

from ..common.column import DeviceColumnCache
from ..device.groupby import MAX_TOPK
from ..device.lower import LoweringError, check_having
from .expressions import ColumnExpr, PhysicalExpr, rewrite_columns
from .plan.aggregate import AggregateExec, AggregateMode
from .plan.base import ExecutionPlan
from .plan.device_aggregate import TorchAggregate, TorchGroupAggregateExec
from .plan.projection import (CoalescePartitionsExec, FilterExec,
                              GlobalLimitExec, ProjectionExec)
from .plan.sort import PartialSortExec, SortExec, SortPreservingMergeExec
from .plan.window import WindowExec

_DEVICE_AGG_NAMES = {"count", "sum", "min", "max", "avg", "mean"}


class UseTorchAggregate:
    """Fuse AggregateExec(Single) with its input into a device exec, under
    the admission checks of `UseDeviceAggregate` (`:42-61`): counts over a
    LEFT join grouped by its left key become a LeftCountZeroFillExec over
    a TorchGroupAggregateExec of the right side (`_try_fuse_left_count`);
    a tree of hash joins under the aggregate becomes a
    TorchJoinChainAggregateExec (`_try_fuse_join_chain`); otherwise the
    Filter / Projection chain fuses into a TorchGroupAggregateExec."""
    name = "use_torch_aggregate"

    def __init__(self, config, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None):
        self.config = config
        self.device = device
        self.cache = cache

    def enabled(self) -> bool:
        if self.config is None:
            return True
        try:
            return bool(self.config.get("datafusion.tpu.device_aggregate"))
        except Exception:  # noqa: BLE001
            return True

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        if not self.enabled():
            return plan

        def f(node):
            if not isinstance(node, AggregateExec) or \
                    node.mode != AggregateMode.SINGLE:
                return node
            for a in node.aggr_exprs:
                if a.name not in _DEVICE_AGG_NAMES or a.filter is not None:
                    return node
                if a.distinct and not (a.name == "count" and a.args):
                    return node
                if a.name in ("min", "max") and a.out_type.is_string:
                    return node
            unwrapped = _unwrap_chain(node)
            if unwrapped is None:
                return node
            source, predicate, groups, aggs = unwrapped
            fused = _try_fuse_left_count(node, source, predicate, groups,
                                         aggs, self.device, self.cache)
            if fused is not None:
                return fused
            fused = _try_fuse_join_chain(node, source, predicate, groups,
                                         aggs, self.device, self.cache)
            if fused is not None:
                return fused
            return TorchGroupAggregateExec(
                source, predicate, groups, aggs, node.schema(),
                fallback=node, device=self.device, cache=self.cache)
        return plan.transform_up(f)


def _try_fuse_left_count(agg_node, source, predicate, groups, aggs,
                         device: torch.device,
                         cache: Optional[DeviceColumnCache] = None):
    """The count-over-LEFT-join rewrite (TPC-H Q13; `:104-184`): an
    aggregate that groups a LEFT equi join by its left key and only counts
    non-null right columns gets nothing from the join but a zero row for
    each unmatched left key. So the count runs as a device aggregate of
    the right side grouped by its join key, and LeftCountZeroFillExec
    fills in the unmatched left keys with 0. None when the shape differs."""
    from .plan.aggregate import LeftCountZeroFillExec, PhysAggregateExpr
    from .plan.joins import HashJoinExec

    j = source
    if not isinstance(j, HashJoinExec) or j.join_type != "LEFT" or \
            predicate is not None or len(j.on) != 1 or len(groups) != 1:
        return None
    lk, rk = j.on[0]
    if not isinstance(lk, ColumnExpr) or not isinstance(rk, ColumnExpr) \
            or not lk.out_type.is_integer or not rk.out_type.is_integer:
        return None
    n_left = len(j.left.schema())
    g0, gname = groups[0]
    if not isinstance(g0, ColumnExpr) or g0.index != lk.index:
        return None
    for a in aggs:
        if a.name != "count" or a.distinct or a.filter is not None or \
                a.count_star or len(a.args) != 1:
            return None
        arg = a.args[0]
        if not isinstance(arg, ColumnExpr) or arg.index < n_left:
            return None
    right_schema = j.right.schema()

    def rebase(e):
        return ColumnExpr(e.index - n_left,
                          right_schema.field(e.index - n_left).name,
                          e.out_type)

    # rk indexes the right schema already (join `on` pairs are per side)
    groups_r = [(ColumnExpr(rk.index, rk.name, rk.out_type), gname)]
    aggs_r = [PhysAggregateExpr(a.name, [rebase(a.args[0])], a.out_type,
                                a.display, distinct=False, filter=None,
                                count_star=False)
              for a in aggs]
    pred_r = None
    if j.filter is not None:
        refs = set()
        _collect_cols(j.filter, refs)
        if any(r < n_left for r in refs):
            return None   # the filter reads left columns
        repl = [None] * n_left + [ColumnExpr(i, f.name, f.dtype)
                                  for i, f in enumerate(right_schema)]
        try:
            pred_r = rewrite_columns(j.filter, repl)
        except Exception:  # noqa: BLE001
            return None
    host_src = FilterExec(pred_r, j.right) if pred_r is not None \
        else j.right
    host_agg = AggregateExec(AggregateMode.SINGLE, groups_r, aggs_r,
                             host_src)
    dev = TorchGroupAggregateExec(j.right, pred_r, groups_r, aggs_r,
                                  host_agg.schema(), fallback=host_agg,
                                  device=device, cache=cache)
    return LeftCountZeroFillExec(dev, j.left, lk, agg_node.schema())


def _unwrap_chain(agg: AggregateExec):
    """Descend through CoalescePartitions/Filter/Projection, inlining
    projections into the aggregate's expressions; returns
    (source, fused predicate, groups, aggs) against the source schema."""
    from .plan.aggregate import PhysAggregateExpr
    from ..expr.operator import Op
    from .expressions import BinaryPhysExpr
    from ..common import dt

    groups = [(e, n) for e, n in agg.group_exprs]
    aggs = list(agg.aggr_exprs)
    predicate: Optional[PhysicalExpr] = None
    node = agg.input
    hops = 0
    try:
        while hops < 32:
            hops += 1
            if isinstance(node, CoalescePartitionsExec):
                node = node.input
                continue
            if isinstance(node, FilterExec):
                p = node.predicate
                predicate = p if predicate is None else \
                    BinaryPhysExpr(predicate, Op.AND, p, dt.BOOL)
                node = node.input
                continue
            if isinstance(node, ProjectionExec):
                repl = node.exprs
                groups = [(rewrite_columns(e, repl), n) for e, n in groups]
                aggs = [PhysAggregateExpr(
                    a.name, [rewrite_columns(x, repl) for x in a.args],
                    a.out_type, a.display, a.distinct,
                    rewrite_columns(a.filter, repl) if a.filter is not None else None,
                    a.count_star) for a in aggs]
                if predicate is not None:
                    predicate = rewrite_columns(predicate, repl)
                node = node.input
                continue
            scal = _one_row_join_side(node)
            if scal is not None:
                # NLJ/cross join against a guaranteed-1-row subplan
                # (uncorrelated scalar subquery): its columns become
                # DeferredScalarExpr inputs and the descent continues
                # through the kept side (Q22's avg(c_acctbal) shape)
                kept, repl, jfilter = scal
                groups = [(rewrite_columns(e, repl), n) for e, n in groups]
                aggs = [PhysAggregateExpr(
                    a.name, [rewrite_columns(x, repl) for x in a.args],
                    a.out_type, a.display, a.distinct,
                    rewrite_columns(a.filter, repl) if a.filter is not None else None,
                    a.count_star) for a in aggs]
                if predicate is not None:
                    predicate = rewrite_columns(predicate, repl)
                if jfilter is not None:
                    jf = rewrite_columns(jfilter, repl)
                    predicate = jf if predicate is None else \
                        BinaryPhysExpr(predicate, Op.AND, jf, dt.BOOL)
                node = kept
                continue
            break
    except Exception:  # noqa: BLE001 — unsupported expr shape: keep host plan
        return None
    return node, predicate, groups, aggs


def _is_one_row_plan(n):
    """True when `n` provably yields exactly one row: a no-grouping
    aggregate, through Projection/Coalesce wrappers."""
    hops = 0
    while hops < 16:
        hops += 1
        if isinstance(n, (ProjectionExec, CoalescePartitionsExec)):
            n = n.input
            continue
        break
    if isinstance(n, TorchAggregate):
        return not n.group_exprs
    if isinstance(n, AggregateExec):
        return not n.group_exprs
    return False


def _one_row_join_side(node):
    """When `node` is an inner NLJ / cross join whose one side is a
    guaranteed-1-row subplan, return (kept_child, repl, filter) where
    `repl` maps node-output columns to kept-side columns /
    DeferredScalarExpr over the 1-row subplan; None otherwise."""
    from .expressions import ColumnExpr, DeferredScalarExpr, LiteralExpr
    from .plan.joins import CrossJoinExec, NestedLoopJoinExec
    if isinstance(node, NestedLoopJoinExec):
        if node.join_type != "INNER":
            return None
        jfilter = node.filter
        if isinstance(jfilter, LiteralExpr) and jfilter.value.value is True:
            jfilter = None
    elif isinstance(node, CrossJoinExec):
        jfilter = None
    else:
        return None
    left, right = node.left, node.right
    nl = len(left.schema())
    for scalar_side, kept, scalar_first in ((right, left, False),
                                            (left, right, True)):
        if not _is_one_row_plan(scalar_side):
            continue
        repl = []
        ks = kept.schema()
        ss = scalar_side.schema()
        if scalar_first:
            repl += [DeferredScalarExpr(scalar_side, i, f.dtype)
                     for i, f in enumerate(ss)]
            repl += [ColumnExpr(i, f.name, f.dtype)
                     for i, f in enumerate(ks)]
        else:
            repl += [ColumnExpr(i, f.name, f.dtype)
                     for i, f in enumerate(ks)]
            repl += [DeferredScalarExpr(scalar_side, i, f.dtype)
                     for i, f in enumerate(ss)]
        return kept, repl, jfilter
    return None


def _unwrap_side(node):
    """Descend a join child through Filter/Projection/Coalesce to its
    source. Returns (source, side_predicate, output_exprs) where
    output_exprs express the child's OUTPUT columns over the SOURCE schema,
    or None when the chain contains anything else."""
    from ..expr.operator import Op
    from .expressions import BinaryPhysExpr, ColumnExpr
    from ..common import dt

    out_schema = node.schema()
    exprs: List[PhysicalExpr] = [
        ColumnExpr(i, f.name, f.dtype) for i, f in enumerate(out_schema)]
    predicate = None
    hops = 0
    while hops < 32:
        hops += 1
        if isinstance(node, CoalescePartitionsExec):
            node = node.input
            continue
        if isinstance(node, FilterExec):
            p = node.predicate
            predicate = p if predicate is None else \
                BinaryPhysExpr(predicate, Op.AND, p, dt.BOOL)
            node = node.input
            continue
        if isinstance(node, ProjectionExec):
            repl = node.exprs
            try:
                exprs = [rewrite_columns(e, repl) for e in exprs]
                if predicate is not None:
                    predicate = rewrite_columns(predicate, repl)
            except Exception:  # noqa: BLE001
                return None
            node = node.input
            continue
        break
    if node.children():
        return None   # not a leaf source
    return node, predicate, exprs


class _Bail(Exception):
    pass


def _reaches_join(n):
    """True when `n` (through Filter/Projection/Coalesce wrappers) is a
    plain INNER/SEMI/ANTI HashJoinExec — the flattening descends only
    towards joins; anything else is a host-executable leaf subtree."""
    from .plan.joins import HashJoinExec
    while isinstance(n, (FilterExec, ProjectionExec,
                         CoalescePartitionsExec)):
        n = n.input
    return type(n) is HashJoinExec and n.join_type in (
        "INNER", "LEFTSEMI", "LEFTANTI", "RIGHTSEMI", "RIGHTANTI") and \
        not n.null_equals_null


def _flatten_join_tree(node):
    """Flatten a tree of hash joins into its relational algebra parts:
    (leaves, gfields, out_exprs, equis, residuals, semis) where the
    *global* column space is the concatenation of leaf OUTPUT schemas.
    `out_exprs` express `node`'s output columns over that space; `equis`
    are (ColumnExpr, ColumnExpr) global equality pairs; `residuals` are
    global boolean exprs; `semis` are (left_keys_global, right_plan,
    right_key_cols, anti). Raises _Bail on unsupported shapes.
    Reference: the tree EnforceDistribution/JoinSelection reason over
    (enforce_distribution.rs:1037, join_selection.rs:314)."""
    from .expressions import ColumnExpr
    from .plan.joins import HashJoinExec

    if not _reaches_join(node):
        fields = list(node.schema())
        out = [ColumnExpr(i, f.name, f.dtype) for i, f in enumerate(fields)]
        return [node], fields, out, [], [], []
    if isinstance(node, CoalescePartitionsExec):
        return _flatten_join_tree(node.input)
    if isinstance(node, FilterExec):
        leaves, gf, out, eq, res, sem = _flatten_join_tree(node.input)
        res = res + [rewrite_columns(node.predicate, out)]
        return leaves, gf, out, eq, res, sem
    if isinstance(node, ProjectionExec):
        leaves, gf, out, eq, res, sem = _flatten_join_tree(node.input)
        out2 = [rewrite_columns(e, out) for e in node.exprs]
        return leaves, gf, out2, eq, res, sem
    assert type(node) is HashJoinExec
    if node.join_type in ("LEFTSEMI", "LEFTANTI", "RIGHTSEMI", "RIGHTANTI"):
        keep_left = node.join_type in ("LEFTSEMI", "LEFTANTI")
        sfilter_raw = None
        if node.filter is not None:
            # a single comparison `member_col OP kept_expr` stays a
            # membership test over per-key min/max of member_col
            # (hash_join.rs apply_join_filter analog); anything else bails
            sfilter_raw = _decompose_semi_filter(
                node.filter, len(node.left.schema()), keep_left)
            if sfilter_raw is None:
                raise _Bail()
        kept = node.left if keep_left else node.right
        other = node.right if keep_left else node.left
        leaves, gf, out, eq, res, sem = _flatten_join_tree(kept)
        kept_keys = [rewrite_columns(l if keep_left else r, out)
                     for l, r in node.on]
        other_keys = [(r if keep_left else l) for l, r in node.on]
        if not all(isinstance(k, ColumnExpr)
                   for k in kept_keys + other_keys):
            raise _Bail()
        sfilter = None
        if sfilter_raw is not None:
            op, ocol, kexpr = sfilter_raw
            sfilter = (op, ocol, rewrite_columns(kexpr, out))
        sem = sem + [(kept_keys, other, other_keys,
                      node.join_type.endswith("ANTI"), sfilter)]
        return leaves, gf, out, eq, res, sem
    if node.join_type != "INNER":
        raise _Bail()
    ll, lgf, lout, leq, lres, lsem = _flatten_join_tree(node.left)
    rl, rgf, rout, req, rres, rsem = _flatten_join_tree(node.right)
    lw = len(lgf)
    shift_repl = [ColumnExpr(lw + i, f.name, f.dtype)
                  for i, f in enumerate(rgf)]

    def sh(e):
        return rewrite_columns(e, shift_repl)

    out = lout + [sh(e) for e in rout]
    on_pairs = []
    for l, r in node.on:
        a = rewrite_columns(l, lout)
        b = sh(rewrite_columns(r, rout))
        if not (isinstance(a, ColumnExpr) and isinstance(b, ColumnExpr)):
            raise _Bail()
        on_pairs.append((a, b))
    equis = leq + [(sh(a), sh(b)) for a, b in req] + on_pairs
    residuals = lres + [sh(e) for e in rres]
    if node.filter is not None:
        residuals.append(rewrite_columns(node.filter, out))
    semis = lsem + [
        ([sh(k) for k in ks], p, rk, anti,
         None if sf is None else (sf[0], sf[1], sh(sf[2])))
        for ks, p, rk, anti, sf in rsem]
    return ll + rl, lgf + rgf, out, equis, residuals, semis


def _decompose_semi_filter(f, n_left: int, keep_left: bool):
    """Decompose a semi/anti join filter into (op, member_col_local,
    kept_expr) when it is ONE comparison between a pure member-side
    column and an expression purely over the kept side; None otherwise.
    The filter is compiled against the left++right pair schema."""
    from ..expr.operator import Op
    from .expressions import BinaryPhysExpr, ColumnExpr
    if not isinstance(f, BinaryPhysExpr) or f.op not in (
            Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
        return None

    def side(e):
        refs = set()
        _collect_cols(e, refs)
        if not refs:
            return None
        if all(r < n_left for r in refs):
            return "left"
        if all(r >= n_left for r in refs):
            return "right"
        return None

    if not keep_left:
        return None   # RIGHT semi/anti with filter: host plan handles it
    flip = {Op.NEQ: Op.NEQ, Op.LT: Op.GT, Op.GT: Op.LT,
            Op.LTEQ: Op.GTEQ, Op.GTEQ: Op.LTEQ}
    for a, b, op in ((f.left, f.right, f.op),
                     (f.right, f.left, flip[f.op])):
        if isinstance(a, ColumnExpr) and side(a) == "right" and \
                side(b) == "left":
            ocol = ColumnExpr(a.index - n_left, a.name, a.out_type)
            return op, ocol, b
    return None


def _leaf_rows(node, filter_sel=0.2):
    """Physical-level row estimate for spine/build ordering (reference:
    join_selection.rs uses Statistics; filters damp by the default 20%)."""
    sel = 1.0
    hops = 0
    while hops < 32:
        hops += 1
        if isinstance(node, (ProjectionExec, CoalescePartitionsExec)):
            node = node.input
            continue
        if isinstance(node, FilterExec):
            sel *= filter_sel
            node = node.input
            continue
        break
    t = getattr(node, "table", None)
    if t is not None:
        try:
            rows = t.statistics().num_rows.get()
            if rows is not None:
                return max(rows * sel, 1.0)
        except Exception:  # noqa: BLE001
            pass
        parts = getattr(t, "partitions", None)
        if parts is not None:
            return max(sum(b.num_rows for p in parts for b in p) * sel, 1.0)
    return None


def _collect_cols(e, into):
    from .expressions import ColumnExpr
    if isinstance(e, ColumnExpr):
        into.add(e.index)
    for c in e.children():
        _collect_cols(c, into)


def _flatten_and_order(source, min_spine_rows=0):
    """Shared front half of the join-tree fusers: flatten the tree,
    pick the spine, and derive the chain order over the equi graph.
    Returns a dict of parts, or None when the shape is unsupported or
    the spine is smaller than ``min_spine_rows``."""
    from .expressions import ColumnExpr
    try:
        leaves, gfields, out, equis, residuals, semis = \
            _flatten_join_tree(source)
    except (_Bail, Exception):  # noqa: BLE001
        return None
    n_inner = len(leaves) - 1
    if n_inner + len(semis) < 1:
        return None   # no join at all
    if n_inner >= 1 and not equis:
        return None   # disconnected inner graph: host plan handles it

    widths = [len(L.schema()) for L in leaves]
    goffs = []
    off = 0
    for w in widths:
        goffs.append(off)
        off += w
    total_g = off

    def leaf_of(g):
        for i in range(len(leaves) - 1, -1, -1):
            if g >= goffs[i]:
                return i
        return 0

    est = [_leaf_rows(L) for L in leaves]
    # the spine is the FACT table: filters don't change which relation
    # that is, so pick it by UNDAMPED rows (a shipdate-filtered lineitem
    # must still out-rank orders; damped est stays for build ordering)
    raw = [_leaf_rows(L, filter_sel=1.0) for L in leaves]
    spine_i = max(range(len(leaves)),
                  key=lambda i: (raw[i] if raw[i] is not None else -1.0, i))

    spine_un = _unwrap_side(leaves[spine_i])
    if spine_un is None:
        return None
    spine_src, spine_pred, spine_exprs = spine_un

    def _key_unique(leaf_idx, local_idx):
        """True when the build leaf's key column is a verified-unique
        integer column of its underlying table (host check, cached on
        the Column). A chain build with duplicate keys cannot stage on
        device (fanout > 1), so ordering must prefer provably-unique
        keys over row-count heuristics alone (TPC-H Q5: customer must
        join via c_custkey, not c_nationkey)."""
        un = _unwrap_side(leaves[leaf_idx])
        if un is None:
            return False
        src, _pred, exprs = un
        from .expressions import ColumnExpr as CE
        if local_idx >= len(exprs) or not isinstance(exprs[local_idx], CE):
            return False
        src_idx = exprs[local_idx].index
        t = getattr(src, "table", None)
        parts = getattr(t, "partitions", None) if t is not None else None
        if not parts or len(parts) != 1 or len(parts[0]) != 1:
            return False
        proj = getattr(src, "projection", None)
        if proj is not None:
            src_idx = proj[src_idx]
        batch = parts[0][0]
        if src_idx >= len(batch.columns):
            return False
        return batch.columns[src_idx].is_unique_nonnull()

    # ---- chain ordering over the equi graph ---------------------------
    avail = {spine_i}
    remaining = set(range(len(leaves))) - avail
    pending = list(equis)
    order = []          # (leaf index, [(avail expr, build ColumnExpr local)])
    residual_equis = []
    while remaining:
        candidates = {}
        for a, b in pending:
            la, lb = leaf_of(a.index), leaf_of(b.index)
            if la in avail and lb in remaining:
                candidates.setdefault(lb, []).append((a, b))
            elif lb in avail and la in remaining:
                candidates.setdefault(la, []).append((b, a))
        if not candidates:
            return None   # disconnected equi graph: host plan handles it

        def _pick_key(i):
            uniq = any(_key_unique(i, pb.index - goffs[i])
                       for _pa, pb in candidates[i])
            return (0 if uniq else 1,
                    est[i] if est[i] is not None else float("inf"))

        pick = min(candidates, key=_pick_key)
        keys = []
        seen_local = set()
        # when a provably-unique key equality exists, key the build on it
        # ALONE and demote the other equalities to residual masks: a
        # single-column unique key keeps the hop composable at staging
        # time (probe key from one parent) where a composite would not
        cands = candidates[pick]
        uniq_cands = [p for p in cands
                      if _key_unique(pick, p[1].index - goffs[pick])]
        if uniq_cands:
            head = uniq_cands[0]
            for pair in cands:
                if pair is not head:
                    residual_equis.append(pair)
            cands = [head]
        for pa, pb in cands:
            lidx = pb.index - goffs[pick]
            if lidx in seen_local:
                # second equality on the same build column: residual
                residual_equis.append((pa, pb))
                continue
            seen_local.add(lidx)
            keys.append((pa, ColumnExpr(lidx, pb.name, pb.out_type)))
        order.append((pick, keys))
        avail.add(pick)
        remaining.discard(pick)
        consumed = {(id(a), id(b)) for a, b in candidates[pick]}
        still = []
        for a, b in pending:
            if (id(a), id(b)) in consumed or (id(b), id(a)) in consumed:
                continue
            if leaf_of(a.index) in avail and leaf_of(b.index) in avail:
                residual_equis.append((a, b))
            else:
                still.append((a, b))
        pending = still


    if n_inner == 1 and not semis:
        # single INNER joins keep the fanout-capable fused path UNLESS
        # the build key is provably unique (fanout-1): the chain exec's
        # folded-LUT + row-space path is then strictly faster (TPC-H
        # Q12/Q14/Q19-class shapes)
        pick, keys0 = order[0]
        if not any(_key_unique(pick, bk.index) for _pa, bk in keys0):
            return None

    if min_spine_rows and not (est[spine_i] is not None
                               and est[spine_i] >= min_spine_rows):
        return None
    return dict(leaves=leaves, gfields=gfields, out=out, equis=equis,
                residuals=residuals, semis=semis, widths=widths,
                goffs=goffs, total_g=total_g, est=est, spine_i=spine_i,
                spine_src=spine_src, spine_pred=spine_pred,
                spine_exprs=spine_exprs, order=order,
                residual_equis=residual_equis, leaf_of=leaf_of)



def _pair_chain(parts, exprs):
    """The chain of `_flatten_and_order`'s `parts` over the pair space:
    the spine's source columns, then each INNER build's payload columns in
    chain order, a payload being every build column that `exprs` (the
    exec's own global-space expressions: group keys and aggregate
    arguments, or outputs), a residual, a SEMI key or a probe key reads.
    Returns (the builds, the predicate over the pair space that ANDs
    `extra` and the residuals, a rewrite of a global-space expression into
    the pair space). Raises _Bail, or the rewrite's error, where an
    expression does not map."""
    from ..common import dt
    from ..expr.operator import Op
    from .expressions import BinaryPhysExpr
    from .plan.device_join_chain import ChainBuild

    leaves, gfields = parts["leaves"], parts["gfields"]
    widths, goffs, order = parts["widths"], parts["goffs"], parts["order"]
    spine_i, semis = parts["spine_i"], parts["semis"]
    res_exprs = list(parts["residuals"]) + [
        BinaryPhysExpr(a, Op.EQ, b, dt.BOOL)
        for a, b in parts["residual_equis"]]
    needed = set()
    for e in list(exprs) + res_exprs:
        _collect_cols(e, needed)
    for ks, _p, _rk, _anti, sf in semis:
        for k in ks:
            _collect_cols(k, needed)
        if sf is not None:
            _collect_cols(sf[2], needed)
    for _pick, keys in order:
        for pa, _pb in keys:
            _collect_cols(pa, needed)

    repl_global: List[Optional[PhysicalExpr]] = [None] * parts["total_g"]
    for j in range(widths[spine_i]):
        repl_global[goffs[spine_i] + j] = parts["spine_exprs"][j]
    pair_pos = len(parts["spine_src"].schema())
    payloads = {}
    for pick, _keys in order:
        local = sorted(g - goffs[pick] for g in needed
                       if goffs[pick] <= g < goffs[pick] + widths[pick])
        payloads[pick] = local
        for lidx in local:
            f = gfields[goffs[pick] + lidx]
            repl_global[goffs[pick] + lidx] = \
                ColumnExpr(pair_pos, f.name, f.dtype)
            pair_pos += 1

    def to_pair(e):
        refs = set()
        _collect_cols(e, refs)
        if any(repl_global[g] is None for g in refs):
            raise _Bail()    # invariant: `needed` covers every reference
        return rewrite_columns(e, repl_global)

    chain = [ChainBuild(leaves[pick], [to_pair(pa) for pa, _ in keys],
                        [pb for _, pb in keys], payloads[pick], "INNER")
             for pick, keys in order]
    for ks, p, rk, anti, sf in semis:
        chain.append(ChainBuild(
            p, [to_pair(k) for k in ks], rk, [],
            "LEFTANTI" if anti else "LEFTSEMI",
            sfilter=None if sf is None else (sf[0], sf[1], to_pair(sf[2]))))

    def conjoin(extra):
        pred = None
        for e in list(extra) + res_exprs:
            pe = to_pair(e)
            pred = pe if pred is None else \
                BinaryPhysExpr(pred, Op.AND, pe, dt.BOOL)
        return pred
    return chain, conjoin, to_pair


def _try_fuse_join_chain(agg_node, source, predicate, groups, aggs,
                         device: torch.device,
                         cache: Optional[DeviceColumnCache] = None):
    """When the aggregate sits on a tree of >= 2 INNER hash joins (plus
    optional SEMI/ANTI), fuse the whole thing into one
    TorchJoinChainAggregateExec: the largest relation becomes the probe
    spine, every other relation a unique-key build table joined by
    searchsorted, chain order re-derived from the equi-predicate graph
    (join-order repair included — a build is only ever joined through
    keys already available, so many-to-many dimension pairings become
    residual masks instead of materialized intermediates)."""
    from .plan.aggregate import PhysAggregateExpr
    from .plan.device_join_chain import TorchJoinChainAggregateExec

    parts = _flatten_and_order(source)
    if parts is None:
        return None
    out = parts["out"]
    try:
        # everything to the global space, then to the pair space
        groups_g = [(rewrite_columns(e, out), n) for e, n in groups]
        aggs_g = [PhysAggregateExpr(
            a.name, [rewrite_columns(x, out) for x in a.args],
            a.out_type, a.display, a.distinct, None, a.count_star)
            for a in aggs]
        pred_g = [rewrite_columns(predicate, out)] \
            if predicate is not None else []
        chain, conjoin, to_pair = _pair_chain(
            parts, [e for e, _n in groups_g] +
            [x for a in aggs_g for x in a.args] + pred_g)
        final_pred = conjoin(pred_g)
        groups_p = [(to_pair(e), n) for e, n in groups_g]
        aggs_p = [PhysAggregateExpr(
            a.name, [to_pair(x) for x in a.args],
            a.out_type, a.display, a.distinct, None, a.count_star)
            for a in aggs_g]
    except (_Bail, Exception):  # noqa: BLE001
        return None
    return TorchJoinChainAggregateExec(
        parts["spine_src"], parts["spine_pred"], chain, final_pred, groups_p,
        aggs_p, agg_node.schema(), fallback=agg_node, device=device,
        cache=cache)


def _try_fuse_join_rows(node, min_spine_rows: int, device: torch.device,
                        cache: Optional[DeviceColumnCache] = None):
    """A join tree whose output is read as rows (by a sort, a limit, a
    projection or another join; no aggregate above it) as one
    TorchJoinChainRowsExec that returns the surviving rows as device-born
    columns (`_try_fuse_join_rows`, `:894-982`). Only when the spine is
    estimated at `min_spine_rows` rows or more: smaller joins stay on the
    host."""
    from .plan.device_join_chain import TorchJoinChainRowsExec

    parts = _flatten_and_order(node, min_spine_rows=min_spine_rows)
    if parts is None:
        return None
    try:
        chain, conjoin, to_pair = _pair_chain(parts, parts["out"])
        final_pred = conjoin([])
        out_p = [to_pair(e) for e in parts["out"]]
    except (_Bail, Exception):  # noqa: BLE001
        return None
    return TorchJoinChainRowsExec(
        parts["spine_src"], parts["spine_pred"], chain, final_pred, out_p,
        node.schema(), fallback=node, device=device, cache=cache)


class UseTorchJoinRows:
    """Fuse row-returning join trees (no aggregate above them) into
    TorchJoinChainRowsExec (`UseDeviceJoinRows`, `:985-1031`). Runs after
    UseTorchAggregate, so trees under an aggregate are fused already;
    walks top-down so the largest tree fuses whole, then recurses into the
    fused exec's build sources (a SEMI member that is itself a join tree
    gets its own exec: TPC-H Q20)."""
    name = "use_torch_join_rows"

    def __init__(self, config, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None):
        self.config = config
        self.device = device
        self.cache = cache

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        min_rows = int(self.config.get(
            "datafusion.tpu.device_join_rows_min_spine"))

        def walk(node):
            if _reaches_join(node):
                fused = _try_fuse_join_rows(node, min_rows, self.device,
                                            self.cache)
                if fused is not None:
                    node = fused
            kids = node.children()
            if not kids:
                return node
            new_kids = [walk(c) for c in kids]
            if all(a is b for a, b in zip(kids, new_kids)):
                return node
            return node.with_children(new_kids)

        return walk(plan)


class RemoveRedundantSort:
    """EnforceSorting analog (reference: physical_optimizer/
    enforce_sorting.rs): a SortExec whose input already delivers the
    required ordering (per `output_ordering` prefix match) is elided —
    with a `fetch` it degenerates to a limit."""
    name = "remove_redundant_sort"

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        from .plan.sort import PartialSortExec, SortExec

        def f(node):
            if not isinstance(node, SortExec) or isinstance(node, PartialSortExec):
                return node
            child = node.input
            need = [(str(e.expr), e.asc, e.nulls_first)
                    for e in node.sort_exprs]
            # EquivalenceProperties-based satisfaction: constants are
            # trivially ordered, keys compare class-normalized, so
            # `ORDER BY b` over `WHERE a = b` with an a-sorted input (or
            # `WHERE a = 5` with ORDER BY a, b over a b-sorted input)
            # elides (properties.rs ordering_satisfy_requirement)
            eqp = child.equivalence_properties()
            best_k = eqp.satisfied_prefix(need)
            if best_k == len(need):
                if node.fetch is None:
                    return child
                return GlobalLimitExec(child, 0, node.fetch)
            # common prefix: sort only within runs of the already-ordered
            # prefix (reference: enforce_sorting.rs replace_with_partial_sort)
            if 0 < best_k:
                return PartialSortExec(node.sort_exprs, child, best_k,
                                       node.fetch)
            return node
        return plan.transform_up(f)


class RepartitionFileScans:
    """Intra-file scan parallelism: when
    `datafusion.execution.target_partitions` > 1, split parquet scans into
    that many row-group partitions (byte-balanced) and fan them back in
    through the threaded CoalescePartitions, so IO + decode of one large
    file runs on all host cores (reference:
    enforce_distribution.rs + ParquetExec::repartitioned, parquet/mod.rs:629;
    pyarrow decode releases the GIL)."""
    name = "repartition_file_scans"

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        if self.config is None:
            return plan
        try:
            target = int(self.config.get(
                "datafusion.execution.target_partitions"))
        except Exception:  # noqa: BLE001
            return plan
        if target <= 1:
            return plan
        from .plan.file_scan import ParquetScanExec
        from .plan.projection import CoalescePartitionsExec

        def f(node):
            if isinstance(node, ParquetScanExec) \
                    and node._assignments is None:
                r = node.repartitioned(target)
                if r is not None:
                    return CoalescePartitionsExec(r)
            return node
        return plan.transform_up(f)


class UseSymmetricHashJoin:
    """Swap HashJoinExec for the streaming SymmetricHashJoinExec when
    `datafusion.execution.use_symmetric_hash_join` is set (reference
    selects it for unbounded inputs via PipelineChecker; bounded inputs
    execute identically)."""
    name = "use_symmetric_hash_join"

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        if self.config is None:
            return plan
        try:
            if not bool(self.config.get(
                    "datafusion.execution.use_symmetric_hash_join")):
                return plan
        except Exception:  # noqa: BLE001
            return plan
        from .plan.joins import HashJoinExec, SymmetricHashJoinExec

        def f(node):
            if type(node) is HashJoinExec:
                return SymmetricHashJoinExec(
                    node.left, node.right, node.on, node.join_type,
                    node.filter, node.filter_schema, node.partition_mode,
                    node.null_equals_null)
            return node
        return plan.transform_up(f)


def _streamable_group_by(node) -> bool:
    """True when a GROUP BY over an unbounded-but-ordered input can stream:
    some group expression is the ordered leading column or an
    order-preserving (monotonic) function of it — date_bin/date_trunc — so
    groups close as the stream advances (reference: AggregateExec
    input_order_mode Sorted, aggregates/mod.rs + pipeline_checker.rs;
    EXTRACT/date_part is NOT monotonic and stays rejected)."""
    from .expressions import CastExpr, ColumnExpr, ScalarFunctionExpr
    inputs = getattr(node, "children", lambda: [])()
    if not inputs:
        return False
    ordering = inputs[0].output_ordering()
    if not ordering:
        return False
    lead = ordering[0][0]
    monotonic = {"date_bin", "date_trunc"}

    def is_lead(e):
        if str(e) == lead:
            return True
        if isinstance(e, CastExpr):
            return is_lead(e.expr)
        return False

    for item in getattr(node, "group_exprs", []):
        e = item[0] if isinstance(item, tuple) else item
        if is_lead(e):
            return True
        if isinstance(e, ScalarFunctionExpr) and e.name in monotonic:
            if any(is_lead(a) for a in e.args if isinstance(a, ColumnExpr)):
                return True
    return False


def _pipeline_check(plan: ExecutionPlan) -> ExecutionPlan:
    """PipelineChecker (reference: physical_optimizer/
    pipeline_checker.rs:18): reject pipeline-breaking operators over
    unbounded inputs — a full sort, a blocking aggregate, or a hash-join
    build can never finish on an infinite stream. Streaming-capable
    operators (SymmetricHashJoin, BoundedWindowExec,
    filters/limits/projections) pass."""
    from ..common.errors import PlanError
    from .plan.joins import (HashJoinExec, SortMergeJoinExec,
                             SymmetricHashJoinExec)
    from .plan.sort import PartialSortExec, SortExec

    def walk(node):
        for c in node.children():
            walk(c)
        if isinstance(node, (SortExec,)) and not isinstance(
                node, PartialSortExec) and node.input.unbounded():
            # fetch-bounded sort over a Sorted-mode streaming aggregate is
            # allowed: groups close in stream order and the top-k holds
            # only `fetch` rows (reference plans SortPreservingMerge
            # fetch=k over ordering_mode=Sorted AggregateExec here)
            inner = node.input
            while not isinstance(inner, (AggregateExec, TorchAggregate)):
                kids = inner.children()
                if len(kids) != 1:
                    break
                inner = kids[0]
            ok = (node.fetch is not None
                  and isinstance(inner, (AggregateExec, TorchAggregate))
                  and _streamable_group_by(inner))
            if not ok:
                raise PlanError(
                    "Cannot execute pipeline-breaking SortExec on an "
                    "unbounded input")
        if isinstance(node, (AggregateExec, TorchAggregate)) \
                and any(c.unbounded() for c in node.children()) \
                and not _streamable_group_by(node):
            raise PlanError(
                "Cannot execute blocking aggregation on an unbounded input "
                "(group expressions do not preserve the input ordering)")
        if isinstance(node, (HashJoinExec, SortMergeJoinExec)) and \
                not isinstance(node, SymmetricHashJoinExec):
            if node.left.unbounded():
                raise PlanError(
                    "Cannot build a hash table over an unbounded input; "
                    "SET datafusion.execution.use_symmetric_hash_join = true")
    walk(plan)
    return plan


class FuseTopKIntoTorchAggregate:
    """ORDER BY <count aggregate> LIMIT k (k <= 2^16) over a
    TorchGroupAggregateExec: push (aggregate, direction, k) into the exec,
    which selects the k groups on the card (`group_topk`) so only k rows
    reach the host. The port of `FuseTopKIntoDeviceAggregate` (`:1225`),
    with its restrictions: one sort key, a count (never NULL), reached
    through projections of plain columns. The SortExec stays and orders
    the k rows exactly; among groups tied at the k-th count any choice is
    valid SQL."""

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        def f(node):
            if not isinstance(node, SortExec) or node.fetch is None or \
                    node.fetch > MAX_TOPK or len(node.sort_exprs) != 1:
                return node
            se = node.sort_exprs[0]
            if not isinstance(se.expr, ColumnExpr):
                return node
            idx = se.expr.index
            cur = node.input
            while isinstance(cur, (ProjectionExec, CoalescePartitionsExec)):
                if isinstance(cur, ProjectionExec):
                    e = cur.exprs[idx]
                    if not isinstance(e, ColumnExpr):
                        return node
                    idx = e.index
                cur = cur.children()[0]
            if type(cur) is not TorchGroupAggregateExec or \
                    cur.topk is not None:
                return node
            n_keys = len(cur.group_exprs)
            if idx < n_keys or cur.aggs[idx - n_keys].name != "count":
                return node
            fused = TorchGroupAggregateExec(
                cur.source, cur.predicate, cur.group_exprs, cur.aggs,
                cur.schema(), cur.fallback, cur.device, cur.cache,
                cur.max_groups, topk=(idx - n_keys, se.asc, int(node.fetch)))

            def rebuild(n2):
                # descend the original objects so identity survives
                if n2 is cur:
                    return fused
                return n2.with_children([rebuild(c) for c in n2.children()])
            return node.with_children([rebuild(node.input)])
        return plan.transform_up(f)


class FuseFilterIntoTorchAggregate:
    """A FilterExec directly above a grouped TorchGroupAggregateExec (a
    HAVING) moves into the exec: `compact_groups` evaluates it over the
    finalised group table on the card, so only surviving groups reach the
    host. The port of `FuseFilterIntoDeviceAggregate` (`:1283`); its
    fusability check is the port's own lowering (`check_having`), and the
    fallback keeps the FilterExec above the host plan."""

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        def f(node):
            if not isinstance(node, FilterExec):
                return node
            child = node.children()[0]
            if not isinstance(child, TorchGroupAggregateExec) or \
                    child.topk is not None or \
                    child.post_filter is not None or \
                    not child.group_exprs:
                # scalar aggregates emit exactly one row (made up even for
                # empty input): their HAVING runs on the host above
                return node
            try:
                check_having(node.predicate,
                             [e.out_type for e, _ in child.group_exprs],
                             child.aggs)
            except LoweringError:
                return node
            fused = copy.copy(child)
            fused.post_filter = node.predicate
            fused.fallback = FilterExec(node.predicate, child.fallback)
            return fused
        return plan.transform_up(f)


class UseTorchSort:
    """Give every sort and window of the plan (SortExec, PartialSortExec,
    SortPreservingMergeExec, WindowExec and BoundedWindowExec) the
    session's device. Each then sorts there once its input reaches
    `datafusion.tpu.device_sort_min_rows` rows, and evaluates its window
    functions there once it reaches `datafusion.tpu.device_window_min_rows`
    (`plan/sort.py` `lexsort`, `plan/window.py` `_try_device_window`).
    Runs last, so no later rule plans a sort without it."""
    name = "use_torch_sort"

    def __init__(self, device: torch.device):
        self.device = device

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        kinds = (SortExec, PartialSortExec, SortPreservingMergeExec,
                 WindowExec)

        def f(node):
            if isinstance(node, kinds) and node.device != self.device:
                node = copy.copy(node)
                node.device = self.device
            return node
        return plan.transform_up(f)


def optimize_physical(plan: ExecutionPlan, config, device: torch.device,
                      cache: Optional[DeviceColumnCache] = None
                      ) -> ExecutionPlan:
    for rule in (UseTorchAggregate(config, device, cache),
                 UseTorchJoinRows(config, device, cache),
                 RemoveRedundantSort(config), UseSymmetricHashJoin(config),
                 RepartitionFileScans(config),
                 FuseTopKIntoTorchAggregate(config),
                 FuseFilterIntoTorchAggregate(config), UseTorchSort(device)):
        plan = rule.rewrite(plan)
    return _pipeline_check(plan)
