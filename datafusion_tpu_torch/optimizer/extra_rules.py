"""Logical rules completing the reference's optimizer list
(optimizer/src/optimizer.rs:245-278): PropagateEmptyRelation,
UnwrapCastInComparison, FilterNullJoinKeys, SingleDistinctToGroupBy,
CommonSubexprEliminate.
"""
from __future__ import annotations

from ..common import dt
from ..common.scalar import ScalarValue
from ..expr import expr as E
from ..expr import plan as L
from ..expr.operator import Op


def _is_empty(p) -> bool:
    return isinstance(p, L.EmptyRelation) and not p.produce_one_row


class PropagateEmptyRelation:
    """An empty input annihilates row-preserving operators and the
    row-multiplying side of joins (reference: propagate_empty_relation.rs)."""
    name = "propagate_empty_relation"

    def rewrite(self, plan):
        def fn(node):
            if isinstance(node, (L.Projection, L.Filter, L.Sort, L.Limit,
                                 L.Distinct, L.Window, L.SubqueryAlias)) and \
                    _is_empty(node.inputs[0]):
                return L.EmptyRelation(False, node.schema)
            if isinstance(node, L.Aggregate) and _is_empty(node.input) and \
                    node.group_exprs:
                # grouped aggregate of nothing = no groups; the global
                # (no-group) aggregate still yields one row, keep it
                return L.EmptyRelation(False, node.schema)
            if isinstance(node, (L.Join, L.CrossJoin)):
                jt = getattr(node, "join_type", "INNER")
                le, re = _is_empty(node.left), _is_empty(node.right)
                if isinstance(node, L.CrossJoin) and (le or re):
                    return L.EmptyRelation(False, node.schema)
                if jt == "INNER" and (le or re):
                    return L.EmptyRelation(False, node.schema)
                if jt in ("LEFT", "LEFTSEMI") and le:
                    return L.EmptyRelation(False, node.schema)
                if jt in ("RIGHT", "RIGHTSEMI") and re:
                    return L.EmptyRelation(False, node.schema)
                if jt == "LEFTSEMI" and re:
                    return L.EmptyRelation(False, node.schema)
                if jt == "RIGHTSEMI" and le:
                    return L.EmptyRelation(False, node.schema)
                if jt == "LEFTANTI" and re:
                    return node.left
                if jt == "RIGHTANTI" and le:
                    return node.right
            if isinstance(node, L.Union):
                kept = [i for i in node.inputs if not _is_empty(i)]
                if not kept:
                    return L.EmptyRelation(False, node.schema)
                if len(kept) != len(node.inputs):
                    if len(kept) == 1:
                        return kept[0]
                    return L.Union(kept, node.schema)
            return node
        return plan.transform_up(fn)


# widening-cast unwrap: CAST(col AS wider) <op> literal -> col <op> lit'
_INT_ORDER = {dt.TypeId.INT8: 8, dt.TypeId.INT16: 16, dt.TypeId.INT32: 32,
              dt.TypeId.INT64: 64}


def _int_bounds(t):
    bits = _INT_ORDER.get(t.id)
    if bits is None:
        if t.id == dt.TypeId.UINT8:
            return 0, 255
        if t.id == dt.TypeId.UINT16:
            return 0, 65535
        if t.id == dt.TypeId.UINT32:
            return 0, 4294967295
        return None
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


_SWAP = {Op.LT: Op.GT, Op.GT: Op.LT, Op.LTEQ: Op.GTEQ, Op.GTEQ: Op.LTEQ,
         Op.EQ: Op.EQ, Op.NEQ: Op.NEQ}


class UnwrapCastInComparison:
    """CAST(expr AS wider-int) <op> int-literal becomes expr <op>
    literal-in-narrow-type when the literal fits, so pruning and join key
    analysis see the bare column (reference: unwrap_cast_in_comparison.rs)."""
    name = "unwrap_cast_in_comparison"

    def rewrite(self, plan):
        def make_expr_fn(schema):
            def expr_fn(e):
                if not isinstance(e, E.BinaryExpr) or e.op not in _SWAP:
                    return None
                for left_first in (True, False):
                    cast = e.left if left_first else e.right
                    lit = e.right if left_first else e.left
                    op = e.op if left_first else _SWAP[e.op]
                    if not (isinstance(cast, E.Cast) and
                            isinstance(lit, E.Literal)):
                        continue
                    try:
                        inner_t = cast.expr.data_type(schema)
                    except Exception:  # noqa: BLE001
                        continue
                    b = _int_bounds(inner_t)
                    if b is None or not cast.dtype.is_integer or \
                            not lit.value.dtype.is_integer or \
                            lit.value.value is None:
                        continue
                    v = int(lit.value.value)
                    if not (b[0] <= v <= b[1]):
                        continue
                    new_lit = E.Literal(ScalarValue(inner_t, v))
                    return E.BinaryExpr(cast.expr, op, new_lit)
                return None
            return expr_fn

        def node_fn(node):
            if isinstance(node, L.Filter):
                fn = make_expr_fn(node.input.schema)
                newp = node.predicate.transform_up(fn)
                if newp is not node.predicate:
                    return L.Filter(newp, node.input)
            return node
        return plan.transform_up(node_fn)


class FilterNullJoinKeys:
    """INNER equi-joins (not null_equals_null) never match NULL keys:
    pre-filter them below each side so builds/probes shrink
    (reference: filter_null_join_keys.rs)."""
    name = "filter_null_join_keys"

    def rewrite(self, plan):
        def fn(node):
            if not isinstance(node, L.Join) or node.join_type != "INNER" or \
                    getattr(node, "null_equals_null", False) or not node.on:
                return node
            if getattr(node, "_null_keys_filtered", False):
                return node

            def add_filter(side, keys):
                preds = []
                for k in keys:
                    try:
                        if not k.nullable(side.schema):
                            continue
                    except Exception:  # noqa: BLE001
                        continue
                    preds.append(E.Not(E.IsNull(k)))
                if not preds:
                    return side
                p = preds[0]
                for q in preds[1:]:
                    p = E.BinaryExpr(p, Op.AND, q)
                return L.Filter(p, side)

            left = add_filter(node.left, [l for l, _ in node.on])
            right = add_filter(node.right, [r for _, r in node.on])
            if left is node.left and right is node.right:
                return node
            out = L.Join(left, right, node.on, node.filter, node.join_type,
                         node.using_columns)
            out._null_keys_filtered = True
            return out
        return plan.transform_up(fn)


class ReplaceDistinctWithAggregate:
    """Plain SELECT DISTINCT becomes GROUP BY over all output columns, so
    the aggregate rules (and the device group-by path) see it
    (reference: replace_distinct_aggregate.rs)."""
    name = "replace_distinct_with_aggregate"

    def rewrite(self, plan):
        def fn(node):
            if not isinstance(node, L.Distinct) or node.on_exprs is not None:
                return node
            groups = [E.Column(f.name, f.qualifier)
                      for f in node.input.schema.fields]
            agg = L.Aggregate(groups, [], node.input)
            try:
                if [f.name for f in agg.schema.fields] != \
                        [f.name for f in node.schema.fields]:
                    return node
            except Exception:  # noqa: BLE001  (ambiguous names: keep Distinct)
                return node
            return agg
        return plan.transform_up(fn)


class EliminateJoin:
    """INNER joins whose residual filter is literally false/null produce
    nothing (reference: eliminate_join.rs)."""
    name = "eliminate_join"

    def rewrite(self, plan):
        def fn(node):
            if isinstance(node, L.Join) and node.join_type == "INNER" and \
                    isinstance(node.filter, E.Literal) and \
                    node.filter.value.value in (False, None):
                return L.EmptyRelation(False, node.schema)
            return node
        return plan.transform_up(fn)


class SingleDistinctToGroupBy:
    """COUNT/SUM/AVG(DISTINCT x) [GROUP BY g] rewrites to a double
    aggregation — inner GROUP BY (g, x), outer GROUP BY g over plain
    aggregates — which the device group-by path can execute
    (reference: single_distinct_to_groupby.rs)."""
    name = "single_distinct_to_group_by"

    def rewrite(self, plan):
        def fn(node):
            if not isinstance(node, L.Aggregate) or node.has_grouping_sets():
                return node
            distinct_args = set()
            for a in node.aggr_exprs:
                f = a.expr if isinstance(a, E.Alias) else a
                if not isinstance(f, E.AggregateFunction):
                    return node
                if f.filter is not None or f.order_by:
                    return node
                if f.distinct:
                    if f.name not in ("count", "sum", "avg", "mean") or \
                            len(f.args) != 1:
                        return node
                    distinct_args.add(str(f.args[0]))
                elif f.name not in ("min", "max"):
                    # mixing DISTINCT with other non-distinct-insensitive
                    # aggregates stays on the general path
                    return node
            if len(distinct_args) != 1:
                return node

            # inner: GROUP BY (group keys..., distinct arg)
            darg = next(f.args[0] for a in node.aggr_exprs
                        for f in [a.expr if isinstance(a, E.Alias) else a]
                        if f.distinct)
            alias = "__distinct_arg"
            inner_groups = list(node.group_exprs) + [E.Alias(darg, alias)]
            inner = L.Aggregate(inner_groups, [], node.input)
            in_schema = inner.schema
            dcol = E.Column(alias, None)

            outer_groups = []
            for g in node.group_exprs:
                if isinstance(g, E.Column):
                    name, qual = g.name, g.qualifier
                elif isinstance(g, E.Alias):
                    name, qual = g.name, None
                else:
                    name, qual = g.display_name(), None
                f = in_schema.field_by_name(name, qual)
                outer_groups.append(E.Column(f.name, f.qualifier))
            outer_aggs = []
            for a in node.aggr_exprs:
                f = a.expr if isinstance(a, E.Alias) else a
                out_name = a.name if isinstance(a, E.Alias) else \
                    a.display_name()
                if f.distinct:
                    inner_fn = E.AggregateFunction(f.name, (dcol,), False)
                else:   # min/max are distinct-insensitive: re-aggregate
                    arg = E.Column(f.args[0].display_name(), None) \
                        if f.args else dcol
                    # min/max over the inner group keys: the arg must be a
                    # group key of the inner aggregate
                    name = f.args[0].display_name()
                    try:
                        fld = in_schema.field_by_name(name)
                    except Exception:  # noqa: BLE001
                        return node
                    inner_fn = E.AggregateFunction(
                        f.name, (E.Column(fld.name, fld.qualifier),), False)
                outer_aggs.append(E.Alias(inner_fn, out_name))
            return L.Aggregate(outer_groups, outer_aggs, inner)
        return plan.transform_up(fn)


class CommonSubexprEliminate:
    """Repeated non-trivial expressions inside one Projection evaluate once
    through a lower projection computing __common_expr_K columns
    (reference: common_subexpr_eliminate.rs; the TPC-H Q1 plan shape)."""
    name = "common_subexpr_eliminate"

    def rewrite(self, plan):
        def fn(node):
            if not isinstance(node, L.Projection):
                return node
            if getattr(node, "_cse_done", False):
                return node
            counts = {}

            def short_circuits(e):
                # children of these evaluate conditionally: extracting a
                # subexpression out would force unconditional evaluation
                # (e.g. a guarded divide-by-zero; select.slt issue #8814)
                return isinstance(e, E.Case) or (
                    isinstance(e, E.BinaryExpr) and e.op in (Op.AND, Op.OR))

            def count(e):
                if not isinstance(e, (E.Column, E.Literal, E.Alias,
                                      E.SortExpr, E.ScalarSubquery, E.Exists,
                                      E.InSubquery, E.WindowFunction,
                                      E.AggregateFunction)) and \
                        e.children() and not L._is_volatile(e):
                    key = str(e)
                    counts[key] = counts.get(key, 0) + 1
                if short_circuits(e):
                    return
                for c in e.children():
                    count(c)
            for e in node.exprs:
                count(e)
            shared = {k for k, n in counts.items() if n > 1}
            if not shared:
                return node
            in_schema = node.input.schema
            mapping = {}
            lower = [E.Column(f.name, f.qualifier) for f in in_schema.fields]

            def displace(e):
                if isinstance(e, (E.Alias,)):
                    return E.Alias(displace(e.expr), e.name)
                key = str(e)
                if key in shared:
                    if key not in mapping:
                        cname = f"__common_expr_{len(mapping) + 1}"
                        mapping[key] = cname
                        lower.append(E.Alias(e, cname))
                    return E.Column(mapping[key], None)
                if short_circuits(e):
                    return e
                kids = tuple(displace(c) for c in e.children())
                return e.with_children(kids) if kids != e.children() else e

            new_exprs = [displace(e) for e in node.exprs]
            if not mapping:
                return node
            out = L.Projection(new_exprs, L.Projection(lower, node.input))
            out._cse_done = True
            return out
        return plan.transform_up(fn)
