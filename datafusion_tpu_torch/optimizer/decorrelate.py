"""Subquery decorrelation.

Reference parity:
* DecorrelatePredicateSubquery
  (`optimizer/src/decorrelate_predicate_subquery.rs`) — EXISTS / IN
  predicates become LeftSemi / LeftAnti joins; pulled-up correlated
  equalities become join keys, non-equi correlated conjuncts become the
  join filter.
* ScalarSubqueryToJoin (`optimizer/src/scalar_subquery_to_join.rs`) —
  correlated scalar subqueries become LEFT joins against the subquery
  re-grouped by its correlation keys; uncorrelated ones become cross joins
  against the single-row result.

The correlation puller (`optimizer/src/decorrelate.rs` PullUpCorrelatedExpr
analog) walks the subquery, strips conjuncts containing `outer_ref(...)`
out of its Filters — keeping the OuterRef markers intact so outer vs inner
columns stay distinguishable — and threads the referenced *inner* columns
up through Projection / Aggregate / SubqueryAlias nodes so the join can
evaluate the conjunct at the subquery root.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..common.errors import PlanError
from ..expr import expr as E
from ..expr import plan as L
from ..expr.operator import Op
from .predicate_utils import conjunction, split_conjunction

_ALIAS_COUNTER = itertools.count()


def reset_alias_counter():
    """Start subquery alias numbering from 0 for the next statement —
    keeps optimized-plan text deterministic per query (the reference
    numbers __correlated_sq_N per planning session), so EXPLAIN plan
    snapshots don't depend on how many statements ran before."""
    global _ALIAS_COUNTER
    _ALIAS_COUNTER = itertools.count()


def _contains_outer(e: E.Expr) -> bool:
    return e.contains(lambda n: isinstance(n, E.OuterRef))


def _inner_columns(e: E.Expr) -> List[E.Column]:
    """Columns of `e` that belong to the subquery (i.e. not under an
    OuterRef marker)."""
    out: List[E.Column] = []

    def walk(n):
        if isinstance(n, E.OuterRef):
            return
        if isinstance(n, E.Column):
            out.append(n)
        for c in n.children():
            walk(c)
    walk(e)
    return out


def _requalify_inner(e: E.Expr, alias: str) -> E.Expr:
    """Rewrite inner columns to the subquery alias; unwrap OuterRefs to the
    outer plan's columns."""
    def rw(n):
        if isinstance(n, E.OuterRef):
            return n.column
        if isinstance(n, E.Column):
            return E.Column(n.name, alias)
        return n
    return e.transform_up(rw)


def _pull_correlations(node: L.LogicalPlan) -> Tuple[L.LogicalPlan, List[E.Expr]]:
    """Remove correlated conjuncts (still containing OuterRef markers) from
    Filters inside `node`, threading their inner columns to the output."""
    if isinstance(node, L.Filter):
        child, pulled = _pull_correlations(node.input)
        keep: List[E.Expr] = []
        for c in split_conjunction(node.predicate):
            if _contains_outer(c):
                pulled = pulled + [c]
            else:
                keep.append(c)
        pred = conjunction(keep)
        new = L.Filter(pred, child) if pred is not None else child
        return new, pulled

    if isinstance(node, L.Projection):
        child, pulled = _pull_correlations(node.input)
        if not pulled:
            return (node if child is node.input
                    else L.Projection(node.exprs, child)), pulled
        exprs = list(node.exprs)
        names = {f.name for f in node.schema.fields}
        for c in pulled:
            for col in _inner_columns(c):
                if col.name not in names:
                    exprs.append(col)
                    names.add(col.name)
        return L.Projection(exprs, child), pulled

    if isinstance(node, L.Aggregate):
        child, pulled = _pull_correlations(node.input)
        if not pulled:
            return (node if child is node.input
                    else node.with_inputs([child])), pulled
        groups = list(node.group_exprs)
        existing = {str(g) for g in groups}
        for c in pulled:
            for col in _inner_columns(c):
                if str(col) not in existing:
                    groups.append(col)
                    existing.add(str(col))
        return L.Aggregate(groups, node.aggr_exprs, child), pulled

    if isinstance(node, L.SubqueryAlias):
        child, pulled = _pull_correlations(node.input)
        if pulled:
            # requalify inner refs to this alias so they resolve above it
            def requal(c):
                def rw(n):
                    if isinstance(n, E.OuterRef):
                        return n
                    if isinstance(n, E.Column):
                        return E.Column(n.name, node.alias)
                    return n
                return _map_skipping_outer(c, rw)
            pulled = [requal(c) for c in pulled]
        return (node if child is node.input
                else L.SubqueryAlias(child, node.alias)), pulled

    if isinstance(node, (L.Sort, L.Limit, L.Distinct)):
        child, pulled = _pull_correlations(node.inputs[0])
        return (node if child is node.inputs[0]
                else node.with_inputs([child])), pulled

    if isinstance(node, (L.Join, L.CrossJoin)):
        new_inputs, all_pulled = [], []
        for i in node.inputs:
            c, p = _pull_correlations(i)
            new_inputs.append(c)
            all_pulled.extend(p)
        changed = any(a is not b for a, b in zip(new_inputs, node.inputs))
        node2 = node.with_inputs(new_inputs) if changed else node
        # correlated conjuncts inside an INNER join's own ON / filter pull
        # straight above the join (the join outputs all child columns, so
        # no threading is needed at this level)
        if isinstance(node2, L.Join) and node2.join_type == "INNER":
            keep_on, on_changed = [], False
            for l, r in node2.on:
                if _contains_outer(l) or _contains_outer(r):
                    all_pulled.append(E.BinaryExpr(l, Op.EQ, r))
                    on_changed = True
                else:
                    keep_on.append((l, r))
            keep_f, f_changed = [], False
            if node2.filter is not None:
                for c in split_conjunction(node2.filter):
                    if _contains_outer(c):
                        all_pulled.append(c)
                        f_changed = True
                    else:
                        keep_f.append(c)
            if on_changed or f_changed:
                if not keep_on:
                    node2 = L.CrossJoin(node2.left, node2.right)
                    kf = conjunction(keep_f)
                    if kf is not None:
                        node2 = L.Filter(kf, node2)
                else:
                    node2 = L.Join(node2.left, node2.right, keep_on,
                                   conjunction(keep_f), "INNER",
                                   node2.using_columns)
        return node2, all_pulled

    if _plan_has_outer(node):
        raise PlanError(
            f"correlated reference under unsupported node "
            f"{type(node).__name__}")
    return node, []


def _map_skipping_outer(e: E.Expr, rw):
    """transform_up that does not descend into OuterRef subtrees."""
    if isinstance(e, E.OuterRef):
        return rw(e)
    children = e.children()
    if children:
        new_children = [_map_skipping_outer(c, rw) for c in children]
        if any(a is not b for a, b in zip(new_children, children)):
            e = e.with_children(new_children)
    return rw(e)


def _plan_has_outer(node: L.LogicalPlan) -> bool:
    for e in node.expressions():
        if _contains_outer(e):
            return True
    return any(_plan_has_outer(c) for c in node.inputs)


def _split_join_conditions(pulled: List[E.Expr], alias: str):
    """Pulled conjuncts -> (on pairs, residual filter exprs), both rewritten
    to reference the outer plan directly and the subquery via `alias`."""
    on: List[Tuple[E.Expr, E.Expr]] = []
    residual: List[E.Expr] = []
    for c in pulled:
        done = False
        if isinstance(c, E.BinaryExpr) and c.op == Op.EQ:
            a, b = c.left, c.right
            a_out, b_out = _contains_outer(a), _contains_outer(b)
            if a_out != b_out:
                outer_side, inner_side = (a, b) if a_out else (b, a)
                pure_outer = not _inner_columns(outer_side)
                if pure_outer and isinstance(inner_side, E.Column):
                    on.append((_requalify_inner(outer_side, alias),
                               E.Column(inner_side.name, alias)))
                    done = True
        if not done:
            residual.append(_requalify_inner(c, alias))
    return on, residual


# --------------------------------------------------------------------------
# EXISTS / IN -> semi/anti join
# --------------------------------------------------------------------------

class DecorrelatePredicateSubquery:
    name = "decorrelate_predicate_subquery"

    def rewrite(self, plan):
        def f(node):
            if not isinstance(node, L.Filter):
                return node
            conjuncts = split_conjunction(node.predicate)
            current = node.input
            keep: List[E.Expr] = []
            changed = False
            for c in conjuncts:
                neg = False
                inner = c
                if isinstance(inner, E.Not):
                    inner, neg = inner.expr, True
                if isinstance(inner, E.Exists):
                    current = self._to_join(current, inner.subquery, [],
                                            neg != inner.negated)
                    changed = True
                elif isinstance(inner, E.InSubquery):
                    current = self._to_join(current, inner.subquery,
                                            [inner.expr],
                                            neg != inner.negated)
                    changed = True
                else:
                    keep.append(c)
            if not changed:
                return node
            pred = conjunction(keep)
            return L.Filter(pred, current) if pred is not None else current
        return plan.transform_up(f)

    def _to_join(self, outer: L.LogicalPlan, sub: L.LogicalPlan,
                 in_exprs: List[E.Expr], negated: bool) -> L.LogicalPlan:
        alias = f"__correlated_sq_{next(_ALIAS_COUNTER)}"
        # Sort/Limit under EXISTS is inert (existence is order-independent;
        # a positive fetch cannot empty a non-empty input) — strip it like
        # the reference (decorrelate_predicate_subquery.rs strips via
        # eliminate_*). LIMIT 0 empties the subquery: EXISTS is then
        # constant false.
        if not in_exprs:
            while isinstance(sub, (L.Sort, L.Limit)):
                if isinstance(sub, L.Limit) and sub.fetch == 0:
                    sub = L.EmptyRelation(False, sub.schema)
                    break
                sub = sub.inputs[0]
        sub_schema_before = sub.schema
        sub2, pulled = _pull_correlations(sub)
        sub2 = L.SubqueryAlias(sub2, alias)
        on, residual = _split_join_conditions(pulled, alias)
        if in_exprs:
            first = sub_schema_before.fields[0]
            on.insert(0, (in_exprs[0], E.Column(first.name, alias)))
        jt = "LEFTANTI" if negated else "LEFTSEMI"
        if not on and not residual:
            # uncorrelated EXISTS: nested-loop semi/anti join with an
            # always-true filter — keeps/drops every outer row depending
            # on whether the subquery produces any rows at all
            from ..common.scalar import ScalarValue
            from ..common import dt
            true_lit = E.Literal(ScalarValue.boolean(True))
            return L.Join(outer, sub2, [], true_lit, jt)
        return L.Join(outer, sub2, on, conjunction(residual), jt)


# --------------------------------------------------------------------------
# scalar subquery -> left join
# --------------------------------------------------------------------------

class ScalarSubqueryToJoin:
    name = "scalar_subquery_to_join"

    def rewrite(self, plan):
        def find(e, out):
            if isinstance(e, E.ScalarSubquery):
                out.append(e)
            for ch in e.children():
                find(ch, out)

        def f(node):
            if isinstance(node, L.Filter):
                subqueries: List[E.ScalarSubquery] = []
                find(node.predicate, subqueries)
                if not subqueries:
                    return node
                current = node.input
                pred = node.predicate
                for sq in subqueries:
                    current, replacement = self._to_join(current, sq)
                    pred = _replace_expr(pred, sq, replacement)
                return L.Filter(pred, current)
            if isinstance(node, L.Projection):
                # scalar subqueries in the select list (reference:
                # scalar_subquery_to_join.rs also rewrites Projection)
                all_sq: List[E.ScalarSubquery] = []
                for e in node.exprs:
                    find(e, all_sq)
                if not all_sq:
                    return node
                current = node.input
                new_exprs = []
                for e in node.exprs:
                    subqueries = []
                    find(e, subqueries)
                    if subqueries:
                        name = e.name if isinstance(e, E.Alias) \
                            else e.display_name()
                        for sq in subqueries:
                            current, repl = self._to_join(current, sq)
                            e = _replace_expr(e, sq, repl)
                        if not isinstance(e, E.Alias):
                            e = E.Alias(e, name)
                    new_exprs.append(e)
                return L.Projection(new_exprs, current)
            return node
        return plan.transform_up(f)

    def _to_join(self, outer: L.LogicalPlan, sq: E.ScalarSubquery):
        from ..common import dt
        from ..common.scalar import ScalarValue
        alias = f"__scalar_sq_{next(_ALIAS_COUNTER)}"
        sub = sq.subquery
        if len(sub.schema.fields) != 1:
            raise PlanError(
                "Scalar subquery should only return one column, found "
                f"{len(sub.schema.fields)}: "
                + ", ".join(str(f.name) for f in sub.schema.fields))
        scalar_field = sub.schema.fields[0]
        correlated = _plan_has_outer(sub)
        dedup_first = False
        if correlated:
            # at-most-one-row analysis (reference: analyzer
            # check_analyzed_plan + scalar_subquery_to_join.rs): LIMIT 1
            # is strippable proof; larger limits are rejected below unless
            # an aggregate bounds the row count
            while isinstance(sub, (L.Sort, L.Limit)):
                if isinstance(sub, L.Limit):
                    if sub.fetch == 0:
                        null = E.Literal(ScalarValue(scalar_field.dtype,
                                                     None))
                        return outer, null
                    if sub.fetch == 1:
                        dedup_first = True
                    else:
                        raise PlanError(
                            "Correlated scalar subquery must be aggregated "
                            "to return at most one row")
                sub = sub.inputs[0]
        sub2, pulled = _pull_correlations(sub)
        on, residual = _split_join_conditions(pulled, alias)
        if residual:
            # reference: "Correlated column is not allowed in predicate"
            raise PlanError(
                "Correlated column is not allowed in predicate: "
                f"{residual[0]}")
        replacement: E.Expr = E.Column(scalar_field.name, alias)
        if correlated and on:
            inner_keys = {r.name for _l, r in on}
            agg = _find_scalar_aggregate(sub)
            if agg is not None and agg.group_exprs and \
                    _traces_to_group_key(sub, agg, scalar_field.name):
                # output is a bare group key, not an aggregate value
                # (reference rejects: the value is not functionally bounded)
                raise PlanError(
                    "Correlated scalar subquery must be aggregated to "
                    "return at most one row")
            if agg is None:
                if not (dedup_first or _unique_on(sub2, inner_keys)
                        or _max_one_row(sub)):
                    raise PlanError(
                        "Correlated scalar subquery must be aggregated to "
                        "return at most one row")
                if dedup_first:
                    # LIMIT 1 per outer row: keep one arbitrary matching
                    # row per correlation key
                    key_cols = [E.Column(k) for k in inner_keys]
                    sel = [E.Column(f.name) for f in sub2.schema.fields]
                    sub2 = L.Distinct(sub2, on_exprs=key_cols,
                                      select_exprs=sel)
            else:
                for g in agg.group_exprs:
                    ok = isinstance(g, E.Literal) or (
                        isinstance(g, E.Column) and g.name in inner_keys)
                    if not ok:
                        raise PlanError(
                            "A GROUP BY clause in a scalar correlated "
                            "subquery cannot contain non-correlated columns")
                # the count bug (reference: decorrelate.rs empty-group
                # handling): an ungrouped aggregate over ZERO matching rows
                # still defines a value (count(*)=0 and everything derived
                # from it — including HAVING, which may also REJECT the
                # value a real group produced). Fix post-join: the empty
                # aggregate values are synthesized with a mark column, and
                # the projection/HAVING chain above the aggregate is folded
                # into the replacement expression evaluated after the join.
                if not agg.group_exprs:
                    fixed = _chain_replacement(sub, sub2, agg, alias,
                                               scalar_field)
                    if fixed is not None:
                        sub2, replacement = fixed
        sub2 = L.SubqueryAlias(sub2, alias)
        if on:
            join = L.Join(outer, sub2, on, None, "LEFT")
        else:
            # uncorrelated: LEFT nested-loop join on true so an EMPTY
            # single-row subquery still yields NULL per outer row
            # (cross join would drop every row)
            true_lit = E.Literal(ScalarValue.boolean(True))
            join = L.Join(outer, sub2, [], true_lit, "LEFT")
        return join, replacement


def _max_one_row(plan: L.LogicalPlan) -> bool:
    """Provably at most one output row regardless of parameter values
    (reference: plan.max_rows() analysis in the subquery checker)."""
    if isinstance(plan, L.EmptyRelation):
        return True
    if isinstance(plan, L.Values):
        return len(plan.rows) <= 1
    if isinstance(plan, L.Aggregate):
        return not plan.group_exprs
    if isinstance(plan, L.Limit):
        return (plan.fetch is not None and plan.fetch <= 1) or \
            _max_one_row(plan.inputs[0])
    if isinstance(plan, (L.Projection, L.Filter, L.SubqueryAlias, L.Sort,
                         L.Distinct)):
        return _max_one_row(plan.inputs[0])
    return False


def _traces_to_group_key(sub, agg, scalar_name: str) -> bool:
    """Whether the subquery's scalar output column is (a rename of) one of
    the aggregate's group keys rather than an aggregate value."""
    name = scalar_name
    node = sub
    while node is not agg and name is not None:
        if isinstance(node, L.Projection):
            nxt = None
            for e, f in zip(node.exprs, node.schema.fields):
                if f.name == name:
                    base = e.expr if isinstance(e, E.Alias) else e
                    nxt = base.name if isinstance(base, E.Column) else None
                    break
            name = nxt
        node = node.inputs[0]
    if name is None:
        return False
    n_groups = len(agg.group_exprs)
    return name in {f.name for f in agg.schema.fields[:n_groups]}


def _find_scalar_aggregate(sub: L.LogicalPlan):
    """The Aggregate that bounds a correlated scalar subquery's row count,
    reached through unary Projection/Filter/SubqueryAlias/Sort/Limit."""
    node = sub
    while isinstance(node, (L.Projection, L.Filter, L.SubqueryAlias,
                            L.Sort, L.Limit)):
        node = node.inputs[0]
    return node if isinstance(node, L.Aggregate) else None


def _unique_on(sub: L.LogicalPlan, key_names) -> bool:
    """True when `sub`'s functional dependencies prove at most one row per
    value of `key_names` (e.g. a PRIMARY KEY correlation column —
    reference: plan max-rows analysis via FunctionalDependencies)."""
    try:
        fields = sub.schema.fields
        key_idx = {i for i, f in enumerate(fields) if f.name in key_names}
        for src, _tgt in sub.functional_deps() or []:
            if set(src) <= key_idx:
                return True
    except Exception:  # noqa: BLE001 — no dependency info: not provable
        pass
    return False


def _chain_replacement(sub, sub2, agg, alias, scalar_field):
    """Count-bug fixup (reference: decorrelate.rs + scalar_subquery_to_join):
    rebuild the correlated-aggregate subquery so the join sees the RAW
    aggregate row plus an __always_true mark, then express the original
    projection/HAVING chain as a post-join expression where empty groups
    take the aggregate's empty-input value (count -> 0, others -> NULL).
    Returns (new_subquery_plan, replacement_expr) or None when the chain
    cannot be folded (leaves the plain LEFT-join NULL semantics)."""
    from ..common.scalar import ScalarValue

    # collect the chain of nodes between the subquery root and the agg
    chain = []
    node = sub
    while node is not agg:
        if not isinstance(node, (L.Projection, L.Filter, L.SubqueryAlias,
                                 L.Sort, L.Limit)):
            return None
        for e in node.expressions():
            if _contains_outer(e):
                return None
        chain.append(node)
        node = node.inputs[0]

    # the pulled twin of `agg` inside sub2 (same shape, one node per chain
    # entry) — its schema = correlation keys ++ aggregate outputs
    agg2 = sub2
    while not isinstance(agg2, L.Aggregate):
        agg2 = agg2.inputs[0]

    mark = "__always_true"
    true_lit = E.Literal(ScalarValue.boolean(True))
    new_sub = L.Projection(
        [E.Column(f.name) for f in agg2.schema.fields]
        + [E.Alias(true_lit, mark)], agg2)
    missing = E.IsNull(E.Column(mark, alias))

    env = {}
    for i, a in enumerate(agg.aggr_exprs):
        fld = agg.schema.fields[i]
        base = a.expr if isinstance(a, E.Alias) else a
        col = E.Column(fld.name, alias)
        if isinstance(base, E.AggregateFunction) and \
                base.name in ("count", "approx_distinct"):
            zero = E.Literal(ScalarValue(fld.dtype, 0))
            env[fld.name] = E.Case(None, ((missing, zero),), col)
        else:
            env[fld.name] = col

    def subst(e):
        def rw(n):
            if isinstance(n, E.Column) and n.name in env:
                return env[n.name]
            return n
        return e.transform_up(rw)

    guards = []
    for nd in reversed(chain):
        if isinstance(nd, L.Filter):
            guards.append(subst(nd.predicate))
        elif isinstance(nd, L.Projection):
            new_env = {}
            for e, f in zip(nd.exprs, nd.schema.fields):
                base = e.expr if isinstance(e, E.Alias) else e
                new_env[f.name] = subst(base)
            env = new_env
    value = env.get(scalar_field.name)
    if value is None:
        return None
    if guards:
        guard = conjunction(guards)
        null = E.Literal(ScalarValue(scalar_field.dtype, None))
        value = E.Case(None, ((guard, value),), null)
    return new_sub, value


def _replace_expr(tree: E.Expr, target: E.Expr, replacement: E.Expr) -> E.Expr:
    def rw(n):
        if n is target:
            return replacement
        return n
    return tree.transform_up(rw)
