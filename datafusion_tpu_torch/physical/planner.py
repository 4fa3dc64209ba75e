"""Physical planner: LogicalPlan -> ExecutionPlan.

Reference parity: `DefaultPhysicalPlanner`
(`datafusion/core/src/physical_planner.rs:429` — bottom-up
`create_initial_plan` :538, per-node lowering `map_logical_node_to_physical`
:697: TableScan -> TableProvider::scan :705, Aggregate -> two-phase
Partial+Final :926, Join -> Hash/NLJ selection :1119).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..common import dt
from ..common.errors import PlanError, internal
from ..common.schema import Schema
from ..expr import expr as E
from ..expr import plan as L
from .expressions import PhysicalExpr, compile_expr, compile_exprs
from .plan.aggregate import AggregateExec, AggregateMode, PhysAggregateExpr
from .plan.base import ExecutionPlan, Partitioning
from .plan.explain import AnalyzeExec, ExplainExec
from .plan.joins import CrossJoinExec, HashJoinExec, NestedLoopJoinExec
from .plan.projection import (CoalescePartitionsExec, FilterExec,
                              GlobalLimitExec, ProjectionExec, UnionExec)
from .plan.recursive import RecursiveQueryExec
from .plan.repartition import RepartitionExec
from .plan.scan import EmptyExec, PlaceholderRowExec, ValuesExec
from .plan.sort import PhysSortExpr, SortExec, SortPreservingMergeExec
from .plan.window import PhysWindowExpr, WindowExec


class PhysicalPlanner:
    """The reference's planner, whose physical optimizer is the port's:
    its device rules plan the port's execs on `device`, caching resident
    columns in `cache` and the join chains' staged builds in
    `chain_caches`; a mesh branch runs over `mesh` when it has the shards
    asked for."""

    def __init__(self, config=None, device=None, cache=None, mesh=None,
                 chain_caches=None):
        from ..common.config import ConfigOptions
        self.config = config or ConfigOptions()
        if device is None:
            raise ValueError("the port's planner needs an explicit device")
        self.device = device
        self.cache = cache
        self.mesh = mesh
        self.chain_caches = chain_caches

    # ------------------------------------------------------------------
    def create_physical_plan(self, plan: L.LogicalPlan) -> ExecutionPlan:
        phys = self._plan(plan)
        from .physical_optimizer import optimize_physical
        return optimize_physical(phys, self.config, self.device, self.cache,
                                 self.mesh, self.chain_caches)

    def _plan(self, node: L.LogicalPlan) -> ExecutionPlan:
        if isinstance(node, L.TableScan):
            # filters stay logical: scans use them for stats pruning only
            return node.source.scan(node.projection, list(node.filters),
                                    node.fetch, self)

        if isinstance(node, L.EmptyRelation):
            if node.produce_one_row:
                return PlaceholderRowExec(node.schema)
            return EmptyExec(node.schema)

        if isinstance(node, L.Values):
            empty = Schema.empty()
            rows = [[compile_expr(e, empty) for e in row] for row in node.rows]
            return ValuesExec(node.schema, rows)

        if isinstance(node, L.Projection):
            child = self._plan(node.input)
            exprs = compile_exprs(node.exprs, node.input.schema)
            names = node.schema.names()
            return ProjectionExec(exprs, names, child,
                                  [f.nullable for f in node.schema.fields])

        if isinstance(node, L.Filter):
            child = self._plan(node.input)
            pred = compile_expr(node.predicate, node.input.schema)
            return FilterExec(pred, child)

        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)

        if isinstance(node, L.Sort):
            child = self._plan(node.input)
            ses = [PhysSortExpr(compile_expr(s.expr, node.input.schema),
                                s.asc, s.nulls_first)
                   for s in node.sort_exprs]
            return SortExec(ses, child, fetch=node.fetch)

        if isinstance(node, L.Join):
            return self._plan_join(node)

        if isinstance(node, L.CrossJoin):
            return CrossJoinExec(self._plan(node.left), self._plan(node.right))

        if isinstance(node, L.Limit):
            child = self._plan(node.input)
            return GlobalLimitExec(child, node.skip, node.fetch)

        if isinstance(node, L.Union):
            children = [self._plan(i) for i in node.inputs]
            # partition-aligned inputs interleave instead of multiplying
            # partitions (reference: union.rs can_interleave)
            from .plan.base import PartitioningKind
            parts = [c.output_partitioning() for c in children]
            if len(children) > 1 and \
                    all(p.kind == PartitioningKind.HASH for p in parts) and \
                    len({p.n for p in parts}) == 1:
                from .plan.projection import InterleaveExec
                return InterleaveExec(children)
            return UnionExec(children)

        if isinstance(node, L.Intersect):
            return self._plan_set_op(node, "LEFTSEMI")

        if isinstance(node, L.Except):
            return self._plan_set_op(node, "LEFTANTI")

        if isinstance(node, L.Distinct):
            return self._plan_distinct(node)

        if isinstance(node, L.Window):
            return self._plan_window(node)

        if isinstance(node, L.SubqueryAlias):
            child = self._plan(node.input)
            # re-qualify the child's output schema so parent column
            # resolution by alias works
            from .plan.projection import ProjectionExec as _P
            from .expressions import ColumnExpr
            schema = node.schema
            exprs = [ColumnExpr(i, f.name, f.dtype) for i, f in enumerate(schema)]
            p = _P(exprs, schema.names(), child)
            p._schema = schema
            return p

        if isinstance(node, L.Explain):
            from .plan.explain import display_graphviz, display_pgjson
            inner = node.plan
            rows = []
            from .physical_optimizer import optimize_physical
            phys = optimize_physical(self._plan(inner), self.config,
                                     self.device, self.cache, self.mesh,
                                     self.chain_caches)
            if node.analyze:
                return AnalyzeExec(phys, node.verbose)
            fmt = getattr(node, "format", "indent")
            if fmt == "graphviz":
                rows.append(("logical_plan", display_graphviz(inner)))
                rows.append(("physical_plan", display_graphviz(phys)))
                return ExplainExec(rows)
            if fmt == "pgjson":
                rows.append(("logical_plan", display_pgjson(inner)))
                return ExplainExec(rows)
            if node.verbose and node.initial_display != inner.display():
                rows.append(("initial_logical_plan", node.initial_display))
            rows.append(("logical_plan", inner.display()))
            rows.append(("physical_plan", phys.display_indent()))
            return ExplainExec(rows)

        if isinstance(node, L.RecursiveQuery):
            static = self._plan(node.static_term)
            recursive = self._plan(node.recursive_term)
            provider = _find_worktable(node.recursive_term, node.name)
            if provider is None:
                raise PlanError(
                    f"recursive CTE '{node.name}' has no work-table reference")
            return RecursiveQueryExec(node.name, static, recursive, provider,
                                      node.is_distinct)

        if isinstance(node, L.Unnest):
            child = self._plan(node.input)
            idx = node.input.schema.index_of(node.column.name,
                                             node.column.qualifier)
            from .plan.unnest import UnnestExec
            return UnnestExec(child, idx, node.schema)

        raise internal(f"cannot lower logical node {type(node).__name__}")

    # ------------------------------------------------------------------
    def _plan_aggregate(self, node: L.Aggregate) -> ExecutionPlan:
        if node.has_grouping_sets():
            return self._plan_grouping_sets(node)
        child = self._plan(node.input)
        in_schema = node.input.schema
        out_schema = node.schema

        group_phys: List[Tuple[PhysicalExpr, str]] = []
        for i, g in enumerate(node.group_exprs):
            group_phys.append((compile_expr(g, in_schema), out_schema.field(i).name))

        aggr_phys: List[PhysAggregateExpr] = []
        k = len(node.group_exprs)
        for j, a in enumerate(node.aggr_exprs):
            agg = a.expr if isinstance(a, E.Alias) else a
            if not isinstance(agg, E.AggregateFunction):
                raise PlanError(f"expected aggregate function, got {agg}")
            display = out_schema.field(k + j).name
            # count(*) / count(1): row count. count(NULL) is NOT a row count
            # (it counts non-null literals, i.e. 0 rows).
            count_star = agg.name == "count" and (
                not agg.args or (len(agg.args) == 1
                                 and isinstance(agg.args[0], E.Literal)
                                 and not agg.args[0].value.is_null))
            args = [] if count_star else compile_exprs(list(agg.args), in_schema)
            filt = compile_expr(agg.filter, in_schema) if agg.filter is not None else None
            out_type = agg.data_type(in_schema)
            from .plan.sort import PhysSortExpr
            ob = [PhysSortExpr(compile_expr(s.expr, in_schema), s.asc,
                               s.nulls_first) for s in agg.order_by]
            aggr_phys.append(PhysAggregateExpr(
                agg.name, args, out_type, display, distinct=agg.distinct,
                filter=filt, count_star=count_star, order_by=ob,
                ignore_nulls=getattr(agg, "ignore_nulls", False)))

        n_parts = child.output_partitioning().n
        two_phase_ok = all(a.make_accumulator().supports_two_phase()
                           for a in aggr_phys)
        repartition = self.config.get("datafusion.optimizer.repartition_aggregations") \
            if hasattr(self.config, "get") else True

        if n_parts <= 1 or not two_phase_ok or not repartition:
            if n_parts > 1:
                child = CoalescePartitionsExec(child)
            return AggregateExec(AggregateMode.SINGLE, group_phys, aggr_phys, child)

        # two-phase: Partial per partition -> exchange -> Final
        partial = AggregateExec(AggregateMode.PARTIAL, group_phys, aggr_phys, child)
        from .expressions import ColumnExpr
        final_groups = [(ColumnExpr(i, n, e.out_type), n)
                        for i, (e, n) in enumerate(group_phys)]
        if group_phys:
            hash_exprs = [ColumnExpr(i, n, e.out_type)
                          for i, (e, n) in enumerate(group_phys)]
            exchange = RepartitionExec(
                partial, Partitioning.hash(hash_exprs, n_parts))
            mode = AggregateMode.FINAL_PARTITIONED
        else:
            exchange = CoalescePartitionsExec(partial)
            mode = AggregateMode.FINAL
        return AggregateExec(mode, final_groups, aggr_phys, exchange)

    def _plan_grouping_sets(self, node: L.Aggregate) -> ExecutionPlan:
        """Expand GROUPING SETS / ROLLUP / CUBE into a union of per-set
        aggregates with NULL placeholders for absent dimensions
        (the reference uses a null-masked PhysicalGroupBy,
        `aggregates/mod.rs` PhysicalGroupBy; this expansion is
        semantically equivalent)."""
        gs = None
        for g in node.group_exprs:
            if isinstance(g, E.GroupingSet):
                gs = g
        assert gs is not None
        all_dims = node.output_group_exprs()
        parts = []
        for s in gs.sets:
            present = list(s)
            group = present
            agg = L.Aggregate(group, node.aggr_exprs, node.input)
            # project to the full dim list with NULLs for absent dims
            proj_exprs: List[E.Expr] = []
            ischema = node.input.schema
            for d in all_dims:
                # structural equality, NOT display text: a.c1 and b.c1 both
                # display as "c1" but are different grouping dimensions
                if any(d == p for p in present):
                    if isinstance(d, E.Column):
                        # keep the qualifier: a.c1 and b.c1 may both group
                        proj_exprs.append(E.Column(d.name, d.qualifier))
                    else:
                        proj_exprs.append(E.Column(d.display_name()))
                else:
                    lit = E.Literal(_null_scalar(d.data_type(ischema)))
                    proj_exprs.append(E.Alias(lit, d.display_name()))
            for a in node.aggr_exprs:
                nm = a.name if isinstance(a, E.Alias) else a.display_name()
                proj_exprs.append(E.Column(nm))
            parts.append(L.Projection(proj_exprs, agg))
        union = L.Union(parts, node.schema)
        return self._plan(union)

    # ------------------------------------------------------------------
    def _plan_join(self, node: L.Join) -> ExecutionPlan:
        # JoinSelection (reference: physical_optimizer/join_selection.rs
        # should_swap_join_order :62-88): put the smaller side on the build
        # side by estimated rows; restore column order with a projection.
        swapped = False
        jnode = node
        if node.on and _should_swap_join(node):
            jnode = _swap_join(node)
            swapped = True

        left = self._plan(jnode.left)
        right = self._plan(jnode.right)
        lschema, rschema = jnode.left.schema, jnode.right.schema
        pair_schema = lschema.merge(rschema)

        filt = compile_expr(jnode.filter, pair_schema) \
            if jnode.filter is not None else None

        if jnode.on:
            on = []
            for l, r in jnode.on:
                le = compile_expr(l, lschema)
                re_ = compile_expr(r, rschema)
                on.append((le, re_))
            cls = HashJoinExec
            try:
                if not self.config.get("datafusion.optimizer.prefer_hash_join"):
                    from .plan.joins import SortMergeJoinExec
                    cls = SortMergeJoinExec
            except Exception:
                pass
            join = cls(left, right, on, jnode.join_type, filt,
                       filter_schema=pair_schema)
        elif filt is not None or jnode.join_type != "INNER":
            join = NestedLoopJoinExec(left, right, filt, jnode.join_type,
                                      filter_schema=pair_schema)
        else:
            join = CrossJoinExec(left, right)

        if swapped and jnode.join_type not in ("LEFTSEMI", "LEFTANTI",
                                               "RIGHTSEMI", "RIGHTANTI"):
            # restore original (node.left ++ node.right) column order
            from .expressions import ColumnExpr
            out = node.schema
            n_l = len(node.left.schema)
            n_r = len(node.right.schema)
            exprs = []
            for i in range(n_l):          # original left cols sit after right
                f = out.field(i)
                exprs.append(ColumnExpr(n_r + i, f.name, f.dtype))
            for i in range(n_r):
                f = out.field(n_l + i)
                exprs.append(ColumnExpr(i, f.name, f.dtype))
            p = ProjectionExec(exprs, out.names(), join)
            p._schema = out
            return p
        return join

    def _plan_set_op(self, node, join_type: str) -> ExecutionPlan:
        """INTERSECT/EXCEPT -> distinct + null-safe semi/anti hash join
        (reference rewrites these during logical planning,
        `sql/src/set_expr.rs`)."""
        left = self._plan(node.left)
        right = self._plan(node.right)
        from .expressions import ColumnExpr
        lschema, rschema = node.left.schema, node.right.schema
        on = [(ColumnExpr(i, lschema.field(i).name, lschema.field(i).dtype),
               ColumnExpr(i, rschema.field(i).name, rschema.field(i).dtype))
              for i in range(len(lschema))]
        join = HashJoinExec(left, right, on, join_type,
                            null_equals_null=True)
        if not node.all:
            groups = [(ColumnExpr(i, f.name, f.dtype), f.name)
                      for i, f in enumerate(lschema)]
            return AggregateExec(AggregateMode.SINGLE, groups, [],
                                 _coalesced(join))
        return join

    def _plan_distinct(self, node: L.Distinct) -> ExecutionPlan:
        in_schema = node.input.schema
        if node.on_exprs is None:
            child = self._plan(node.input)
            from .expressions import ColumnExpr
            groups = [(ColumnExpr(i, f.name, f.dtype), f.name)
                      for i, f in enumerate(in_schema)]
            return AggregateExec(AggregateMode.SINGLE, groups, [],
                                 _coalesced(child))
        # DISTINCT ON (exprs) [ORDER BY ...]: sort then keep first per key
        inner: L.LogicalPlan = node.input
        if node.sort_exprs:
            inner = L.Sort(node.sort_exprs, inner)
        child = self._plan(inner)
        groups = [(compile_expr(e, in_schema), e.display_name())
                  for e in node.on_exprs]
        aggs = []
        out_names = []
        for e in node.select_exprs:
            agg = PhysAggregateExpr(
                "first_value", [compile_expr(
                    e.expr if isinstance(e, E.Alias) else e, in_schema)],
                (e.expr if isinstance(e, E.Alias) else e).data_type(in_schema),
                e.name if isinstance(e, E.Alias) else e.display_name())
            aggs.append(agg)
            out_names.append(agg.display)
        agg_exec: ExecutionPlan = AggregateExec(
            AggregateMode.SINGLE, groups, aggs, _coalesced(child))
        from .expressions import ColumnExpr
        if node.sort_exprs:
            # output stays ordered by the ON prefix of the ORDER BY
            # (reference: replace_distinct_aggregate.rs plans
            # Sort(on-prefix) over the first_value aggregate)
            agg_schema = agg_exec.schema()
            prefix = []
            for i, s in enumerate(node.sort_exprs[:len(groups)]):
                f = agg_schema.fields[i]
                prefix.append(PhysSortExpr(
                    ColumnExpr(i, f.name, f.dtype), s.asc, s.nulls_first))
            agg_exec = SortExec(prefix, agg_exec)
        # project away the DISTINCT ON keys, keep select outputs
        k = len(groups)
        exprs = [ColumnExpr(k + i, n, a.out_type)
                 for i, (n, a) in enumerate(zip(out_names, aggs))]
        return ProjectionExec(exprs, out_names, agg_exec)

    def _plan_window(self, node: L.Window) -> ExecutionPlan:
        child = self._plan(node.input)
        in_schema = node.input.schema
        wexprs = []
        for e in node.window_exprs:
            w = e.expr if isinstance(e, E.Alias) else e
            if not isinstance(w, E.WindowFunction):
                raise PlanError(f"expected window function, got {w}")
            display = e.name if isinstance(e, E.Alias) else e.display_name()
            wexprs.append(PhysWindowExpr(
                name=w.name,
                args=compile_exprs(list(w.args), in_schema),
                partition_by=compile_exprs(list(w.partition_by), in_schema),
                order_by=[PhysSortExpr(compile_expr(s.expr, in_schema),
                                       s.asc, s.nulls_first)
                          for s in w.order_by],
                frame=w.frame,
                out_type=w.data_type(in_schema),
                display=display,
                ignore_nulls=w.ignore_nulls))
        # shared non-empty PARTITION BY -> bounded-memory streaming window
        # over a partition-key sort (reference: get_best_fitting_window)
        pb0 = [str(p) for p in wexprs[0].partition_by]
        if pb0 and all([str(p) for p in w.partition_by] == pb0
                       for w in wexprs):
            from .plan.sort import SortExec
            from .plan.window import BoundedWindowExec
            # partition keys are direction- and order-free: when the child
            # already delivers an ordering whose prefix covers the partition
            # set, no sort is needed (reference: get_window_mode can_skip_sort)
            pset = set(pb0)
            for have in child.output_orderings():
                if len(have) >= len(pset) and \
                        {h[0] for h in have[:len(pset)]} == pset:
                    return BoundedWindowExec(wexprs, child)
            if child.unbounded():
                # Linear mode: no sort is possible on an infinite stream;
                # output keeps the input ordering (reference:
                # BoundedWindowAggExec mode=[Linear], get_window_mode)
                return WindowExec(wexprs, child, linear=True)
            sort = SortExec([PhysSortExpr(p) for p in wexprs[0].partition_by],
                            child)
            return BoundedWindowExec(wexprs, sort)
        return WindowExec(wexprs, child)


def _filter_selectivity(flt, scan, stats) -> float:
    """Range-based filter selectivity via interval constraint propagation
    (reference: physical-expr/src/analysis.rs over intervals/cp_solver.rs);
    falls back to the flat 20% default when bounds carry no information."""
    try:
        from ..optimizer.intervals import Interval, selectivity
        ranges = {}
        schema = scan.source.schema()
        import datetime
        for f, cs in zip(schema.fields, stats.column_statistics):
            mn, mx = cs.min_value.get(), cs.max_value.get()
            if mn is None or mx is None:
                continue
            try:
                if isinstance(mn, datetime.date) and not isinstance(
                        mn, datetime.datetime):
                    epoch = datetime.date(1970, 1, 1)
                    ranges[f.name] = Interval(float((mn - epoch).days),
                                              float((mx - epoch).days))
                else:
                    ranges[f.name] = Interval(float(mn), float(mx))
            except (TypeError, ValueError):
                continue       # string/unorderable stats carry no range
        if not ranges:
            return 0.2
        sel = selectivity(flt, ranges)
        if sel >= 1.0:          # opaque predicate: no interval information
            return 0.2
        return max(sel, 1e-4)
    except Exception:  # noqa: BLE001
        return 0.2


def _estimate_rows(node: L.LogicalPlan) -> Optional[float]:
    """Cardinality estimate for join-side selection (reference:
    physical_optimizer/join_selection.rs uses Statistics byte/row counts;
    we walk to scans and damp by 20% per filter —
    default_filter_selectivity)."""
    if isinstance(node, L.TableScan):
        try:
            stats = node.source.statistics()
            rows = stats.num_rows.get()
            if rows is None:
                return None
            sel = 1.0
            for flt in node.filters:
                sel *= _filter_selectivity(flt, node, stats)
            return max(rows * sel, 1.0)
        except Exception:  # noqa: BLE001
            return None
    if isinstance(node, L.Filter):
        r = _estimate_rows(node.input)
        return None if r is None else max(r * 0.2, 1.0)
    if isinstance(node, (L.Projection, L.SubqueryAlias, L.Sort)):
        return _estimate_rows(node.inputs[0])
    if isinstance(node, L.Limit):
        r = _estimate_rows(node.input)
        if node.fetch is not None:
            return min(r, node.fetch) if r is not None else node.fetch
        return r
    if isinstance(node, L.Aggregate):
        r = _estimate_rows(node.input)
        if not node.group_exprs:
            return 1.0
        return None if r is None else max(r ** 0.7, 1.0)
    if isinstance(node, L.Join):
        lr = _estimate_rows(node.left)
        rr = _estimate_rows(node.right)
        if lr is None or rr is None:
            return None
        if node.join_type in ("LEFTSEMI", "LEFTANTI"):
            return lr
        if node.join_type in ("RIGHTSEMI", "RIGHTANTI"):
            return rr
        return max(lr, rr)
    if isinstance(node, L.Union):
        parts = [_estimate_rows(i) for i in node.inputs]
        if any(p is None for p in parts):
            return None
        return sum(parts)
    return None


_SWAPPED_TYPE = {"INNER": "INNER", "LEFT": "RIGHT", "RIGHT": "LEFT",
                 "FULL": "FULL"}


def _should_swap_join(node: L.Join) -> bool:
    if node.join_type not in _SWAPPED_TYPE:
        return False
    lr = _estimate_rows(node.left)
    rr = _estimate_rows(node.right)
    if lr is None or rr is None:
        return False
    return rr < lr * 0.7   # swap only on a clear win


def _swap_join(node: L.Join) -> L.Join:
    on = [(r, l) for l, r in node.on]
    # the residual filter references columns by name, which survives side
    # swapping (compile resolves against the merged schema)
    return L.Join(node.right, node.left, on, node.filter,
                  _SWAPPED_TYPE[node.join_type], node.using_columns)


def _coalesced(plan: ExecutionPlan) -> ExecutionPlan:
    if plan.output_partitioning().n > 1:
        return CoalescePartitionsExec(plan)
    return plan


def _null_scalar(t):
    from ..common.scalar import ScalarValue
    return ScalarValue(t, None)


def _find_worktable(plan: L.LogicalPlan, name: str):
    from ..datasource.worktable import WorkTableProvider
    found = [None]

    def walk(node):
        if isinstance(node, L.TableScan) and \
                isinstance(node.source, WorkTableProvider) and \
                node.source.name == name:
            found[0] = node.source
        for c in node.inputs:
            walk(c)
    walk(plan)
    return found[0]
