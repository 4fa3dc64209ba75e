"""LogicalPlan IR.

Reference parity: `LogicalPlan` (27 variants,
`datafusion/expr/src/logical_plan/plan.rs:193-282`). Relational-algebra tree
with computed schemas; rewritten by the optimizer, lowered by the physical
planner.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..common import dt
from ..common.errors import PlanError, internal
from ..common.schema import Field, Schema
from ..common.scalar import ScalarValue
from .expr import (
    AggregateFunction, Alias, Column, Expr, GroupingSet, Literal, SortExpr,
    WindowFunction,
)

JOIN_TYPES = ("INNER", "LEFT", "RIGHT", "FULL", "LEFTSEMI", "RIGHTSEMI",
              "LEFTANTI", "RIGHTANTI")

_VOLATILE_FNS = frozenset({"random", "uuid", "now"})


def _is_volatile(e: Expr) -> bool:
    from .expr import ScalarFunction
    return bool(e.collect(lambda x: isinstance(x, ScalarFunction)
                          and x.name in _VOLATILE_FNS))


class LogicalPlan:
    """Base class. Subclasses define ``inputs`` and a lazily computed
    ``schema``."""

    _schema: Optional[Schema] = None

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._compute_schema()
        return self._schema

    def _compute_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    @property
    def inputs(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def with_inputs(self, inputs: Sequence["LogicalPlan"]) -> "LogicalPlan":
        assert not inputs
        return self

    def expressions(self) -> List[Expr]:
        return []

    def with_expressions(self, exprs: List[Expr]) -> "LogicalPlan":
        assert not exprs
        return self

    # ---- tree rewriting ----------------------------------------------------
    def transform_up(self, f) -> "LogicalPlan":
        new_inputs = tuple(i.transform_up(f) for i in self.inputs)
        node = self.with_inputs(new_inputs) if new_inputs != self.inputs else self
        out = f(node)
        return node if out is None else out

    def transform_down(self, f) -> "LogicalPlan":
        out = f(self)
        node = self if out is None else out
        new_inputs = tuple(i.transform_down(f) for i in node.inputs)
        return node.with_inputs(new_inputs) if new_inputs != node.inputs else node

    # ---- display --------------------------------------------------------------
    def display(self, indent: int = 0) -> str:
        lines = ["  " * indent + self._display_line()]
        for i in self.inputs:
            lines.append(i.display(indent + 1))
        return "\n".join(lines)

    def _display_line(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.display()

    # ---- functional dependencies ------------------------------------------
    def functional_deps(self):
        """Functional dependencies of this node's output: a list of
        ``(source_indices, target_indices)`` frozenset pairs, meaning the
        source field set jointly determines the target fields (reference:
        common/src/functional_dependencies.rs FunctionalDependence).

        Default: derived from per-field ``primary_key`` flags — within each
        qualifier, the flagged set determines that qualifier's fields."""
        fields = self.schema.fields
        by_q = {}
        for i, f in enumerate(fields):
            if f.primary_key:
                by_q.setdefault(f.qualifier, set()).add(i)
        out = []
        for q, src in by_q.items():
            tgt = frozenset(i for i, f in enumerate(fields)
                            if f.qualifier == q) | frozenset(src)
            out.append((frozenset(src), tgt))
        return out


# --------------------------------------------------------------------------


class TableScan(LogicalPlan):
    def __init__(self, name: str, source, projection: Optional[List[int]] = None,
                 filters: Tuple[Expr, ...] = (), fetch: Optional[int] = None):
        self.name = name
        self.source = source          # a TableProvider
        self.projection = projection  # column indices into source schema
        self.filters = tuple(filters)  # pushed-down predicates
        self.fetch = fetch

    def _compute_schema(self) -> Schema:
        s = self.source.schema().with_qualifier(self.name)
        if self.projection is not None:
            s = s.project(self.projection)
        return s

    def _display_line(self):
        s = f"TableScan: {self.name}"
        if self.projection is not None:
            s += f" projection=[{', '.join(self.schema.names())}]"
        if self.filters:
            s += f" filters=[{', '.join(map(str, self.filters))}]"
        if self.fetch is not None:
            s += f" fetch={self.fetch}"
        return s


class EmptyRelation(LogicalPlan):
    def __init__(self, produce_one_row: bool = False, schema: Optional[Schema] = None):
        self.produce_one_row = produce_one_row
        self._schema = schema if schema is not None else Schema.empty()

    def _compute_schema(self):
        return self._schema

    def _display_line(self):
        return f"EmptyRelation{': one row' if self.produce_one_row else ''}"


class Values(LogicalPlan):
    def __init__(self, rows: List[List[Expr]], schema: Schema):
        self.rows = rows
        self._schema = schema

    def expressions(self):
        return [e for row in self.rows for e in row]

    def _display_line(self):
        return f"Values: {len(self.rows)} rows"


class Projection(LogicalPlan):
    def __init__(self, exprs: List[Expr], input: LogicalPlan):
        self.exprs = list(exprs)
        self.input = input

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Projection(self.exprs, inputs[0])

    def expressions(self):
        return list(self.exprs)

    def with_expressions(self, exprs):
        return Projection(exprs, self.input)

    def _compute_schema(self):
        fields = []
        for e in self.exprs:
            q = None
            pk = False
            inner = e
            if isinstance(inner, Alias):
                name = inner.name
            elif isinstance(inner, Column):
                name, q = inner.name, inner.qualifier
                try:
                    pk = self.input.schema.field_by_name(
                        inner.name, inner.qualifier).primary_key
                except Exception:  # noqa: BLE001
                    pk = False
            else:
                name = e.display_name()
            fields.append(Field(name, e.data_type(self.input.schema),
                                e.nullable(self.input.schema), qualifier=q,
                                primary_key=pk))
        return Schema(fields).check_ambiguous_names()

    def functional_deps(self):
        # remap child deps through the projection; deterministic computed
        # expressions over determined columns become determined too
        # (reference: functional_dependencies.rs project_functional_dependencies)
        child = self.input.functional_deps()
        if not child:
            return []
        ischema = self.input.schema
        colmap = {}       # child index -> first output index carrying it
        computed = []     # (out_i, set-of-referenced-child-indices) | None
        for out_i, e in enumerate(self.exprs):
            inner = e.expr if isinstance(e, Alias) else e
            if isinstance(inner, Column):
                ci = ischema.maybe_index_of(inner.name, inner.qualifier)
                if ci is not None and ci not in colmap:
                    colmap[ci] = out_i
                computed.append(None)
            else:
                refs = set()
                ok = True
                for c in e.collect(lambda x: isinstance(x, Column)):
                    ci = ischema.maybe_index_of(c.name, c.qualifier)
                    if ci is None:
                        ok = False
                        break
                    refs.add(ci)
                if ok and not _is_volatile(e):
                    computed.append((out_i, refs))
                else:
                    computed.append(None)
        out = []
        for src, tgt in child:
            if not all(ci in colmap for ci in src):
                continue
            nsrc = frozenset(colmap[ci] for ci in src)
            ntgt = {colmap[ci] for ci in tgt if ci in colmap}
            determined = src | tgt
            for item in computed:
                if item is not None and item[1] <= determined:
                    ntgt.add(item[0])
            out.append((nsrc, frozenset(ntgt | nsrc)))
        return out

    def _display_line(self):
        return "Projection: " + ", ".join(map(str, self.exprs))


class Filter(LogicalPlan):
    def __init__(self, predicate: Expr, input: LogicalPlan):
        self.predicate = predicate
        self.input = input

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Filter(self.predicate, inputs[0])

    def expressions(self):
        return [self.predicate]

    def with_expressions(self, exprs):
        return Filter(exprs[0], self.input)

    def _compute_schema(self):
        return self.input.schema

    def functional_deps(self):
        return self.input.functional_deps()

    def _display_line(self):
        return f"Filter: {self.predicate}"


class Aggregate(LogicalPlan):
    """Schema = group exprs then aggregate exprs (reference:
    `logical_plan/plan.rs` Aggregate)."""

    def __init__(self, group_exprs: List[Expr], aggr_exprs: List[Expr],
                 input: LogicalPlan):
        self.group_exprs = list(group_exprs)
        self.aggr_exprs = list(aggr_exprs)
        self.input = input

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Aggregate(self.group_exprs, self.aggr_exprs, inputs[0])

    def expressions(self):
        return self.group_exprs + self.aggr_exprs

    def with_expressions(self, exprs):
        n = len(self.group_exprs)
        return Aggregate(exprs[:n], exprs[n:], self.input)

    def has_grouping_sets(self) -> bool:
        return any(isinstance(g, GroupingSet) for g in self.group_exprs)

    def output_group_exprs(self) -> List[Expr]:
        out: List[Expr] = []
        for g in self.group_exprs:
            if isinstance(g, GroupingSet):
                out.extend(g.distinct_exprs())
            else:
                out.append(g)
        return out

    def _compute_schema(self):
        ischema = self.input.schema
        fields = []
        gs = self.has_grouping_sets()
        for e in self.output_group_exprs():
            q = None
            pk = False
            if isinstance(e, Alias):
                name = e.name
            elif isinstance(e, Column):
                name, q = e.name, e.qualifier
                try:
                    pk = ischema.field_by_name(e.name, e.qualifier).primary_key
                except Exception:  # noqa: BLE001
                    pk = False
            else:
                name = e.display_name()
            # grouping-set columns are nullable (missing dimensions)
            fields.append(Field(name, e.data_type(ischema),
                                gs or e.nullable(ischema), qualifier=q,
                                primary_key=pk))
        for e in self.aggr_exprs:
            name = e.name if isinstance(e, Alias) else e.display_name()
            fields.append(Field(name, e.data_type(ischema), e.nullable(ischema)))
        return Schema(fields).check_ambiguous_names()

    def functional_deps(self):
        # after aggregation the group-by set is unique, so it determines
        # every output column (reference: functional_dependencies.rs
        # aggregate_functional_dependencies)
        if self.has_grouping_sets():
            return []
        n_g = len(self.output_group_exprs())
        if n_g == 0:
            return []
        all_idx = frozenset(range(len(self.schema.fields)))
        out = [(frozenset(range(n_g)), all_idx)]
        # a child dependency whose source maps entirely into group outputs
        # survives as a tighter key of the whole output
        ischema = self.input.schema
        colmap = {}
        for out_i, e in enumerate(self.output_group_exprs()):
            inner = e.expr if isinstance(e, Alias) else e
            if isinstance(inner, Column):
                ci = ischema.maybe_index_of(inner.name, inner.qualifier)
                if ci is not None and ci not in colmap:
                    colmap[ci] = out_i
        for src, _tgt in self.input.functional_deps():
            if src and all(ci in colmap for ci in src):
                out.append((frozenset(colmap[ci] for ci in src), all_idx))
        return out

    def _display_line(self):
        return (f"Aggregate: groupBy=[{', '.join(map(str, self.group_exprs))}], "
                f"aggr=[{', '.join(map(str, self.aggr_exprs))}]")


class Sort(LogicalPlan):
    def __init__(self, sort_exprs: List[SortExpr], input: LogicalPlan,
                 fetch: Optional[int] = None):
        self.sort_exprs = list(sort_exprs)
        self.input = input
        self.fetch = fetch

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Sort(self.sort_exprs, inputs[0], self.fetch)

    def expressions(self):
        return [s.expr for s in self.sort_exprs]

    def with_expressions(self, exprs):
        ses = [dataclasses.replace(s, expr=e) for s, e in zip(self.sort_exprs, exprs)]
        return Sort(ses, self.input, self.fetch)

    def _compute_schema(self):
        return self.input.schema

    def functional_deps(self):
        return self.input.functional_deps()

    def _display_line(self):
        s = "Sort: " + ", ".join(map(str, self.sort_exprs))
        if self.fetch is not None:
            s += f" fetch={self.fetch}"
        return s


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 on: List[Tuple[Expr, Expr]], filter: Optional[Expr],
                 join_type: str, using_columns: Tuple[str, ...] = ()):
        assert join_type in JOIN_TYPES, join_type
        self.left = left
        self.right = right
        self.on = list(on)
        self.filter = filter
        self.join_type = join_type
        self.using_columns = using_columns

    @property
    def inputs(self):
        return (self.left, self.right)

    def with_inputs(self, inputs):
        return Join(inputs[0], inputs[1], self.on, self.filter,
                    self.join_type, self.using_columns)

    def expressions(self):
        out = []
        for l, r in self.on:
            out.extend((l, r))
        if self.filter is not None:
            out.append(self.filter)
        return out

    def with_expressions(self, exprs):
        n = len(self.on)
        on = [(exprs[2 * i], exprs[2 * i + 1]) for i in range(n)]
        filt = exprs[2 * n] if self.filter is not None else None
        return Join(self.left, self.right, on, filt, self.join_type, self.using_columns)

    def _compute_schema(self):
        jt = self.join_type
        if jt in ("LEFTSEMI", "LEFTANTI"):
            return self.left.schema
        if jt in ("RIGHTSEMI", "RIGHTANTI"):
            return self.right.schema
        lf = list(self.left.schema.fields)
        rf = list(self.right.schema.fields)
        # null-extension: an already-nullable unique dependency dies, a
        # NOT NULL pk survives one extension (reference:
        # functional_dependencies.rs downgrade_dependencies)
        if jt in ("RIGHT", "FULL"):
            lf = [dataclasses.replace(
                f, nullable=True,
                primary_key=f.primary_key and not f.nullable and jt != "FULL")
                for f in lf]
        if jt in ("LEFT", "FULL"):
            rf = [dataclasses.replace(
                f, nullable=True,
                primary_key=f.primary_key and not f.nullable and jt != "FULL")
                for f in rf]
        return Schema(lf + rf)

    def functional_deps(self):
        # a side's key still determines that side's columns inside the join
        # output; null-extension downgrades mirror _compute_schema
        # (reference: functional_dependencies.rs join_functional_dependencies
        # + downgrade_dependencies)
        jt = self.join_type
        if jt in ("LEFTSEMI", "LEFTANTI"):
            return self.left.functional_deps()
        if jt in ("RIGHTSEMI", "RIGHTANTI"):
            return self.right.functional_deps()
        if jt == "FULL":
            return []
        lfields = self.left.schema.fields
        rfields = self.right.schema.fields
        nl = len(lfields)
        out = []
        for src, tgt in self.left.functional_deps():
            # left side is null-extended by a RIGHT join: a NOT NULL key
            # survives one extension, a nullable one dies
            if jt != "RIGHT" or all(not lfields[i].nullable for i in src):
                out.append((src, tgt))
        for src, tgt in self.right.functional_deps():
            if jt != "LEFT" or all(not rfields[i].nullable for i in src):
                out.append((frozenset(i + nl for i in src),
                            frozenset(i + nl for i in tgt)))
        return out

    def _display_line(self):
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        s = f"{self.join_type.capitalize()} Join: {on}"
        if self.filter is not None:
            s += f" Filter: {self.filter}"
        return s


class CrossJoin(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        self.left = left
        self.right = right

    @property
    def inputs(self):
        return (self.left, self.right)

    def with_inputs(self, inputs):
        return CrossJoin(inputs[0], inputs[1])

    def _compute_schema(self):
        return self.left.schema.merge(self.right.schema)

    def _display_line(self):
        return "CrossJoin:"


class Limit(LogicalPlan):
    def __init__(self, input: LogicalPlan, skip: int = 0, fetch: Optional[int] = None):
        self.input = input
        self.skip = skip
        self.fetch = fetch

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Limit(inputs[0], self.skip, self.fetch)

    def _compute_schema(self):
        return self.input.schema

    def functional_deps(self):
        return self.input.functional_deps()

    def _display_line(self):
        return f"Limit: skip={self.skip}, fetch={self.fetch}"


class Union(LogicalPlan):
    def __init__(self, inputs_: List[LogicalPlan], schema: Optional[Schema] = None):
        self._inputs = list(inputs_)
        if schema is None:
            schema = Schema([dataclasses.replace(f, qualifier=None)
                             for f in self._inputs[0].schema.fields])
        self._schema = schema

    @property
    def inputs(self):
        return tuple(self._inputs)

    def with_inputs(self, inputs):
        return Union(list(inputs), self._schema)

    def _display_line(self):
        return "Union"


class Intersect(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, all: bool = False):
        self.left, self.right, self.all = left, right, all

    @property
    def inputs(self):
        return (self.left, self.right)

    def with_inputs(self, inputs):
        return Intersect(inputs[0], inputs[1], self.all)

    def _compute_schema(self):
        return self.left.schema

    def _display_line(self):
        return f"Intersect{' All' if self.all else ''}"


class Except(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, all: bool = False):
        self.left, self.right, self.all = left, right, all

    @property
    def inputs(self):
        return (self.left, self.right)

    def with_inputs(self, inputs):
        return Except(inputs[0], inputs[1], self.all)

    def _compute_schema(self):
        return self.left.schema

    def _display_line(self):
        return f"Except{' All' if self.all else ''}"


class Distinct(LogicalPlan):
    def __init__(self, input: LogicalPlan,
                 on_exprs: Optional[List[Expr]] = None,
                 select_exprs: Optional[List[Expr]] = None,
                 sort_exprs: Optional[List[SortExpr]] = None):
        self.input = input
        self.on_exprs = on_exprs          # DISTINCT ON
        self.select_exprs = select_exprs
        self.sort_exprs = sort_exprs

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Distinct(inputs[0], self.on_exprs, self.select_exprs, self.sort_exprs)

    def expressions(self):
        out = list(self.on_exprs or []) + list(self.select_exprs or [])
        out.extend(s.expr for s in self.sort_exprs or [])
        return out

    def with_expressions(self, exprs):
        n_on = len(self.on_exprs or [])
        n_sel = len(self.select_exprs or [])
        on = list(exprs[:n_on]) if self.on_exprs is not None else None
        sel = list(exprs[n_on:n_on + n_sel]) \
            if self.select_exprs is not None else None
        sort = None
        if self.sort_exprs is not None:
            sort = [SortExpr(e, s.asc, s.nulls_first)
                    for e, s in zip(exprs[n_on + n_sel:], self.sort_exprs)]
        return Distinct(self.input, on, sel, sort)

    def _compute_schema(self):
        if self.select_exprs is not None:
            return Projection(self.select_exprs, self.input).schema
        return self.input.schema

    def functional_deps(self):
        if self.select_exprs is not None:
            return Projection(self.select_exprs, self.input).functional_deps()
        return self.input.functional_deps()

    def _display_line(self):
        if self.on_exprs is not None:
            return f"DistinctOn: {', '.join(map(str, self.on_exprs))}"
        return "Distinct:"


class Window(LogicalPlan):
    """Appends one field per window expr to the input schema."""

    def __init__(self, window_exprs: List[Expr], input: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.input = input

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Window(self.window_exprs, inputs[0])

    def expressions(self):
        return list(self.window_exprs)

    def with_expressions(self, exprs):
        return Window(exprs, self.input)

    def _compute_schema(self):
        fields = list(self.input.schema.fields)
        for e in self.window_exprs:
            name = e.name if isinstance(e, Alias) else e.display_name()
            fields.append(Field(name, e.data_type(self.input.schema), True))
        return Schema(fields)

    def functional_deps(self):
        # a window value is fixed for a given row of the input relation, so
        # a key of the ENTIRE input also determines the window outputs; a
        # partial key (e.g. one side of a join) does not (reference:
        # group_by.slt "after join, new window expressions shouldn't be
        # associated with primary keys")
        n_in = len(self.input.schema.fields)
        all_in = frozenset(range(n_in))
        n_all = n_in + len(self.window_exprs)
        win = frozenset(range(n_in, n_all))
        out = []
        for src, tgt in self.input.functional_deps():
            if tgt >= all_in:
                tgt = tgt | win
            out.append((src, tgt))
        # ROW_NUMBER with an empty/constant PARTITION BY is unique across
        # the relation, so it determines every column (reference:
        # window.slt "row number result will be unique")
        for i, e in enumerate(self.window_exprs):
            w = e.expr if isinstance(e, Alias) else e
            if isinstance(w, WindowFunction) and w.name == "row_number" and \
                    all(isinstance(p, Literal) for p in w.partition_by):
                out.append((frozenset({n_in + i}), frozenset(range(n_all))))
        return out

    def _display_line(self):
        return "WindowAggr: " + ", ".join(map(str, self.window_exprs))


class SubqueryAlias(LogicalPlan):
    def __init__(self, input: LogicalPlan, alias: str):
        self.input = input
        self.alias = alias

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return SubqueryAlias(inputs[0], self.alias)

    def _compute_schema(self):
        return self.input.schema.with_qualifier(self.alias)

    def functional_deps(self):
        return self.input.functional_deps()

    def _display_line(self):
        return f"SubqueryAlias: {self.alias}"


class Unnest(LogicalPlan):
    def __init__(self, input: LogicalPlan, column: Column):
        self.input = input
        self.column = column

    @property
    def inputs(self):
        return (self.input,)

    def with_inputs(self, inputs):
        return Unnest(inputs[0], self.column)

    def _compute_schema(self):
        fields = []
        for f in self.input.schema.fields:
            if f.name == self.column.name:
                fields.append(dataclasses.replace(f, dtype=f.dtype.inner or dt.NULL))
            else:
                fields.append(f)
        return Schema(fields)

    def _display_line(self):
        return f"Unnest: {self.column}"


class Explain(LogicalPlan):
    def __init__(self, plan: LogicalPlan, analyze: bool = False, verbose: bool = False,
                 initial_display: Optional[str] = None, format: str = "indent"):
        self.plan = plan
        self.analyze = analyze
        self.verbose = verbose
        self.format = format       # indent | tree | graphviz | pgjson
        # snapshot of the pre-optimization plan text (EXPLAIN VERBOSE)
        self.initial_display = initial_display if initial_display is not None \
            else plan.display()

    @property
    def inputs(self):
        return (self.plan,)

    def with_inputs(self, inputs):
        return Explain(inputs[0], self.analyze, self.verbose,
                       self.initial_display, self.format)

    def _compute_schema(self):
        return Schema([Field("plan_type", dt.STRING, False),
                       Field("plan", dt.STRING, False)])

    def _display_line(self):
        return "Explain"


class RecursiveQuery(LogicalPlan):
    def __init__(self, name: str, static_term: LogicalPlan,
                 recursive_term: LogicalPlan, is_distinct: bool):
        self.name = name
        self.static_term = static_term
        self.recursive_term = recursive_term
        self.is_distinct = is_distinct

    @property
    def inputs(self):
        return (self.static_term, self.recursive_term)

    def with_inputs(self, inputs):
        return RecursiveQuery(self.name, inputs[0], inputs[1], self.is_distinct)

    def _compute_schema(self):
        return self.static_term.schema

    def _display_line(self):
        return f"RecursiveQuery: {self.name}"


# --------------------------------------------------------------------------
# helpers used by planner/optimizer


def columns_from_exprs(exprs: Sequence[Expr]) -> List[Column]:
    out: List[Column] = []
    for e in exprs:
        out.extend(c for c in e.collect(lambda x: isinstance(x, Column)))
    return out


def find_aggregate_exprs(exprs: Sequence[Expr]) -> List[AggregateFunction]:
    """Top-most aggregate calls in each expr (not descending into them)."""
    found: List[AggregateFunction] = []

    def walk(e: Expr):
        if isinstance(e, AggregateFunction):
            if e not in found:
                found.append(e)
            return
        if isinstance(e, WindowFunction):
            return  # window's internal agg handled by window planning
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return found


def find_window_exprs(exprs: Sequence[Expr]) -> List[WindowFunction]:
    found: List[WindowFunction] = []

    def walk(e: Expr):
        if isinstance(e, WindowFunction):
            if e not in found:
                found.append(e)
            return
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return found
