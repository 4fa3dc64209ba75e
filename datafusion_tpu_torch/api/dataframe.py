"""DataFrame — lazy LogicalPlan builder + execution entry.

Reference parity: `datafusion/core/src/dataframe/mod.rs` (40 public
methods; the ones here mirror the same names/semantics: select, filter,
aggregate, sort, limit, join, union, distinct, with_column, collect,
show, write_*).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..common.batch import Batch, concat_batches
from ..common.errors import PlanError
from ..common.schema import Schema
from ..expr import expr as E
from ..expr import plan as L


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self.plan = plan

    # ---- plan access -------------------------------------------------------
    def logical_plan(self) -> L.LogicalPlan:
        return self.plan

    def optimized_plan(self) -> L.LogicalPlan:
        return self.session.optimizer.optimize(self.plan,
                                               self.session.config.options)

    def schema(self) -> Schema:
        return self.plan.schema

    def create_physical_plan(self):
        key = getattr(self, "_cache_key", None)
        cache = getattr(self.session, "_physical_cache", None) \
            if key is not None else None
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                cache.move_to_end(key)
                hit.reset_state_recursive()
                return hit
        opt = self.optimized_plan()
        phys = self.session.planner.create_physical_plan(opt)
        if cache is not None:
            while len(cache) >= 64:
                cache.popitem(last=False)
            cache[key] = phys
        return phys

    # ---- execution ----------------------------------------------------------
    def collect(self) -> List[Batch]:
        from ..physical.plan.base import collect
        phys = self.create_physical_plan()
        return collect(phys, self.session.task_context())

    def collect_batch(self) -> Batch:
        batches = self.collect()
        if not batches:
            return Batch.empty(self.plan.schema)
        return concat_batches(batches[0].schema, batches)

    def count(self) -> int:
        return sum(b.num_rows for b in self.collect())

    def to_pylist(self) -> List[dict]:
        b = self.collect_batch()
        names = b.schema.names()
        cols = [c.to_pylist(b.num_rows) for c in b.columns]
        return [dict(zip(names, row)) for row in zip(*cols)] if cols else []

    def to_pydict(self) -> dict:
        b = self.collect_batch()
        return {f.name: c.to_pylist(b.num_rows)
                for f, c in zip(b.schema, b.columns)}

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.to_pydict())

    def to_arrow(self):
        from ..datasource.arrow_convert import batch_to_arrow
        return batch_to_arrow(self.collect_batch())

    def show(self, limit: int = 40) -> None:
        print(self.format(limit))

    def format(self, limit: int = 40) -> str:
        b = self.collect_batch()
        names = b.schema.names()
        n = min(b.num_rows, limit) if limit else b.num_rows
        cols = [c.to_pylist(b.num_rows)[:n] for c in b.columns]
        rows = [[_fmt(v) for v in row] for row in zip(*cols)] if cols else []
        widths = [max(len(nm), *(len(r[i]) for r in rows)) if rows else len(nm)
                  for i, nm in enumerate(names)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep,
               "|" + "|".join(f" {nm:<{w}} " for nm, w in zip(names, widths)) + "|",
               sep]
        for r in rows:
            out.append("|" + "|".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
        out.append(sep)
        if b.num_rows > n:
            out.append(f"({b.num_rows} rows total, showing {n})")
        return "\n".join(out)

    def explain(self, analyze: bool = False, verbose: bool = False) -> "DataFrame":
        return DataFrame(self.session, L.Explain(self.plan, analyze, verbose))

    # ---- transformations ----------------------------------------------------
    def select(self, *exprs) -> "DataFrame":
        exprs = [self._to_expr(e) for e in exprs]
        return self._with(L.Projection(list(exprs), self.plan))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*[E.Column(n) for n in names])

    def filter(self, predicate) -> "DataFrame":
        return self._with(L.Filter(self._to_expr(predicate), self.plan))

    where = filter

    def aggregate(self, group_exprs: Sequence, aggr_exprs: Sequence) -> "DataFrame":
        g = [self._to_expr(e) for e in group_exprs]
        a = [self._to_expr(e) for e in aggr_exprs]
        return self._with(L.Aggregate(g, a, self.plan))

    def sort(self, *sort_exprs) -> "DataFrame":
        ses = []
        for s in sort_exprs:
            if isinstance(s, E.SortExpr):
                ses.append(s)
            else:
                ses.append(E.SortExpr(self._to_expr(s)))
        return self._with(L.Sort(ses, self.plan))

    def limit(self, skip: int = 0, fetch: Optional[int] = None) -> "DataFrame":
        return self._with(L.Limit(self.plan, skip, fetch))

    def distinct(self) -> "DataFrame":
        return self._with(L.Distinct(self.plan))

    def distinct_on(self, on_exprs: Sequence, select_exprs: Sequence,
                    sort_exprs: Sequence = ()) -> "DataFrame":
        """DISTINCT ON (reference: dataframe/mod.rs distinct_on)."""
        return self._with(L.Distinct(
            self.plan,
            on_exprs=[self._to_expr(e) for e in on_exprs],
            select_exprs=[self._to_expr(e) for e in select_exprs],
            sort_exprs=[e if isinstance(e, E.SortExpr)
                        else E.SortExpr(self._to_expr(e))
                        for e in sort_exprs] or None))

    def fill_null(self, value, columns: Optional[Sequence[str]] = None
                  ) -> "DataFrame":
        """Replace NULLs with a scalar in the given columns (all columns by
        default; columns whose type cannot hold the value are left as-is).
        Reference: dataframe/mod.rs fill_null."""
        target = set(c.lower() for c in columns) if columns else None
        exprs = []
        for f in self.schema():
            if target is not None and f.name.lower() not in target:
                exprs.append(E.Column(f.name, f.qualifier))
                continue
            lit_e = self._to_expr(value) if isinstance(value, E.Expr) \
                else E.lit(value)
            try:
                compat = lit_e.data_type(self.schema()).is_numeric == \
                    f.dtype.is_numeric
            except Exception:
                compat = False
            if not compat and target is None:
                exprs.append(E.Column(f.name, f.qualifier))
                continue
            exprs.append(E.Alias(
                E.ScalarFunction("coalesce",
                                 (E.Column(f.name, f.qualifier), lit_e)),
                f.name))
        return self._with(L.Projection(exprs, self.plan))

    def cache(self) -> "DataFrame":
        """Materialize into an in-memory table (reference: cache())."""
        from ..datasource.memory import MemTable
        batch = self.collect_batch()
        provider = MemTable(batch.schema, [[batch]])
        return DataFrame(self.session, L.TableScan("__cache", provider))

    def describe(self) -> "DataFrame":
        """Summary statistics per column, values rendered as strings
        (reference: dataframe/mod.rs describe: count, null_count, mean,
        std, min, max, median)."""
        import numpy as np
        from ..datasource.memory import MemTable
        batch = self.collect_batch()
        stats = ["count", "null_count", "mean", "std", "min", "max", "median"]
        data = {"describe": np.array(stats, object)}
        for i, f in enumerate(batch.schema.fields):
            c = batch.column(i)
            v = c.validity_host()
            n = batch.num_rows
            nulls = int((~v).sum()) if v is not None else 0
            vals = [str(n), str(nulls)]
            if f.dtype.is_numeric:
                pyv = [x for x in c.to_pylist(n) if x is not None]
                arr = np.array([float(x) for x in pyv], np.float64)
                if len(arr):
                    vals += [str(arr.mean()), str(arr.std(ddof=1))
                             if len(arr) > 1 else "0.0",
                             str(arr.min()), str(arr.max()),
                             str(float(np.median(arr)))]
                else:
                    vals += [None] * 5
            elif f.dtype.is_string:
                pyv = [x for x in c.to_pylist(n) if x is not None]
                vals += [None, None,
                         min(pyv) if pyv else None,
                         max(pyv) if pyv else None, None]
            else:
                pyv = [x for x in c.to_pylist(n) if x is not None]
                vals += [None, None,
                         str(min(pyv)) if pyv else None,
                         str(max(pyv)) if pyv else None, None]
            data[f.name] = np.array(vals, object)
        provider = MemTable.from_arrays(data)
        return DataFrame(self.session, L.TableScan("__describe", provider))

    def union(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Union([self.plan, other.plan]))

    def union_distinct(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Distinct(L.Union([self.plan, other.plan])))

    def intersect(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Intersect(self.plan, other.plan))

    def except_(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.Except(self.plan, other.plan))

    def join(self, right: "DataFrame", left_cols: Sequence[str],
             right_cols: Sequence[str], how: str = "inner") -> "DataFrame":
        jt = {"inner": "INNER", "left": "LEFT", "right": "RIGHT",
              "full": "FULL", "outer": "FULL", "semi": "LEFTSEMI",
              "leftsemi": "LEFTSEMI", "anti": "LEFTANTI",
              "leftanti": "LEFTANTI"}.get(how.lower())
        if jt is None:
            raise PlanError(f"unknown join type {how}")
        on = [(E.Column(l), E.Column(r)) for l, r in zip(left_cols, right_cols)]
        return self._with(L.Join(self.plan, right.plan, on, None, jt))

    def join_on(self, right: "DataFrame", predicate, how: str = "inner") -> "DataFrame":
        jt = how.upper() if how.upper() in ("INNER", "LEFT", "RIGHT", "FULL") else "INNER"
        return self._with(L.Join(self.plan, right.plan, [],
                                 self._to_expr(predicate), jt))

    def cross_join(self, right: "DataFrame") -> "DataFrame":
        return self._with(L.CrossJoin(self.plan, right.plan))

    def with_column(self, name: str, expr) -> "DataFrame":
        schema = self.plan.schema
        exprs: List[E.Expr] = []
        replaced = False
        for f in schema.fields:
            if f.name == name:
                exprs.append(E.Alias(self._to_expr(expr), name))
                replaced = True
            else:
                exprs.append(E.Column(f.name, f.qualifier))
        if not replaced:
            exprs.append(E.Alias(self._to_expr(expr), name))
        return self._with(L.Projection(exprs, self.plan))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        exprs = []
        for f in self.plan.schema.fields:
            c = E.Column(f.name, f.qualifier)
            exprs.append(E.Alias(c, new) if f.name == old else c)
        return self._with(L.Projection(exprs, self.plan))

    def drop_columns(self, *names: str) -> "DataFrame":
        exprs = [E.Column(f.name, f.qualifier)
                 for f in self.plan.schema.fields if f.name not in names]
        return self._with(L.Projection(exprs, self.plan))

    def window(self, window_exprs: Sequence) -> "DataFrame":
        return self._with(L.Window([self._to_expr(e) for e in window_exprs],
                                   self.plan))

    def unnest_columns(self, *names: str) -> "DataFrame":
        plan = self.plan
        for name in names:
            f = plan.schema.field_by_name(name)
            plan = L.Unnest(plan, E.Column(f.name, f.qualifier))
        return self._with(plan)

    def repartition(self, n: int) -> "DataFrame":
        return self  # partitioning is a physical concern; placeholder API

    # ---- writes -------------------------------------------------------------
    def write_parquet(self, path: str) -> int:
        return self.write_file(path, "parquet")

    def write_csv(self, path: str, with_header: bool = True) -> int:
        # the Python API keeps the pandas-like header default; SQL COPY TO
        # follows the reference's config-driven default (no header)
        return self.write_file(path, "csv",
                               options={"format.has_header": with_header})

    def write_json(self, path: str) -> int:
        return self.write_file(path, "json")

    def write_file(self, path: str, fmt: str, options=None) -> int:
        options = options or {}
        batch = self.collect_batch()
        from ..datasource.arrow_convert import batch_to_arrow
        tbl = batch_to_arrow(batch)
        if fmt == "parquet":
            import pyarrow.parquet as pq
            kw = {}
            try:
                if bool(self.session.config.options.get(
                        "datafusion.execution.parquet.bloom_filter_on_write")):
                    kw["bloom_filter_options"] = {
                        c: True for c in tbl.column_names}
            except Exception:  # noqa: BLE001
                pass
            # page index makes our own outputs page-prunable on re-scan
            pq.write_table(tbl, path, write_page_index=True, **kw)
        elif fmt == "csv":
            import pyarrow.csv as pcsv
            # header default follows the read side: CsvOptions.has_header
            # is None -> datafusion.catalog.has_header (config.rs:186,
            # default false), so COPY TO csv writes no header unless asked
            opt = options.get("format.has_header", options.get("has_header"))
            if opt is not None:
                header = str(opt).lower() != "false"
            else:
                header = bool(self.session.config.options.get(
                    "datafusion.catalog.has_header"))
            delim = str(options.get("format.delimiter", ","))
            pcsv.write_csv(tbl, path, pcsv.WriteOptions(
                include_header=header, delimiter=delim))
        elif fmt == "json":
            with open(path, "w") as fh:
                import json
                for row in tbl.to_pylist():
                    fh.write(json.dumps(row, default=str) + "\n")
        elif fmt == "orc":
            import pyarrow.orc as porc
            porc.write_table(tbl, path)
        elif fmt == "avro":
            from ..datasource.avro import arrow_to_avro
            arrow_to_avro(tbl, path)
        else:
            raise PlanError(f"unsupported write format {fmt}")
        return batch.num_rows

    # ---- internals -------------------------------------------------------------
    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(self.session, plan)

    def _with_count(self, n: int) -> "DataFrame":
        import numpy as np
        from ..datasource.memory import MemTable
        t = MemTable.from_arrays({"count": np.array([n], dtype=np.int64)})
        return DataFrame(self.session, L.TableScan("result", t))

    def _to_expr(self, e) -> E.Expr:
        if isinstance(e, E.Expr):
            return e
        if isinstance(e, str):
            # parse a SQL expression fragment
            from ..sql.parser import parse_sql
            stmts = parse_sql(f"SELECT {e}")
            sel = stmts[0].query.body
            from ..sql.planner import PlannerContext, SqlToRel
            rel = SqlToRel(self.session)
            ctx = PlannerContext()
            item = sel.projection[0]
            out = rel.expr_to_expr(item.expr, self.plan.schema, ctx)
            if getattr(item, "alias", None):
                out = E.Alias(out, item.alias)
            return out
        raise PlanError(f"cannot convert {e!r} to an expression")


def _fmt(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)
