"""SessionContext — the top-level entry point.

Reference parity: `SessionContext` / `SessionState`
(`datafusion/core/src/execution/context/mod.rs:457`,
`session_state.rs:524-790`): owns the catalog, config, function registry
and the planning pipeline  SQL -> LogicalPlan -> optimize -> physical plan.
DDL statements (CREATE/DROP/INSERT/SET/SHOW) are intercepted here, exactly
like `execute_logical_plan` (`context/mod.rs:531`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import dt
from ..common.batch import Batch
from ..common.column import DeviceColumnCache
from ..common.config import ConfigOptions
from ..common.errors import ExecutionError, PlanError
from ..common.schema import Field, Schema
from ..datasource.memory import MemTable
from ..datasource.provider import TableProvider
from ..expr import plan as L
from ..optimizer import Optimizer
from ..physical.plan.device_join_chain import ChainCaches
from ..physical.planner import PhysicalPlanner
from ..runtime import RuntimeEnv, TaskContext
from ..sql import ast as A
from ..sql.parser import parse_sql
from ..sql.planner import SqlToRel, sql_type_to_datatype
from ..catalog import CatalogProvider, FlatCatalog, MemorySchemaProvider
from .dataframe import DataFrame


_COLUMNS_VIEW_FIELDS = (
    # (name, is uint64) — InformationSchemaColumns::new
    # (information_schema.rs:436-452)
    ("table_catalog", False), ("table_schema", False),
    ("table_name", False), ("column_name", False),
    ("ordinal_position", True), ("column_default", False),
    ("is_nullable", False), ("data_type", False),
    ("character_maximum_length", True), ("character_octet_length", True),
    ("numeric_precision", True), ("numeric_precision_radix", True),
    ("numeric_scale", True), ("datetime_precision", True),
    ("interval_type", False),
)


def _column_meta_row(cat: str, sch: str, tbl: str, f: Field, pos: int):
    """One information_schema.columns row; the octet-length and
    precision/radix/scale rules mirror the reference's add_column
    (information_schema.rs:540-625, incl. Int64 falling through to NULL)."""
    s = str(f.dtype)
    octet = {"Utf8": 2147483647, "Binary": 2147483647,
             "LargeUtf8": 9223372036854775807,
             "LargeBinary": 9223372036854775807}.get(s)
    prec = radix = scale = None
    int_prec = {"Int8": 8, "UInt8": 8, "Int16": 16, "UInt16": 16,
                "Int32": 32, "UInt32": 32, "Float16": 15,
                "Float32": 24, "Float64": 24}
    if s in int_prec:
        prec, radix = int_prec[s], 2
    elif s.startswith("Decimal"):
        inner = s[s.index("(") + 1:s.index(")")]
        p_, sc_ = (x.strip() for x in inner.split(","))
        prec, radix, scale = int(p_), 10, int(sc_)
    return (cat, sch, tbl, f.name, pos, None,
            "YES" if f.nullable else "NO", s,
            None, octet, prec, radix, scale, None, None)


def _columns_meta_table(rows) -> MemTable:
    from ..common.column import Column
    cols, fields = [], []
    for j, (name, is_u64) in enumerate(_COLUMNS_VIEW_FIELDS):
        vals = [r[j] for r in rows]
        if is_u64:
            data = np.array([0 if v is None else v for v in vals], np.uint64)
            mask = np.array([v is not None for v in vals], bool)
            c = Column.from_numpy(data, dt.UINT64,
                                  None if mask.all() else mask)
        else:
            c = Column.from_numpy(np.array(vals, object))
        cols.append(c)
        fields.append(Field(name, c.dtype, nullable=c.has_nulls))
    return MemTable(Schema(fields), [[Batch(Schema(fields), cols)]])


class SessionConfig:
    def __init__(self, options: Optional[ConfigOptions] = None):
        self.options = options or ConfigOptions()

    def set(self, key: str, value) -> "SessionConfig":
        self.options.set(key, value)
        return self

    def with_batch_size(self, n: int) -> "SessionConfig":
        return self.set("datafusion.execution.batch_size", n)

    def with_target_partitions(self, n: int) -> "SessionConfig":
        return self.set("datafusion.execution.target_partitions", n)


class SessionContext:
    """The session of the port: SQL parse, logical optimizer, catalog and
    host operators, with the port's physical planner, whose device rules
    run aggregates and join chains through the port's CUDA kernels.

    The device is required and explicit. `torch.device("cuda")` on a
    machine without CUDA raises: nothing carries on on the CPU unasked.
    With `torch.device("cpu")` the port runs each kernel's plain PyTorch
    version, which is how the tests hold it against the JAX package.

    `mesh` (a `parallel.LocalMesh` or `parallel.ProcessGroupMesh`) is the
    mesh that `SET datafusion.tpu.mesh_devices = N` and the automatic mesh
    run on when it has N shards; without it the session makes a LocalMesh
    of N shards on its device."""

    def __init__(self, device, config: Optional[SessionConfig] = None,
                 runtime: Optional[RuntimeEnv] = None, mesh=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but "
                               "torch.cuda.is_available() is false")
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.mesh = mesh
        # device copies of registered tables' columns, dropped with the
        # cached plans on any catalog or data change
        self.device_cache = DeviceColumnCache()
        # the join chain's staged tables, words and records across queries,
        # dropped with them
        self.chain_caches = ChainCaches()
        self.config = config or SessionConfig()
        self.runtime = runtime or RuntimeEnv()
        # Catalog hierarchy (reference: CatalogProvider list in
        # SessionState, context/mod.rs register_catalog). Each value
        # implements the CatalogProvider protocol; session-owned ones are
        # FlatCatalogs (see catalog.py).
        self.catalogs: Dict[str, CatalogProvider] = {"datafusion": FlatCatalog()}
        # VarProviders (reference: variable/mod.rs VarType::{UserDefined,
        # System}); each provider: get_value(List[str]) -> ScalarValue
        self.variable_providers: Dict[str, object] = {}
        self.table_functions: Dict[str, object] = {}
        self.prepared: Dict[str, A.Statement] = {}
        self.optimizer = Optimizer()
        self.planner = PhysicalPlanner(self.config.options, device,
                                       self.device_cache, mesh,
                                       self.chain_caches)
        # physical-plan cache per SQL text (reference contrast: DataFusion
        # replans in single-digit ms; our planning+fusion passes cost more,
        # and warm TPC-H queries repeat the same text). Invalidated by
        # bumping the generation on any catalog/config mutation.
        from collections import OrderedDict as _OD
        self._plan_generation = 0
        self._physical_cache: "dict" = _OD()

    # ---- catalog hierarchy ------------------------------------------------
    @property
    def tables(self) -> Dict[str, TableProvider]:
        """Flat table store of the current default catalog (round-1 API;
        lives inside the FlatCatalog now)."""
        cat = self._current_catalog()
        if not isinstance(cat, FlatCatalog):
            raise PlanError(
                f"default catalog '{self._default_names()[0]}' is a custom "
                "CatalogProvider with no flat table store")
        return cat.flat

    @property
    def schemas(self):
        cat = self._current_catalog()
        return cat.schema_set if isinstance(cat, FlatCatalog) \
            else set(cat.schema_names())

    def _default_names(self):
        opts = self.config.options
        return (str(opts.get("datafusion.catalog.default_catalog")
                    or "datafusion").lower(),
                str(opts.get("datafusion.catalog.default_schema")
                    or "public").lower())

    def _current_catalog(self) -> CatalogProvider:
        dc = self._default_names()[0]
        cat = self.catalogs.get(dc)
        if cat is None:
            raise PlanError(f"default catalog '{dc}' not found; "
                            "CREATE DATABASE it or register_catalog first")
        return cat

    def register_catalog(self, name: str,
                         provider: CatalogProvider) -> Optional[CatalogProvider]:
        """Register a CatalogProvider under `name`, returning any previous
        one (reference: SessionContext::register_catalog)."""
        self._bump_plan_generation()
        prev = self.catalogs.get(name.lower())
        self.catalogs[name.lower()] = provider
        return prev

    def catalog(self, name: str = "datafusion") -> Optional[CatalogProvider]:
        return self.catalogs.get(name.lower())

    def _split_name(self, name: str):
        """name -> (catalog, schema-or-None, table) with the session
        default catalog applied (reference resolution order,
        session_state.rs resolve_table_references)."""
        # case-sensitive: the parser already lowercased unquoted idents
        # (reference normalization); quoted idents keep their case
        parts = name.split(".")
        dc, _ds = self._default_names()
        if len(parts) >= 3:
            return parts[0], parts[1], ".".join(parts[2:])
        if len(parts) == 2:
            return dc, parts[0], parts[1]
        return dc, None, parts[0]

    # ---- provider interface for SqlToRel ---------------------------------
    def get_table(self, name: str) -> TableProvider:
        cat_name, schema_name, tbl = self._split_name(name)
        # errors name the fully-resolved table (reference:
        # session_state.rs "table 'cat.schema.name' not found")
        qname = f"{cat_name}.{schema_name or self._default_names()[1]}.{tbl}"
        if schema_name == "information_schema":
            if not bool(self.config.options.get(
                    "datafusion.catalog.information_schema")):
                # reference wording: the virtual schema simply doesn't exist
                raise PlanError(
                    f"table '{cat_name}.information_schema.{tbl}' not found")
            return self._information_schema_table(tbl)
        cat = self.catalogs.get(cat_name)
        if cat is None:
            raise PlanError(f"table '{qname}' not found")
        ds = self._default_names()[1]
        if isinstance(cat, FlatCatalog):
            flat = cat.flat
            if schema_name is None:
                # unqualified names resolve strictly in the default schema
                # (reference: resolve_table_references uses the session
                # default_catalog.default_schema, no fallback)
                tries = [tbl] if ds == "public" else [f"{ds}.{tbl}"]
            elif schema_name in ("public", ds):
                tries = [f"{schema_name}.{tbl}", tbl]
            else:
                tries = [f"{schema_name}.{tbl}"]
            for key in tries:
                if key in flat:
                    return flat[key]
            sp = cat.external.get(schema_name or ds)
            if sp is not None:
                t = sp.table(tbl)
                if t is not None:
                    return t
            raise PlanError(f"table '{qname}' not found")
        sp = cat.schema(schema_name or ds)
        t = sp.table(tbl) if sp is not None else None
        if t is None:
            raise PlanError(f"table '{qname}' not found")
        return t

    def _all_tables(self):
        """Enumerate (catalog, schema, table_name, provider) across every
        registered catalog through the provider protocol."""
        out = []
        for cname in sorted(self.catalogs):
            cat = self.catalogs[cname]
            if isinstance(cat, FlatCatalog):
                for k in sorted(cat.flat):
                    s, t = k.rsplit(".", 1) if "." in k else ("public", k)
                    out.append((cname, s, t, cat.flat[k]))
                for sname in sorted(cat.external):
                    sp = cat.external[sname]
                    for t in sorted(sp.table_names()):
                        out.append((cname, sname, t, sp.table(t)))
            else:
                for sname in sorted(cat.schema_names()):
                    sp = cat.schema(sname)
                    if sp is None:
                        continue
                    for t in sorted(sp.table_names()):
                        out.append((cname, sname, t, sp.table(t)))
        return out

    _META_VIEWS = ("columns", "df_settings", "schemata", "tables", "views")

    def _information_schema_table(self, which: str) -> TableProvider:
        """Virtual information_schema tables, built on demand over ALL
        catalogs (reference: core/src/catalog/information_schema.rs:46-62)."""
        if which == "tables":
            rows = self._all_tables()
            cat_col, sch_col, name_col, type_col = [], [], [], []
            for c, s, t, p in rows:
                cat_col.append(c)
                sch_col.append(s)
                name_col.append(t)
                type_col.append(
                    "VIEW" if p is not None and p.logical_plan() is not None
                    else "BASE TABLE")
            # the information_schema views themselves, per catalog
            # (information_schema.rs lists them as VIEWs)
            for c in sorted(self.catalogs):
                for v in self._META_VIEWS:
                    cat_col.append(c)
                    sch_col.append("information_schema")
                    name_col.append(v)
                    type_col.append("VIEW")
            return MemTable.from_arrays({
                "table_catalog": np.array(cat_col, object),
                "table_schema": np.array(sch_col, object),
                "table_name": np.array(name_col, object),
                "table_type": np.array(type_col, object),
            })
        if which == "views":
            rows = [(c, s, t, p) for c, s, t, p in self._all_tables()
                    if p is not None and p.logical_plan() is not None]
            defs = []
            for _, _, _, p in rows:
                try:
                    from ..sql.unparser import plan_to_sql
                    defs.append(plan_to_sql(p.logical_plan()))
                except Exception:  # noqa: BLE001 — unparser gaps render NULL
                    defs.append(None)
            return MemTable.from_arrays({
                "table_catalog": np.array([c for c, _, _, _ in rows], object),
                "table_schema": np.array([s for _, s, _, _ in rows], object),
                "table_name": np.array([t for _, _, t, _ in rows], object),
                "definition": np.array(defs, object),
            })
        if which == "columns":
            rows = []
            for c, sname, tname, p in self._all_tables():
                if p is None:
                    continue
                for i, f in enumerate(p.schema()):
                    rows.append(_column_meta_row(c, sname, tname, f, i))
            return _columns_meta_table(rows)
        if which == "df_settings":
            items = self.config.options.entries()

            def fmt(v):
                if isinstance(v, bool):
                    return "true" if v else "false"
                return None if v is None else str(v)
            return MemTable.from_arrays({
                "name": np.array([k for k, _, _ in items], object),
                "value": np.array([fmt(v) for _, v, _ in items], object),
                "description": np.array([d for _, _, d in items], object),
            })
        if which == "schemata":
            # declared schemas plus any implicit ones from qualified names,
            # across every catalog; the virtual information_schema itself is
            # excluded (information_schema.rs:128). Columns mirror
            # InformationSchemata::new (information_schema.rs:652-660).
            cat_col, sch_col = [], []
            for cname in sorted(self.catalogs):
                for s in self.catalogs[cname].schema_names():
                    if s == "information_schema":
                        continue
                    cat_col.append(cname)
                    sch_col.append(s)
            nulls = np.array([None] * len(cat_col), object)
            return MemTable.from_arrays({
                "catalog_name": np.array(cat_col, object),
                "schema_name": np.array(sch_col, object),
                "schema_owner": nulls,
                "default_character_set_catalog": nulls,
                "default_character_set_schema": nulls,
                "default_character_set_name": nulls,
                "sql_path": nulls,
            })
        raise PlanError(f"information_schema.{which} not found")

    # ---- UDF registration ---------------------------------------------------
    # ---- variables ----------------------------------------------------------
    def register_variable_provider(self, var_type: str, provider) -> None:
        """var_type: "user" (@x) or "system" (@@x); provider must expose
        get_value(var_names: List[str]) -> ScalarValue
        (reference: variable/mod.rs VarProvider)."""
        self._bump_plan_generation()
        assert var_type in ("user", "system")
        self.variable_providers[var_type] = provider

    def get_variable(self, name: str):
        from ..common.scalar import ScalarValue
        kind = "system" if name.startswith("@@") else "user"
        bare = name.lstrip("@")
        p = self.variable_providers.get(kind)
        if p is None:
            if kind == "system" and bare.lower() == "version":
                from .. import __version__
                return ScalarValue.string(f"datafusion-tpu {__version__}")
            raise PlanError(f"no {kind} variable provider for '{name}'")
        return p.get_value([bare])

    def register_udf(self, name: str, fn, input_types, return_type,
                     volatility: str = "immutable") -> None:
        """Register a vectorized scalar UDF (reference: udf.rs:56).
        `fn(*numpy_arrays) -> numpy array`."""
        self._bump_plan_generation()
        from ..functions.udf import ScalarUDF, register_scalar_udf
        register_scalar_udf(ScalarUDF(name, fn, list(input_types),
                                      return_type, volatility))

    def register_udaf(self, name: str, accumulator_factory, input_types,
                      return_type) -> None:
        """Register an aggregate UDF (reference: udaf.rs:69). The factory
        returns an object implementing the GroupsAccumulator protocol."""
        from ..functions.udf import AggregateUDF, register_aggregate_udf
        register_aggregate_udf(AggregateUDF(name, accumulator_factory,
                                            list(input_types), return_type))

    def register_udwf(self, name: str, evaluator, input_types,
                      return_type) -> None:
        """Register a window UDF (reference: udwf.rs). `evaluator(args,
        part_start, part_end) -> np.ndarray` operates in partition-sorted
        row order."""
        from ..functions.udf import WindowUDF, register_window_udf
        register_window_udf(WindowUDF(name, evaluator, list(input_types),
                                      return_type))

    def register_udtf(self, name: str, fn) -> None:
        """Register a table function: fn(*args) -> TableProvider
        (reference: core/src/datasource/function.rs)."""
        self.table_functions[name.lower()] = fn

    def get_table_function(self, name: str):
        return self.table_functions.get(name)

    # ---- registration ------------------------------------------------------
    def register_table(self, name: str, table: TableProvider) -> None:
        self._bump_plan_generation()
        cat_name, schema_name, tbl = self._split_name(name)
        cat = self.catalogs.get(cat_name)
        if cat is None:
            raise PlanError(f"catalog '{cat_name}' not found")
        ds = self._default_names()[1]
        if isinstance(cat, FlatCatalog):
            if schema_name is None:
                key = tbl if ds == "public" else f"{ds}.{tbl}"
            elif schema_name == "public":
                key = tbl
            else:
                key = f"{schema_name}.{tbl}"
            cat.flat[key] = table
            return
        sp = cat.schema(schema_name or ds)
        if sp is None:
            raise PlanError(f"schema '{schema_name or ds}' not found "
                            f"in catalog '{cat_name}'")
        sp.register_table(tbl, table)

    def deregister_table(self, name: str) -> None:
        self._bump_plan_generation()
        cat_name, schema_name, tbl = self._split_name(name)
        cat = self.catalogs.get(cat_name)
        if cat is None:
            return
        ds = self._default_names()[1]
        if isinstance(cat, FlatCatalog):
            keys = ([tbl, f"{ds}.{tbl}", f"public.{tbl}"]
                    if schema_name is None else
                    [f"{schema_name}.{tbl}"]
                    + ([tbl] if schema_name in ("public", ds) else []))
            for key in keys:
                cat.flat.pop(key, None)
            return
        sp = cat.schema(schema_name or ds)
        if sp is not None:
            sp.deregister_table(tbl)

    def register_parquet(self, name: str, path: str) -> None:
        from ..datasource.file import ParquetTable
        self.register_table(name, ParquetTable(
            path, registry=self.runtime.object_store_registry,
            cache=self.runtime.cache_manager))

    def register_csv(self, name: str, path: str, has_header: bool = True,
                     delimiter: str = ",", schema: Optional[Schema] = None,
                     unbounded: bool = False, with_order=None) -> None:
        from ..datasource.file import CsvTable
        self.register_table(name, CsvTable(
            path, has_header, delimiter, schema,
            registry=self.runtime.object_store_registry,
            cache=self.runtime.cache_manager,
            unbounded=unbounded, with_order=with_order))

    def register_json(self, name: str, path: str) -> None:
        from ..datasource.file import JsonTable
        self.register_table(name, JsonTable(
            path, registry=self.runtime.object_store_registry,
            cache=self.runtime.cache_manager))

    def register_orc(self, name: str, path: str) -> None:
        from ..datasource.file import OrcTable
        self.register_table(name, OrcTable(
            path, registry=self.runtime.object_store_registry,
            cache=self.runtime.cache_manager))

    def register_avro(self, name: str, path: str) -> None:
        from ..datasource.file import AvroTable
        self.register_table(name, AvroTable(
            path, registry=self.runtime.object_store_registry,
            cache=self.runtime.cache_manager))

    def register_object_store(self, scheme: str, store) -> None:
        """Attach an ObjectStore for a URL scheme (reference:
        RuntimeEnv::register_object_store)."""
        self.runtime.object_store_registry.register_store(scheme, store)

    def register_record_batches(self, name: str, batches: List[Batch]) -> None:
        self.register_table(name, MemTable.from_batches(batches))

    def register_arrays(self, name: str, named: dict) -> None:
        self.register_table(name, MemTable.from_arrays(named, qualifier=None))

    def from_pandas(self, df, name: Optional[str] = None) -> DataFrame:
        t = MemTable.from_pandas(df)
        if name:
            self.register_table(name, t)
        plan = L.TableScan(name or "?memtable", t)
        return DataFrame(self, plan)

    def table(self, name: str) -> DataFrame:
        t = self.get_table(name)
        if t.logical_plan() is not None:
            return DataFrame(self, t.logical_plan())
        return DataFrame(self, L.TableScan(name.lower(), t))

    def read_parquet(self, path: str) -> DataFrame:
        from ..datasource.file import ParquetTable
        t = ParquetTable(path)
        import os
        name = os.path.splitext(os.path.basename(path.rstrip("/")))[0] or "parquet"
        return DataFrame(self, L.TableScan(name, t))

    def read_csv(self, path: str, **kw) -> DataFrame:
        from ..datasource.file import CsvTable
        t = CsvTable(path, **kw)
        import os
        name = os.path.splitext(os.path.basename(path.rstrip("/")))[0] or "csv"
        return DataFrame(self, L.TableScan(name, t))

    # ---- SQL -------------------------------------------------------------
    # functions whose plan-time constant folding must not be frozen by
    # the physical-plan cache
    _VOLATILE_MARKERS = ("now", "current_date", "current_time",
                         "current_timestamp", "random", "uuid", "@")

    def sql(self, sql: str, params: Optional[List] = None) -> DataFrame:
        from ..physical.scalar_functions import begin_statement_clock
        begin_statement_clock()   # now()-family agrees within a statement
        stmts = parse_sql(sql)
        out: Optional[DataFrame] = None
        for stmt in stmts:
            out = self._execute_statement(stmt, params)
        if out is None:
            out = self._message_df("result", [])
        if len(stmts) == 1 and params is None and \
                type(stmts[0]) is A.QueryStatement:
            low = sql.lower()
            if not any(k in low for k in self._VOLATILE_MARKERS):
                out._cache_key = (sql, self._plan_generation)
        return out

    def _bump_plan_generation(self) -> None:
        self._plan_generation += 1
        self._physical_cache.clear()
        self.device_cache.clear()
        self.chain_caches.clear()

    # statement kinds that cannot invalidate cached plans
    _READONLY_STMTS = (A.QueryStatement, A.Explain, A.ShowVariable,
                       A.ShowTables, A.ShowColumns, A.Describe,
                       A.ShowCreateTable)

    def _execute_statement(self, stmt: A.Statement,
                           params: Optional[List] = None) -> DataFrame:
        if not isinstance(stmt, self._READONLY_STMTS):
            # DDL/DML/SET (or anything else mutating) invalidates plans
            self._bump_plan_generation()
        if isinstance(stmt, (A.QueryStatement, A.Explain)):
            into = getattr(getattr(stmt, "query", None), "body", None)
            into = getattr(into, "into", None)
            if into:
                # SELECT ... INTO t == CREATE TABLE t AS SELECT ...
                body = stmt.query.body
                body.into = None
                return self._create_table(A.CreateTable(into, query=stmt.query))
            rel = SqlToRel(self)
            plan = rel.statement_to_plan(stmt)
            return DataFrame(self, plan)

        if isinstance(stmt, A.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, A.CreateView):
            from ..datasource.view import ViewTable
            rel = SqlToRel(self)
            plan = rel.query_to_plan(stmt.query, _pctx())
            self.register_table(".".join(stmt.name),
                                ViewTable(plan, stmt.definition))
            return self._message_df("created_view", [])
        if isinstance(stmt, A.CreateDatabase):
            name = ".".join(stmt.name).lower()
            if name in self.catalogs:
                if stmt.if_not_exists:
                    return self._message_df("exists", [])
                raise PlanError(f"database '{name}' already exists")
            self.catalogs[name] = FlatCatalog()
            return self._message_df("created_database", [])
        if isinstance(stmt, A.CreateSchema):
            parts = [p.lower() for p in stmt.name]
            # CREATE SCHEMA my_catalog.my_schema routes to that catalog
            # (reference: information_schema_multiple_catalogs.slt); an
            # unknown 2-part catalog is an error like the reference, not a
            # dotted schema name in the default catalog
            if len(parts) == 2:
                if parts[0] not in self.catalogs:
                    raise PlanError(
                        f"Error during planning: failed to resolve catalog: "
                        f"{parts[0]}")
                cat, name = self.catalogs[parts[0]], parts[1]
            else:
                cat, name = self._current_catalog(), ".".join(parts)
            if isinstance(cat, FlatCatalog):
                if name in cat.schema_set and not stmt.if_not_exists:
                    raise PlanError(f"schema '{name}' already exists")
                cat.schema_set.add(name)
            else:
                cat.register_schema(name, MemorySchemaProvider())
            return self._message_df("created_schema", [])
        if isinstance(stmt, A.Drop):
            if stmt.kind == "DATABASE":
                name = ".".join(stmt.name).lower()
                if name not in self.catalogs and not stmt.if_exists:
                    raise PlanError(f"database '{name}' not found")
                if name == self._default_names()[0]:
                    raise PlanError("cannot drop the default catalog")
                self.catalogs.pop(name, None)
                return self._message_df("dropped", [])
            if stmt.kind == "SCHEMA":
                parts = [p.lower() for p in stmt.name]
                if len(parts) == 2 and parts[0] in self.catalogs:
                    cat, name = self.catalogs[parts[0]], parts[1]
                else:
                    cat, name = self._current_catalog(), ".".join(parts)
                if isinstance(cat, FlatCatalog):
                    owned = [t for t in cat.flat if t.startswith(name + ".")]
                    if owned:
                        # reference wording (context/mod.rs drop_schema)
                        deps = ", ".join(
                            t[len(name) + 1:] for t in sorted(owned))
                        raise ExecutionError(
                            f"Cannot drop schema {name} because other "
                            f"tables depend on it: {deps}")
                    if name in cat.external:
                        # externally registered SchemaProviders drop through
                        # the provider protocol (ADVICE r2: register_schema
                        # stores them in cat.external)
                        cat.external.pop(name)
                    elif name not in cat.schema_set and not stmt.if_exists:
                        raise PlanError(f"schema '{name}' not found")
                    cat.schema_set.discard(name)
                else:
                    cat.deregister_schema(name)
                return self._message_df("dropped", [])
            key = ".".join(stmt.name).lower()
            try:
                self.get_table(key)
            except PlanError:
                if stmt.if_exists:
                    return self._message_df("dropped", [])
                # reference: "Execution error: Table 't' doesn't exist."
                raise ExecutionError(f"Table '{key}' doesn't exist.")
            self.deregister_table(".".join(stmt.name))
            return self._message_df("dropped", [])
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.SetVariable):
            key = stmt.name
            if key.lower() in ("timezone", "time_zone", "time.zone"):
                # postgres-style SET TIMEZONE (reference maps it to
                # datafusion.execution.time_zone)
                key = "datafusion.execution.time_zone"
            if not key.startswith("datafusion."):
                key = f"datafusion.{key}"
            try:
                self.config.options.set(key, stmt.value)
            except Exception:  # noqa: BLE001 — unknown keys ignored like the reference's extensions
                pass
            return self._message_df("set", [])
        if isinstance(stmt, A.ShowCreateTable):
            name = ".".join(stmt.table)
            t = self.get_table(name)
            cat_name, schema_name, tbl = self._split_name(name)
            schema_name = schema_name or self._default_names()[1]
            d = getattr(t, "definition", None) or \
                getattr(t, "_definition", None) or None
            return self._string_table([
                ("table_catalog", [cat_name]),
                ("table_schema", [schema_name]),
                ("table_name", [tbl]),
                ("definition", [d]),
            ])
        if isinstance(stmt, A.ShowVariable):
            self._require_information_schema("SHOW [VARIABLE]")
            return self._show_variable(stmt.name,
                                       getattr(stmt, "verbose", False))
        if isinstance(stmt, A.ShowTables):
            self._require_information_schema("SHOW TABLES")
            # SHOW TABLES is a view over information_schema.tables
            # (reference: statement.rs show_tables_to_plan)
            t = self._information_schema_table("tables")
            return DataFrame(self, L.TableScan("tables", t))
        if isinstance(stmt, (A.ShowColumns, A.Describe)):
            if isinstance(stmt, A.ShowColumns):
                self._require_information_schema("SHOW COLUMNS")
                if stmt.filtered:
                    raise PlanError(
                        "SHOW COLUMNS with WHERE or LIKE is not supported")
            name = ".".join(stmt.table)
            t = self.get_table(name)
            s = t.schema()
            if isinstance(stmt, A.Describe):
                return self._string_table([
                    ("column_name", [f.name for f in s]),
                    ("data_type", [str(f.dtype) for f in s]),
                    ("is_nullable",
                     ["YES" if f.nullable else "NO" for f in s]),
                ])
            # SHOW COLUMNS resolves through information_schema.columns
            # (reference: statement.rs show_columns_to_plan)
            cat_name, schema_name, tbl = self._split_name(name)
            schema_name = schema_name or self._default_names()[1]
            rows = [_column_meta_row(cat_name, schema_name, tbl, f, i)
                    for i, f in enumerate(s)]
            if stmt.full:
                meta = _columns_meta_table(rows)
                return DataFrame(self, L.TableScan("columns", meta))
            return self._string_table([
                ("table_catalog", [r[0] for r in rows]),
                ("table_schema", [r[1] for r in rows]),
                ("table_name", [r[2] for r in rows]),
                ("column_name", [r[3] for r in rows]),
                ("data_type", [r[7] for r in rows]),
                ("is_nullable", [r[6] for r in rows]),
            ])
        if isinstance(stmt, A.Prepare):
            if stmt.name.lower() in self.prepared:
                # reference: a second PREPARE under the same name errors
                # (sql/src/statement.rs plan_prepare)
                raise PlanError(
                    f"Prepared statement '{stmt.name}' already exists")
            if stmt.data_types:
                # declared parameter list must cover every $N placeholder
                max_ph = [0]

                def walk_params(node):
                    if isinstance(node, A.Param):
                        max_ph[0] = max(max_ph[0], node.index)
                    if hasattr(node, "__dataclass_fields__"):
                        for f2 in node.__dataclass_fields__:
                            v2 = getattr(node, f2)
                            for item in (v2 if isinstance(v2, (list, tuple))
                                         else [v2]):
                                if hasattr(item, "__dataclass_fields__"):
                                    walk_params(item)

                walk_params(stmt.statement)
                if max_ph[0] > len(stmt.data_types):
                    raise PlanError(
                        f"Prepare specifies {len(stmt.data_types)} data "
                        f"types but query has {max_ph[0]} parameters")
            # reference plans EAGERLY at PREPARE time (plan_prepare):
            # unknown tables/columns error here, not at EXECUTE. Dry-run
            # the planner with NULL-bound placeholders.
            import dataclasses as _dc

            def null_params(node):
                if isinstance(node, A.Param):
                    return A.NullLit()
                if not hasattr(node, "__dataclass_fields__"):
                    return node
                changes = {}
                for f2 in node.__dataclass_fields__:
                    v2 = getattr(node, f2)
                    if isinstance(v2, (list, tuple)):
                        nv = type(v2)(null_params(x) for x in v2)
                        if nv != v2:
                            changes[f2] = nv
                    elif hasattr(v2, "__dataclass_fields__"):
                        nv = null_params(v2)
                        if nv is not v2:
                            changes[f2] = nv
                return _dc.replace(node, **changes) if changes else node

            try:
                rel = SqlToRel(self)
                rel.statement_to_plan(null_params(stmt.statement))
            except PlanError:
                raise
            except Exception:  # noqa: BLE001
                pass   # non-planning issues stay lazy
            self.prepared[stmt.name.lower()] = stmt.statement
            return self._message_df("prepared", [])
        if isinstance(stmt, A.ExecutePrepared):
            inner = self.prepared.get(stmt.name.lower())
            if inner is None:
                raise PlanError(f"prepared statement '{stmt.name}' not found")
            stmt2 = _bind_params(inner, stmt.params)
            return self._execute_statement(stmt2)
        if isinstance(stmt, A.Deallocate):
            self.prepared.pop(stmt.name.lower(), None)
            return self._message_df("deallocated", [])
        if isinstance(stmt, A.CopyTo):
            return self._copy_to(stmt)
        raise PlanError(f"unsupported statement {type(stmt).__name__}")

    # ---- DDL helpers ---------------------------------------------------------
    def _create_table(self, stmt: A.CreateTable) -> DataFrame:
        name = ".".join(stmt.name).lower()
        try:
            self.get_table(name)
            exists = True
        except PlanError:
            exists = False
        if exists and stmt.if_not_exists:
            return self._message_df("exists", [])
        if exists and not stmt.or_replace:
            raise PlanError(f"table '{name}' already exists")
        if stmt.external:
            fmt = (stmt.file_format or "parquet").lower()
            if fmt == "parquet":
                self.register_parquet(name, stmt.location)
            elif fmt == "csv":
                schema = self._columns_schema(stmt.columns) if stmt.columns else None
                # header inference defaults ON (reference:
                # datafusion.catalog.has_header, config.rs default true);
                # override via WITH HEADER ROW or
                # OPTIONS('format.has_header' 'false')
                header = stmt.with_header
                if header is None:
                    opt = stmt.options.get("format.has_header",
                                           stmt.options.get("has_header"))
                    header = (str(opt).lower() != "false") if opt is not None \
                        else bool(self.config.options.get(
                            "datafusion.catalog.has_header"))
                self.register_csv(name, stmt.location,
                                  has_header=header,
                                  delimiter=stmt.delimiter or ",",
                                  schema=schema,
                                  unbounded=stmt.unbounded,
                                  with_order=stmt.options.get("with_order"))
            elif fmt == "json":
                self.register_json(name, stmt.location)
            elif fmt == "orc":
                self.register_orc(name, stmt.location)
            elif fmt == "avro":
                self.register_avro(name, stmt.location)
            else:
                raise PlanError(f"unsupported external format {fmt}")
            try:
                # SHOW CREATE TABLE echoes this (reference: ListingTable
                # definition from CREATE EXTERNAL TABLE text)
                self.get_table(name)._definition = (
                    f"CREATE EXTERNAL TABLE {name} STORED AS "
                    f"{fmt.upper()} LOCATION {stmt.location}")
            except Exception:  # noqa: BLE001 — providers may forbid attrs
                pass
            return self._message_df("created", [])
        if stmt.query is not None:   # CREATE TABLE AS
            rel = SqlToRel(self)
            plan = rel.query_to_plan(stmt.query, _pctx())
            df = DataFrame(self, plan)
            batch = df.collect_batch()
            if stmt.columns:
                # CREATE TABLE t (c1 BIGINT, ...) AS VALUES ...: the column
                # defs rename and cast the query output positionally
                # (reference: sql/statement.rs CreateTable w/ columns)
                from ..physical import kernels as K
                schema = self._columns_schema(stmt.columns)
                if len(schema.fields) != batch.num_columns:
                    raise PlanError(
                        f"CREATE TABLE column count {len(schema.fields)} "
                        f"!= query column count {batch.num_columns}")
                cols = []
                for f, c in zip(schema.fields, batch.columns):
                    if c.dtype != f.dtype and not (
                            c.dtype.is_string and f.dtype.is_string):
                        c = K.cast_column(c, f.dtype)
                    cols.append(c)
                from ..common.batch import Batch
                batch = Batch(schema, cols, batch.num_rows)
            self.register_table(name, MemTable(batch.schema, [[batch]]))
            return self._message_df("created", [])
        schema = self._columns_schema(stmt.columns)
        self.register_table(name, MemTable(schema, [[]]))
        return self._message_df("created", [])

    def _columns_schema(self, columns: List[A.ColumnDef]) -> Schema:
        fields = []
        for c in columns:
            # parser already lowercases unquoted idents; quoted keep case
            fields.append(Field(c.name,
                                sql_type_to_datatype(c.type_name, c.type_args,
                                                     self.config.options),
                                # PRIMARY KEY implies NOT NULL; UNIQUE doesn't
                                c.nullable and not c.primary_key,
                                primary_key=c.primary_key
                                or getattr(c, "unique", False)))
        return Schema(fields)

    def _insert(self, stmt: A.Insert) -> DataFrame:
        t = self.get_table(".".join(stmt.table))
        rel = SqlToRel(self)
        plan = rel.query_to_plan(stmt.query, _pctx())
        df = DataFrame(self, plan)
        batch = df.collect_batch()
        # align to the table schema (by position, casting as needed)
        tschema = t.schema()
        from ..physical import kernels as K
        cols = []
        names = list(stmt.columns) if stmt.columns else [f.name for f in tschema]
        by_name = {n: i for i, n in enumerate(names)}
        for f in tschema:
            if f.name in by_name:
                c = batch.columns[by_name[f.name]]
                if c.dtype != f.dtype and not (c.dtype.is_string and f.dtype.is_string):
                    c = K.cast_column(c, f.dtype)
            else:
                from ..common.scalar import ScalarValue
                c = K.broadcast_scalar(ScalarValue(f.dtype, None), batch.num_rows)
            cols.append(c)
        aligned = Batch(tschema, cols, batch.num_rows)
        n = t.insert_into([aligned])
        return self._string_table([("count", [])])._with_count(n)

    def _copy_to(self, stmt: A.CopyTo) -> DataFrame:
        rel = SqlToRel(self)
        plan = rel.query_to_plan(stmt.query, _pctx())
        df = DataFrame(self, plan)
        fmt = (stmt.file_format or "parquet").lower()
        if stmt.target.endswith(".csv"):
            fmt = "csv" if stmt.file_format is None else fmt
        if stmt.target.endswith(".json"):
            fmt = "json" if stmt.file_format is None else fmt
        if stmt.target.endswith(".orc"):
            fmt = "orc" if stmt.file_format is None else fmt
        if stmt.target.endswith(".avro"):
            fmt = "avro" if stmt.file_format is None else fmt
        import os
        parent = os.path.dirname(stmt.target)
        if parent and not os.path.exists(parent):
            os.makedirs(parent, exist_ok=True)
        n = df.write_file(stmt.target, fmt, options=stmt.options)
        return self._string_table([("count", [])])._with_count(n)

    def _require_information_schema(self, what: str) -> None:
        """SHOW statements are views over information_schema (reference:
        sql/src/statement.rs show_* planning errors when disabled)."""
        if not bool(self.config.options.get(
                "datafusion.catalog.information_schema")):
            raise PlanError(f"{what} is not supported unless "
                            "information_schema is enabled")

    def _show_variable(self, name: str, verbose: bool = False) -> DataFrame:
        opts = self.config.options
        def _fmt(v):
            # match the reference's config display: true/false, NULL
            if isinstance(v, bool):
                return "true" if v else "false"
            if v is None:
                return "NULL"
            return str(v)
        if name.upper() == "ALL":
            items = opts.entries()
            cols = [
                ("name", [k for k, _, _ in items]),
                ("value", [_fmt(v) for _, v, _ in items]),
            ]
            if verbose:
                cols.append(("description", [d for _, _, d in items]))
            return self._string_table(cols)
        key = name if name.startswith("datafusion.") else f"datafusion.{name}"
        try:
            v = opts.get(key)
        except Exception:  # noqa: BLE001
            # unknown variables show an EMPTY result (reference:
            # information_schema.slt SHOW VERBOSE -> 0 rows)
            cols = [("name", []), ("value", [])]
            if verbose:
                cols.append(("description", []))
            return self._string_table(cols)
        cols = [("name", [key]), ("value", [_fmt(v)])]
        if verbose:
            cols.append(("description",
                         [dict((k, d) for k, _, d in opts.entries())
                          .get(key, "")]))
        return self._string_table(cols)

    # ---- misc ----------------------------------------------------------------
    def _message_df(self, label: str, rows: List[str]) -> DataFrame:
        return self._string_table([(label, rows)])

    def _string_table(self, cols) -> DataFrame:
        named = {}
        n = max((len(v) for _, v in cols), default=0)
        for name, vals in cols:
            named[name] = np.array(list(vals) + [""] * (n - len(vals)),
                                   dtype=object)
        if not named:
            named = {"result": np.array([], dtype=object)}
        t = MemTable.from_arrays(named)
        return DataFrame(self, L.TableScan("result", t))

    def task_context(self) -> TaskContext:
        return TaskContext(self.config.options, self.runtime)

    def state(self):
        return self


def _pctx():
    from ..sql.planner import PlannerContext
    return PlannerContext()


def _bind_params(stmt: A.Statement, params: List[A.Node]) -> A.Statement:
    """Substitute $1.. placeholders in a prepared statement's AST."""
    import dataclasses

    def walk(node):
        if isinstance(node, A.Param):
            idx = node.index - 1
            if idx < 0 or idx >= len(params):
                raise PlanError(f"missing parameter ${node.index}")
            return params[idx]
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                nv = _walk_value(v)
                if nv is not v:
                    changes[f.name] = nv
            if changes:
                return dataclasses.replace(node, **changes)
        return node

    def _walk_value(v):
        if isinstance(v, A.Node):
            return walk(v)
        if isinstance(v, list):
            return [_walk_value(x) for x in v]
        if isinstance(v, tuple):
            return tuple(_walk_value(x) for x in v)
        return v

    return walk(stmt)
