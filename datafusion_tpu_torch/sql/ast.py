"""SQL abstract syntax tree.

Covers the reference's SQL surface (SURVEY.md §2.7): SELECT with CTEs,
joins, grouping sets, window functions, subqueries, set operations, DDL
(CREATE [EXTERNAL] TABLE / VIEW / SCHEMA), DML (INSERT, COPY TO), utility
statements (EXPLAIN, SHOW, SET, DESCRIBE).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------


class Node:
    pass


@dataclasses.dataclass
class Identifier(Node):
    parts: List[str]          # e.g. ["l", "extendedprice"]

    def __str__(self):
        return ".".join(self.parts)


@dataclasses.dataclass
class Variable(Node):
    """@user_var / @@system_var (reference: VarType + VarProvider)."""
    name: str                 # includes the @ / @@ prefix

    def __str__(self):
        return self.name


@dataclasses.dataclass
class Wildcard(Node):
    qualifier: Optional[str] = None   # t.* has qualifier "t"
    except_cols: Tuple[str, ...] = ()
    replace_cols: Tuple[Tuple[str, "Node"], ...] = ()  # * REPLACE (e AS c)


@dataclasses.dataclass
class NumberLit(Node):
    text: str                 # keep original text: exact decimal vs float


@dataclasses.dataclass
class StringLit(Node):
    value: str


@dataclasses.dataclass
class BoolLit(Node):
    value: bool


@dataclasses.dataclass
class NullLit(Node):
    pass


@dataclasses.dataclass
class TypedString(Node):
    """DATE '1994-01-01', TIMESTAMP '...', INTERVAL handled separately."""
    type_name: str
    value: str


@dataclasses.dataclass
class IntervalLit(Node):
    value: str                # e.g. "3 month" or "1"
    leading_unit: Optional[str] = None   # INTERVAL '1' YEAR


@dataclasses.dataclass
class Param(Node):
    index: int


@dataclasses.dataclass
class BinaryOp(Node):
    op: str                   # '+', '-', '*', '/', '%', '=', '<', 'AND', 'OR', '||', ...
    left: Node
    right: Node


@dataclasses.dataclass
class UnaryOp(Node):
    op: str                   # '-', '+', 'NOT'
    operand: Node


@dataclasses.dataclass
class IsNull(Node):
    operand: Node
    negated: bool = False


@dataclasses.dataclass
class IsBool(Node):
    """IS [NOT] TRUE/FALSE/UNKNOWN"""
    operand: Node
    value: Optional[bool]     # None = UNKNOWN
    negated: bool = False


@dataclasses.dataclass
class IsDistinctFrom(Node):
    left: Node
    right: Node
    negated: bool = False


@dataclasses.dataclass
class Between(Node):
    operand: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass
class InList(Node):
    operand: Node
    items: List[Node]
    negated: bool = False


@dataclasses.dataclass
class InSubquery(Node):
    operand: Node
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class ScalarSubquery(Node):
    query: "Query"


@dataclasses.dataclass
class Like(Node):
    operand: Node
    pattern: Node
    negated: bool = False
    case_insensitive: bool = False   # ILIKE
    escape: Optional[str] = None


@dataclasses.dataclass
class SimilarTo(Node):
    operand: Node
    pattern: Node
    negated: bool = False


@dataclasses.dataclass
class Cast(Node):
    operand: Node
    type_name: str            # raw type text, e.g. "DECIMAL(15,2)"
    type_args: Tuple[int, ...] = ()
    safe: bool = False        # TRY_CAST


@dataclasses.dataclass
class Case(Node):
    operand: Optional[Node]   # CASE x WHEN ... vs CASE WHEN ...
    whens: List[Tuple[Node, Node]]
    else_: Optional[Node]


@dataclasses.dataclass
class WindowFrameBound(Node):
    kind: str                 # 'UNBOUNDED_PRECEDING','PRECEDING','CURRENT','FOLLOWING','UNBOUNDED_FOLLOWING'
    offset: Optional[Node] = None


@dataclasses.dataclass
class WindowSpec(Node):
    partition_by: List[Node] = dataclasses.field(default_factory=list)
    order_by: List["OrderByItem"] = dataclasses.field(default_factory=list)
    frame_units: Optional[str] = None   # 'ROWS' | 'RANGE' | 'GROUPS'
    frame_start: Optional[WindowFrameBound] = None
    frame_end: Optional[WindowFrameBound] = None


@dataclasses.dataclass
class FunctionCall(Node):
    name: str                 # lower-cased function name
    args: List[Node]
    distinct: bool = False
    over: Optional[WindowSpec] = None
    filter: Optional[Node] = None
    order_by: List["OrderByItem"] = dataclasses.field(default_factory=list)  # agg ORDER BY
    star: bool = False        # count(*)
    ignore_nulls: bool = False  # first_value(x) IGNORE NULLS


@dataclasses.dataclass
class Extract(Node):
    field: str                # YEAR/MONTH/...
    operand: Node


@dataclasses.dataclass
class Substring(Node):
    operand: Node
    start: Optional[Node]
    length: Optional[Node]


@dataclasses.dataclass
class Trim(Node):
    operand: Node
    chars: Optional[Node]
    where: str = "BOTH"       # BOTH | LEADING | TRAILING


@dataclasses.dataclass
class Position(Node):
    substr: Node
    string: Node


@dataclasses.dataclass
class Tuple_(Node):
    items: List[Node]


@dataclasses.dataclass
class ArrayLit(Node):
    items: List[Node]


@dataclasses.dataclass
class ArrayIndex(Node):
    operand: Node
    index: Node


@dataclasses.dataclass
class AliasedTable(Node):
    """`(join ...) AS alias` — alias applied to a parenthesized table ref."""
    inner: Node
    alias: str
    col_aliases: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# query structure
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OrderByItem(Node):
    expr: Node
    asc: bool = True
    nulls_first: Optional[bool] = None   # default: nulls last for ASC, first for DESC (DataFusion: nulls last default asc? see planner)


@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass
class TableRef(Node):
    pass


@dataclasses.dataclass
class TableName(TableRef):
    parts: List[str]
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@dataclasses.dataclass
class SubqueryRef(TableRef):
    query: "Query"
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()
    lateral: bool = False


@dataclasses.dataclass
class TableFunctionRef(TableRef):
    name: str
    args: List[Node]
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@dataclasses.dataclass
class Join(TableRef):
    left: TableRef
    right: TableRef
    kind: str                 # INNER/LEFT/RIGHT/FULL/CROSS/LEFT SEMI/...
    on: Optional[Node] = None
    using: Tuple[str, ...] = ()
    natural: bool = False


@dataclasses.dataclass
class GroupBy(Node):
    exprs: List[Node] = dataclasses.field(default_factory=list)
    grouping_sets: Optional[List[List[Node]]] = None
    rollup: Optional[List[Node]] = None
    cube: Optional[List[Node]] = None
    all_: bool = False        # GROUP BY ALL


@dataclasses.dataclass
class Select(Node):
    projection: List[SelectItem]
    from_: Optional[TableRef]
    where: Optional[Node] = None
    group_by: Optional[GroupBy] = None
    having: Optional[Node] = None
    qualify: Optional[Node] = None
    distinct: bool = False
    distinct_on: List[Node] = dataclasses.field(default_factory=list)
    named_windows: dict = dataclasses.field(default_factory=dict)
    into: Optional[List[str]] = None     # SELECT ... INTO t


@dataclasses.dataclass
class SetOp(Node):
    op: str                   # UNION / EXCEPT / INTERSECT
    all: bool
    left: Node                # Select | SetOp | Values | Query
    right: Node


@dataclasses.dataclass
class Values(Node):
    rows: List[List[Node]]


@dataclasses.dataclass
class Cte(Node):
    name: str
    query: "Query"
    column_aliases: Tuple[str, ...] = ()


@dataclasses.dataclass
class Query(Node):
    body: Node                # Select | SetOp | Values
    ctes: List[Cte] = dataclasses.field(default_factory=list)
    recursive: bool = False
    order_by: List[OrderByItem] = dataclasses.field(default_factory=list)
    limit: Optional[Node] = None
    offset: Optional[Node] = None


# --------------------------------------------------------------------------
# statements
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Statement(Node):
    pass


@dataclasses.dataclass
class QueryStatement(Statement):
    query: Query


@dataclasses.dataclass
class ColumnDef(Node):
    name: str
    type_name: str
    type_args: Tuple[int, ...] = ()
    nullable: bool = True
    primary_key: bool = False
    unique: bool = False


@dataclasses.dataclass
class CreateTable(Statement):
    name: List[str]
    columns: List[ColumnDef] = dataclasses.field(default_factory=list)
    query: Optional[Query] = None        # CREATE TABLE AS
    external: bool = False
    file_format: Optional[str] = None    # PARQUET/CSV/JSON
    location: Optional[str] = None
    if_not_exists: bool = False
    or_replace: bool = False
    options: dict = dataclasses.field(default_factory=dict)
    partitioned_by: Tuple[str, ...] = ()
    with_header: Optional[bool] = None   # None -> catalog default (True)
    delimiter: Optional[str] = None
    unbounded: bool = False              # CREATE UNBOUNDED EXTERNAL TABLE


@dataclasses.dataclass
class CreateView(Statement):
    name: List[str]
    query: Query
    or_replace: bool = False
    definition: str = ""      # original CREATE VIEW text (SHOW CREATE TABLE)


@dataclasses.dataclass
class CreateSchema(Statement):
    name: List[str]
    if_not_exists: bool = False


@dataclasses.dataclass
class CreateDatabase(Statement):
    """CREATE DATABASE <name> — a new catalog (reference:
    sql/statement.rs CreateCatalog)."""
    name: List[str]
    if_not_exists: bool = False


@dataclasses.dataclass
class Drop(Statement):
    kind: str                 # TABLE / VIEW / SCHEMA
    name: List[str]
    if_exists: bool = False


@dataclasses.dataclass
class Insert(Statement):
    table: List[str]
    columns: Tuple[str, ...] = ()
    query: Optional[Query] = None


@dataclasses.dataclass
class CopyTo(Statement):
    query: Query
    target: str
    file_format: Optional[str] = None
    options: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    verbose: bool = False
    format: str = "indent"        # indent | tree | graphviz | pgjson


@dataclasses.dataclass
class ShowTables(Statement):
    pass


@dataclasses.dataclass
class ShowColumns(Statement):
    table: List[str]
    full: bool = False        # SHOW FULL/EXTENDED COLUMNS: all 15 columns
    filtered: bool = False    # trailing LIKE/WHERE (unsupported, plan error)


@dataclasses.dataclass
class ShowCreateTable(Statement):
    table: List[str]


@dataclasses.dataclass
class ShowVariable(Statement):
    name: str                 # 'ALL' or a config key
    verbose: bool = False     # SHOW ... VERBOSE adds the description column


@dataclasses.dataclass
class SetVariable(Statement):
    name: str
    value: Any


@dataclasses.dataclass
class Describe(Statement):
    table: List[str]


@dataclasses.dataclass
class Prepare(Statement):
    name: str
    data_types: List[str]
    statement: Statement


@dataclasses.dataclass
class ExecutePrepared(Statement):
    name: str
    params: List[Node]


@dataclasses.dataclass
class Deallocate(Statement):
    name: str
