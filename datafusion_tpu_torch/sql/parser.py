"""SQL parser: token stream -> AST.

A hand-written Pratt (precedence-climbing) parser covering the reference's
SQL surface (SURVEY.md §2.7). Plays the role of sqlparser-rs + the DDL
extensions in `datafusion/sql/src/parser.rs:97-299` (CREATE EXTERNAL TABLE,
COPY TO).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..common.errors import ParserError
from . import ast as A
from .tokenizer import Tok, Token, tokenize

# keywords that terminate an expression / cannot start an alias
_RESERVED = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION",
    "EXCEPT", "INTERSECT", "JOIN", "ON", "USING", "INNER", "LEFT", "RIGHT",
    "FULL", "CROSS", "NATURAL", "AS", "AND", "OR", "NOT", "SELECT", "WHEN",
    "THEN", "ELSE", "END", "CASE", "ASC", "DESC", "NULLS", "BY", "INTO",
    "VALUES", "SET", "WITH", "WINDOW", "QUALIFY", "PARTITION", "ROWS",
    "RANGE", "GROUPS", "FETCH", "SEMI", "ANTI", "OUTER", "LATERAL", "TO",
    "FILTER", "OVER", "DISTINCT", "ALL", "RETURNING", "FOR", "DISTRIBUTE",
    "SORT", "CLUSTER",
}

_CMP_OPS = {"=", "<", ">", "<=", ">=", "<>", "!=", "<=>"}

# binding powers
_BP = {
    "OR": 5, "AND": 10,
    "IS": 17,
    "=": 20, "<": 20, ">": 20, "<=": 20, ">=": 20, "<>": 20, "!=": 20, "<=>": 20,
    "BETWEEN": 20, "IN": 20, "LIKE": 20, "ILIKE": 20, "SIMILAR": 20, "NOT": 20,
    "~": 20, "~*": 20, "!~": 20, "!~*": 20,
    "~~": 20, "~~*": 20, "!~~": 20, "!~~*": 20,
    "||": 30,
    # bitwise precedence mirrors sqlparser-rs get_next_precedence: Pipe(21)
    # < Caret=Sharp=ShiftLeft=ShiftRight(22, left-assoc) < Ampersand(23),
    # so `d ^ 7 >> 4` parses ((d ^ 7) >> 4)
    "|": 32, "#": 33, "^": 33, "<<": 33, ">>": 33, "&": 34,
    "+": 40, "-": 40,
    "*": 50, "/": 50, "%": 50,
    "::": 70, "[": 70,
    "AT": 18,
}

_INTERVAL_UNITS = {
    "YEAR", "YEARS", "MONTH", "MONTHS", "DAY", "DAYS", "HOUR", "HOURS",
    "MINUTE", "MINUTES", "SECOND", "SECONDS", "WEEK", "WEEKS",
    "MILLISECOND", "MILLISECONDS", "MICROSECOND", "MICROSECONDS", "NANOSECOND",
    "NANOSECONDS",
}

# unit keywords after the quoted literal that are part of the interval
# type (sqlparser-rs): singular only for year..second/week — their plural
# forms become column aliases (`interval '5' years` = 5s AS "years") —
# but both forms for the sub-second units
_INTERVAL_SUFFIX_UNITS = {
    "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "WEEK",
    "MILLISECOND", "MILLISECONDS", "MICROSECOND", "MICROSECONDS",
    "NANOSECOND", "NANOSECONDS", "CENTURY", "DECADE",
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # ---- token helpers -----------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != Tok.EOF:
            self.i += 1
        return t

    def at_word(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == Tok.WORD and t.value in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == Tok.OP and t.value in ops

    def eat_word(self, *words: str) -> bool:
        if self.at_word(*words):
            self.next()
            return True
        return False

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_word(self, word: str) -> Token:
        if not self.at_word(word):
            raise ParserError(f"expected {word}, found {self.peek()} at pos {self.peek().pos}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise ParserError(f"expected '{op}', found {self.peek()} at pos {self.peek().pos}")
        return self.next()

    def ident(self) -> str:
        t = self.peek()
        if t.kind == Tok.IDENT:
            self.next()
            return t.value
        if t.kind == Tok.WORD:
            self.next()
            return t.raw.lower()
        raise ParserError(f"expected identifier, found {t} at pos {t.pos}")

    def object_name(self) -> List[str]:
        parts = [self.ident()]
        while self.eat_op("."):
            parts.append(self.ident())
        return parts

    # ======================================================================
    # statements
    # ======================================================================
    def parse_statements(self) -> List[A.Statement]:
        stmts = []
        while self.peek().kind != Tok.EOF:
            stmts.append(self.parse_statement())
            while self.eat_op(";"):
                pass
        return stmts

    def parse_statement(self) -> A.Statement:
        t = self.peek()
        if t.kind != Tok.WORD:
            if self.at_op("("):
                return A.QueryStatement(self.parse_query())
            raise ParserError(f"expected statement, found {t}")
        w = t.value
        if w in ("SELECT", "WITH", "VALUES"):
            return A.QueryStatement(self.parse_query())
        if w == "CREATE":
            return self.parse_create()
        if w == "DROP":
            return self.parse_drop()
        if w == "INSERT":
            return self.parse_insert()
        if w == "EXPLAIN":
            self.next()
            analyze = self.eat_word("ANALYZE")
            verbose = self.eat_word("VERBOSE")
            if not analyze:
                analyze = self.eat_word("ANALYZE")
            fmt = "indent"
            if self.eat_word("FORMAT"):
                fmt = self.ident().lower()
            return A.Explain(self.parse_statement(), analyze=analyze,
                             verbose=verbose, format=fmt)
        if w == "SHOW":
            self.next()
            if self.eat_word("TABLES"):
                return A.ShowTables()
            if self.at_word("CREATE") and self.peek(1).kind == Tok.WORD and \
                    self.peek(1).value == "TABLE":
                self.next()
                self.next()
                return A.ShowCreateTable(self.object_name())
            full = False
            if self.at_word("FULL", "EXTENDED") and \
                    self.peek(1).kind == Tok.WORD and \
                    self.peek(1).value == "COLUMNS":
                self.next()
                full = True
            if self.eat_word("COLUMNS"):
                self.eat_word("FROM") or self.eat_word("IN")
                tbl = self.object_name()
                filtered = self.at_word("LIKE", "WHERE")
                if filtered:
                    # swallow the rest of the statement; the planner
                    # rejects it (reference: statement.rs show_columns)
                    while self.peek().kind != Tok.EOF and not self.at_op(";"):
                        self.next()
                return A.ShowColumns(tbl, full=full, filtered=filtered)
            if self.eat_word("ALL"):
                return A.ShowVariable("ALL", self.eat_word("VERBOSE"))
            if self.at_word("TIME") and self.peek(1).kind == Tok.WORD and \
                    self.peek(1).value == "ZONE":
                self.next(); self.next()
                return A.ShowVariable("datafusion.execution.time_zone",
                                      self.eat_word("VERBOSE"))
            name = ".".join(self.object_name())
            if name.lower() in ("timezone", "time.zone"):
                name = "datafusion.execution.time_zone"
            return A.ShowVariable(name, self.eat_word("VERBOSE"))
        if w == "SET":
            self.next()
            if self.at_word("TIME") and self.peek(1).kind == Tok.WORD and \
                    self.peek(1).value == "ZONE":
                self.next()
                self.next()
                self.eat_op("=") or self.eat_word("TO")
                t = self.next()
                val = t.value if t.kind == Tok.STRING else t.raw
                return A.SetVariable("datafusion.execution.time_zone", val)
            name = ".".join(self.object_name())
            if not self.eat_op("="):
                self.expect_word("TO")
            t = self.next()
            val = t.value if t.kind in (Tok.STRING, Tok.NUMBER) else t.raw
            return A.SetVariable(name, val)
        if w in ("DESCRIBE", "DESC"):
            self.next()
            return A.Describe(self.object_name())
        if w == "COPY":
            return self.parse_copy()
        if w == "PREPARE":
            self.next()
            name = self.ident()
            dts = []
            if self.eat_op("("):
                while not self.eat_op(")"):
                    dts.append(self.parse_type_name()[0])
                    self.eat_op(",")
            self.expect_word("AS")
            return A.Prepare(name, dts, self.parse_statement())
        if w == "EXECUTE":
            self.next()
            name = self.ident()
            params = []
            if self.eat_op("("):
                while not self.eat_op(")"):
                    params.append(self.parse_expr())
                    self.eat_op(",")
            return A.ExecutePrepared(name, params)
        if w == "DEALLOCATE":
            self.next()
            self.eat_word("PREPARE")
            return A.Deallocate(self.ident())
        raise ParserError(f"unsupported statement starting with {t.raw!r}")

    def parse_create(self) -> A.Statement:
        self.expect_word("CREATE")
        or_replace = False
        if self.eat_word("OR"):
            self.expect_word("REPLACE")
            or_replace = True
        unbounded = self.eat_word("UNBOUNDED")
        external = self.eat_word("EXTERNAL")
        if self.eat_word("TABLE"):
            ine = self._if_not_exists()
            name = self.object_name()
            columns: List[A.ColumnDef] = []
            if self.at_op("(") :
                self.next()
                while not self.eat_op(")"):
                    if self.eat_word("PRIMARY"):
                        # table-level constraint: primary key(col, ...)
                        self.expect_word("KEY")
                        self.expect_op("(")
                        while not self.eat_op(")"):
                            pk_col = self.ident()
                            for cd in columns:
                                if cd.name == pk_col:
                                    cd.primary_key = True
                            self.eat_op(",")
                        self.eat_op(",")
                        continue
                    if self.eat_word("UNIQUE"):
                        self.expect_op("(")
                        while not self.eat_op(")"):
                            uq_col = self.ident()
                            for cd in columns:
                                if cd.name == uq_col:
                                    cd.unique = True
                            self.eat_op(",")
                        self.eat_op(",")
                        continue
                    cname = self.ident()
                    tname, targs = self.parse_type_name()
                    nullable, pk = True, False
                    while True:
                        if self.eat_word("NOT"):
                            self.expect_word("NULL")
                            nullable = False
                        elif self.eat_word("NULL"):
                            nullable = True
                        elif self.eat_word("PRIMARY"):
                            self.expect_word("KEY")
                            pk = True
                        else:
                            break
                    columns.append(A.ColumnDef(cname, tname, targs, nullable, pk))
                    self.eat_op(",")
            fmt, location, options, partitioned, header, delim = None, None, {}, (), None, None
            while True:
                if self.eat_word("STORED"):
                    self.expect_word("AS")
                    fmt = self.next().raw.upper()
                elif self.eat_word("WITH"):
                    if self.eat_word("HEADER"):
                        self.eat_word("ROW")
                        header = True
                    elif self.eat_word("ORDER"):
                        # WITH ORDER (col [ASC|DESC], ...) — accepted, recorded
                        self.expect_op("(")
                        order_cols = []
                        while not self.eat_op(")"):
                            oc = self.ident()
                            asc = True
                            if self.eat_word("DESC"):
                                asc = False
                            else:
                                self.eat_word("ASC")
                            if self.eat_word("NULLS"):
                                self.eat_word("FIRST") or self.eat_word("LAST")
                            order_cols.append((oc, asc))
                            self.eat_op(",")
                        options.setdefault("with_order", []).append(order_cols)
                elif self.eat_word("DELIMITER"):
                    delim = self.next().value
                elif self.eat_word("PARTITIONED"):
                    self.expect_word("BY")
                    self.expect_op("(")
                    parts = []
                    while not self.eat_op(")"):
                        parts.append(self.ident())
                        self.eat_op(",")
                    partitioned = tuple(parts)
                elif self.eat_word("LOCATION"):
                    location = self.next().value
                elif self.eat_word("OPTIONS"):
                    self.expect_op("(")
                    while not self.eat_op(")"):
                        k = self.next().value
                        v = self.next().value
                        options[k] = v
                        self.eat_op(",")
                else:
                    break
            query = None
            if self.eat_word("AS"):
                query = self.parse_query()
            return A.CreateTable(name, columns, query, external, fmt, location,
                                 ine, or_replace, options, partitioned, header,
                                 delim, unbounded)
        if self.eat_word("VIEW"):
            name = self.object_name()
            self.expect_word("AS")
            # keep the original query text: SHOW CREATE TABLE echoes the
            # definition verbatim (reference: ViewTable definition string)
            qstart = self.peek().pos
            q = self.parse_query()
            qtext = self.sql[qstart:self.peek().pos].strip()
            return A.CreateView(
                name, q, or_replace,
                definition=f"CREATE VIEW {'.'.join(name)} AS {qtext}")
        if self.eat_word("SCHEMA"):
            ine = self._if_not_exists()
            return A.CreateSchema(self.object_name(), ine)
        if self.eat_word("DATABASE") or self.eat_word("CATALOG"):
            ine = self._if_not_exists()
            return A.CreateDatabase(self.object_name(), ine)
        raise ParserError(f"unsupported CREATE {self.peek().raw!r}")

    def _if_not_exists(self) -> bool:
        if self.eat_word("IF"):
            self.expect_word("NOT")
            self.expect_word("EXISTS")
            return True
        return False

    def parse_drop(self) -> A.Statement:
        self.expect_word("DROP")
        kind = self.next().value   # TABLE / VIEW / SCHEMA
        if_exists = False
        if self.eat_word("IF"):
            self.expect_word("EXISTS")
            if_exists = True
        return A.Drop(kind, self.object_name(), if_exists)

    def parse_insert(self) -> A.Statement:
        self.expect_word("INSERT")
        self.expect_word("INTO")
        table = self.object_name()
        cols: Tuple[str, ...] = ()
        if self.at_op("(") and not self.at_word("SELECT"):
            # disambiguate column list vs subquery
            save = self.i
            self.next()
            try:
                names = [self.ident()]
                while self.eat_op(","):
                    names.append(self.ident())
                self.expect_op(")")
                cols = tuple(names)
            except ParserError:
                self.i = save
        return A.Insert(table, cols, self.parse_query())

    def parse_copy(self) -> A.Statement:
        self.expect_word("COPY")
        if self.eat_op("("):
            query = self.parse_query()
            self.expect_op(")")
        else:
            name = self.object_name()
            query = A.Query(body=A.Select(
                projection=[A.SelectItem(A.Wildcard())],
                from_=A.TableName(name)))
        self.expect_word("TO")
        target = self.next().value
        fmt, options = None, {}
        if self.eat_word("STORED"):
            self.expect_word("AS")
            fmt = self.next().raw.upper()
        if self.eat_word("OPTIONS"):
            self.expect_op("(")
            while not self.eat_op(")"):
                k = self.next().value
                v = self.next().value
                options[k] = v
                self.eat_op(",")
        return A.CopyTo(query, target, fmt, options)

    # ======================================================================
    # queries
    # ======================================================================
    def parse_query(self) -> A.Query:
        ctes: List[A.Cte] = []
        recursive = False
        if self.eat_word("WITH"):
            recursive = self.eat_word("RECURSIVE")
            while True:
                name = self.ident()
                col_aliases: Tuple[str, ...] = ()
                if self.eat_op("("):
                    names = []
                    while not self.eat_op(")"):
                        names.append(self.ident())
                        self.eat_op(",")
                    col_aliases = tuple(names)
                self.expect_word("AS")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append(A.Cte(name, q, col_aliases))
                if not self.eat_op(","):
                    break
        body = self.parse_set_expr()
        order_by: List[A.OrderByItem] = []
        limit = offset = None
        if self.eat_word("DISTRIBUTE"):
            # hive-style DISTRIBUTE BY: a repartition hint with no ordering
            # or content contract — parse and accept
            self.expect_word("BY")
            self.parse_expr()
            while self.eat_op(","):
                self.parse_expr()
        if self.eat_word("SORT"):
            # hive-style SORT BY: rejected like the reference
            # (sql/src/parser.rs routes it to not_impl_err "SORT BY")
            from ..common.errors import NotImplementedError_
            raise NotImplementedError_("SORT BY")
        if self.eat_word("ORDER"):
            self.expect_word("BY")
            order_by = self.parse_order_by_list()
        while True:
            if self.eat_word("LIMIT"):
                if self.eat_word("ALL"):
                    pass
                else:
                    limit = self.parse_expr()
            elif self.eat_word("OFFSET"):
                offset = self.parse_expr()
                self.eat_word("ROWS") or self.eat_word("ROW")
            elif self.eat_word("FETCH"):
                self.eat_word("FIRST") or self.eat_word("NEXT")
                limit = self.parse_expr()
                self.eat_word("ROWS") or self.eat_word("ROW")
                self.eat_word("ONLY")
            else:
                break
        return A.Query(body, ctes, recursive, order_by, limit, offset)

    def parse_order_by_list(self) -> List[A.OrderByItem]:
        items = []
        while True:
            e = self.parse_expr()
            asc = True
            if self.eat_word("ASC"):
                asc = True
            elif self.eat_word("DESC"):
                asc = False
            nulls_first = None
            if self.eat_word("NULLS"):
                if self.eat_word("FIRST"):
                    nulls_first = True
                else:
                    self.expect_word("LAST")
                    nulls_first = False
            items.append(A.OrderByItem(e, asc, nulls_first))
            if not self.eat_op(","):
                break
        return items

    def parse_set_expr(self) -> A.Node:
        left = self.parse_query_primary()
        while self.at_word("UNION", "EXCEPT", "INTERSECT"):
            op = self.next().value
            all_ = self.eat_word("ALL")
            if not all_:
                self.eat_word("DISTINCT")
            right = self.parse_query_primary()
            left = A.SetOp(op, all_, left, right)
        return left

    def parse_query_primary(self) -> A.Node:
        if self.eat_op("("):
            q = self.parse_query()
            self.expect_op(")")
            # inner query may itself carry order/limit; keep as nested Query
            return q
        if self.at_word("SELECT"):
            return self.parse_select()
        if self.eat_word("VALUES"):
            rows = []
            while True:
                self.eat_word("ROW")   # VALUES ROW(...) — MySQL spelling
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.eat_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.eat_op(","):
                    break
            return A.Values(rows)
        raise ParserError(f"expected SELECT/VALUES/(, found {self.peek()}")

    def parse_select(self) -> A.Select:
        self.expect_word("SELECT")
        distinct = False
        distinct_on: List[A.Node] = []
        if self.eat_word("DISTINCT"):
            distinct = True
            if self.eat_word("ON"):
                self.expect_op("(")
                while not self.eat_op(")"):
                    distinct_on.append(self.parse_expr())
                    self.eat_op(",")
                if not distinct_on:
                    # reference: sql/src/select.rs "No `ON` expressions
                    # provided" for SELECT DISTINCT ON ()
                    raise ParserError("No `ON` expressions provided")
        elif self.eat_word("ALL"):
            pass
        projection = [self.parse_select_item()]
        while self.eat_op(","):
            projection.append(self.parse_select_item())
        into = None
        if self.eat_word("INTO"):
            # SELECT ... INTO t — equivalent to CREATE TABLE t AS SELECT
            # (reference: sql/src/select.rs SelectInto)
            into = self.object_name()
        from_ = None
        if self.eat_word("FROM"):
            from_ = self.parse_table_refs()
        where = self.parse_expr() if self.eat_word("WHERE") else None
        group_by = None
        if self.eat_word("GROUP"):
            self.expect_word("BY")
            group_by = self.parse_group_by()
        having = self.parse_expr() if self.eat_word("HAVING") else None
        named_windows = {}
        if self.eat_word("WINDOW"):
            while True:
                wname = self.ident()
                self.expect_word("AS")
                self.expect_op("(")
                named_windows[wname] = self.parse_window_spec()
                self.expect_op(")")
                if not self.eat_op(","):
                    break
        qualify = self.parse_expr() if self.eat_word("QUALIFY") else None
        return A.Select(projection, from_, where, group_by, having, qualify,
                        distinct, distinct_on, named_windows, into)

    def parse_group_by(self) -> A.GroupBy:
        if self.eat_word("ALL"):
            return A.GroupBy(exprs=[], all_=True)
        # a comma-separated mix of plain exprs, ROLLUP(...), CUBE(...) and
        # GROUPING SETS(...); structured items combine by cross product
        # (reference: sql/src/select.rs + expr rollup/cube expansion)
        items: list = []   # ('e', node) | ('sets', List[List[node]])
        while True:
            if self.eat_word("GROUPING"):
                self.expect_word("SETS")
                self.expect_op("(")
                sets = []
                while not self.eat_op(")"):
                    self.expect_op("(")
                    s = []
                    while not self.eat_op(")"):
                        s.append(self.parse_expr())
                        self.eat_op(",")
                    sets.append(s)
                    self.eat_op(",")
                items.append(("sets", sets))
            elif self.eat_word("ROLLUP"):
                self.expect_op("(")
                exprs = []
                while not self.eat_op(")"):
                    exprs.append(self.parse_expr())
                    self.eat_op(",")
                # reference order: empty set first, then growing prefixes
                # (physical_planner.rs create_rollup_physical_expr)
                items.append(("sets", [exprs[:i]
                                       for i in range(0, len(exprs) + 1)]))
            elif self.eat_word("CUBE"):
                self.expect_op("(")
                exprs = []
                while not self.eat_op(")"):
                    exprs.append(self.parse_expr())
                    self.eat_op(",")
                sets = [[e for i, e in enumerate(exprs) if mask & (1 << i)]
                        for mask in range(1 << len(exprs))]
                items.append(("sets", list(reversed(sets))))
            else:
                items.append(("e", self.parse_expr()))
            if not self.eat_op(","):
                break
        if all(kind == "e" for kind, _ in items):
            return A.GroupBy(exprs=[v for _, v in items])
        combos: list = [[]]
        for kind, v in items:
            if kind == "e":
                combos = [c + [v] for c in combos]
            else:
                combos = [c + list(s) for c in combos for s in v]
        return A.GroupBy(grouping_sets=combos)

    def parse_select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Wildcard(except_cols=self._parse_exclude(),
                                           replace_cols=self._parse_replace()))
        # qualified wildcard t.*
        if self.peek().kind in (Tok.WORD, Tok.IDENT) and self.peek(1).kind == Tok.OP \
                and self.peek(1).value == "." and self.peek(2).value == "*" \
                and self.peek().value not in _RESERVED:
            q = self.ident()
            self.next()
            self.next()
            return A.SelectItem(A.Wildcard(qualifier=q,
                                           except_cols=self._parse_exclude(),
                                           replace_cols=self._parse_replace()))
        e = self.parse_expr()
        alias = None
        if self.eat_word("AS"):
            alias = self.ident()
        elif self.peek().kind == Tok.IDENT or \
                (self.peek().kind == Tok.WORD and self.peek().value not in _RESERVED):
            alias = self.ident()
        return A.SelectItem(e, alias)

    def _parse_replace(self) -> Tuple[Tuple[str, A.Node], ...]:
        """* REPLACE (expr AS col, ...) — substitute columns in a wildcard
        (reference: sqlparser ReplaceSelectItem)."""
        if not self.eat_word("REPLACE"):
            return ()
        self.expect_op("(")
        items = []
        while True:
            e = self.parse_expr()
            self.expect_word("AS")
            items.append((self.ident(), e))
            if not self.eat_op(","):
                break
        self.expect_op(")")
        return tuple(items)

    def _parse_exclude(self) -> Tuple[str, ...]:
        if self.eat_word("EXCLUDE") or self.eat_word("EXCEPT"):
            if self.eat_op("("):
                names = []
                while not self.eat_op(")"):
                    names.append(self.ident())
                    self.eat_op(",")
                return tuple(names)
            return (self.ident(),)
        return ()

    # ---- FROM clause ---------------------------------------------------------
    def parse_table_refs(self) -> A.TableRef:
        left = self.parse_table_with_joins()
        while self.eat_op(","):
            right = self.parse_table_with_joins()
            left = A.Join(left, right, "CROSS")
        return left

    def parse_table_with_joins(self) -> A.TableRef:
        left = self.parse_table_factor()
        while True:
            natural = self.eat_word("NATURAL")
            kind = None
            if self.eat_word("CROSS"):
                self.expect_word("JOIN")
                right = self.parse_table_factor()
                left = A.Join(left, right, "CROSS")
                continue
            if self.eat_word("INNER"):
                kind = "INNER"
                self.expect_word("JOIN")
            elif self.eat_word("LEFT"):
                if self.eat_word("SEMI"):
                    kind = "LEFTSEMI"
                elif self.eat_word("ANTI"):
                    kind = "LEFTANTI"
                else:
                    self.eat_word("OUTER")
                    kind = "LEFT"
                self.expect_word("JOIN")
            elif self.eat_word("RIGHT"):
                if self.eat_word("SEMI"):
                    kind = "RIGHTSEMI"
                elif self.eat_word("ANTI"):
                    kind = "RIGHTANTI"
                else:
                    self.eat_word("OUTER")
                    kind = "RIGHT"
                self.expect_word("JOIN")
            elif self.eat_word("FULL"):
                self.eat_word("OUTER")
                kind = "FULL"
                self.expect_word("JOIN")
            elif self.eat_word("JOIN"):
                kind = "INNER"
            else:
                if natural:
                    raise ParserError("NATURAL must be followed by a join")
                break
            right = self.parse_table_factor()
            on = None
            using: Tuple[str, ...] = ()
            if not natural:
                if self.eat_word("ON"):
                    on = self.parse_expr()
                elif self.eat_word("USING"):
                    self.expect_op("(")
                    names = []
                    while not self.eat_op(")"):
                        names.append(self.ident())
                        self.eat_op(",")
                    using = tuple(names)
            left = A.Join(left, right, kind, on, using, natural)
        return left

    def parse_table_factor(self) -> A.TableRef:
        lateral = self.eat_word("LATERAL")
        if self.at_word("VALUES") and (
                (self.peek(1).kind == Tok.OP and self.peek(1).value == "(")
                or (self.peek(1).kind == Tok.WORD
                    and self.peek(1).value == "ROW")):
            # bare FROM VALUES (...), (...) — an inline relation named
            # columnN (reference: sqlparser Table factor Derived w/ VALUES)
            self.next()
            rows = []
            while True:
                self.eat_word("ROW")
                self.expect_op("(")
                row = [self.parse_expr()]
                while self.eat_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                if not self.eat_op(","):
                    break
            alias, col_aliases = self.parse_alias()
            q = A.Query(A.Values(rows), [], False, [], None, None)
            return A.SubqueryRef(q, alias, col_aliases, lateral)
        if self.eat_op("("):
            # subquery or parenthesized joins
            if self.at_word("SELECT", "WITH", "VALUES") or self.at_op("("):
                save = self.i
                try:
                    q = self.parse_query()
                    self.expect_op(")")
                    alias, col_aliases = self.parse_alias()
                    return A.SubqueryRef(q, alias, col_aliases, lateral)
                except ParserError:
                    # e.g. ((SELECT ..) "T1" JOIN ..): a parenthesized join
                    # whose first factor is itself parenthesized
                    self.i = save
            inner = self.parse_table_refs()
            self.expect_op(")")
            alias, col_aliases = self.parse_alias()
            if alias:
                return A.AliasedTable(inner, alias, col_aliases)
            return inner
        name = self.object_name()
        # table function?
        if self.at_op("("):
            self.next()
            args = []
            while not self.eat_op(")"):
                args.append(self.parse_expr())
                self.eat_op(",")
            alias, col_aliases = self.parse_alias()
            return A.TableFunctionRef(".".join(name), args, alias, col_aliases)
        alias, col_aliases = self.parse_alias()
        return A.TableName(name, alias, col_aliases)

    def parse_alias(self):
        alias = None
        col_aliases: Tuple[str, ...] = ()
        if self.eat_word("AS"):
            alias = self.ident()
        elif self.peek().kind == Tok.IDENT or \
                (self.peek().kind == Tok.WORD and self.peek().value not in _RESERVED):
            alias = self.ident()
        if alias and self.at_op("(") :
            save = self.i
            self.next()
            try:
                names = [self.ident()]
                while self.eat_op(","):
                    names.append(self.ident())
                self.expect_op(")")
                col_aliases = tuple(names)
            except ParserError:
                self.i = save
        return alias, col_aliases

    # ======================================================================
    # expressions (Pratt)
    # ======================================================================
    def parse_expr(self, min_bp: int = 0) -> A.Node:
        lhs = self.parse_prefix()
        while True:
            t = self.peek()
            if t.kind == Tok.EOF:
                break
            op = t.value if t.kind in (Tok.OP, Tok.WORD) else None
            if op is None:
                break
            bp = _BP.get(op)
            if op == "NOT":
                # NOT BETWEEN / NOT IN / NOT LIKE ...
                nt = self.peek(1)
                if nt.kind == Tok.WORD and nt.value in ("BETWEEN", "IN", "LIKE", "ILIKE", "SIMILAR"):
                    bp = _BP[nt.value]
                else:
                    break
            if bp is None or bp <= min_bp:
                break
            lhs = self.parse_infix(lhs, op, bp)
        return lhs

    def parse_prefix(self) -> A.Node:
        t = self.next()
        if t.kind == Tok.NUMBER:
            return A.NumberLit(t.value)
        if t.kind == Tok.STRING:
            return A.StringLit(t.value)
        if t.kind == Tok.WORD and t.raw.upper() == "X" and \
                self.peek().kind == Tok.STRING:
            # hex byte-string literal X'616263' (sqlparser-rs
            # HexStringLiteral) -> typed binary
            return A.TypedString("BINARYHEX", self.next().value)
        if t.kind == Tok.PARAM:
            return A.Param(int(t.value))
        if t.kind == Tok.OP:
            if t.value == "(":
                # subquery or parenthesized expr or tuple
                if self.at_word("SELECT", "WITH"):
                    q = self.parse_query()
                    self.expect_op(")")
                    return A.ScalarSubquery(q)
                e = self.parse_expr()
                if self.at_op(","):
                    items = [e]
                    while self.eat_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    return A.Tuple_(items)
                self.expect_op(")")
                return e
            if t.value == "-":
                operand = self.parse_expr(55)
                # `-interval '5' - '1' - '2' year`: the reference's
                # sql_interval_to_expr applies the negation to the
                # LEFTMOST interval leaf only (value.rs:200-246)
                leftmost = operand
                while isinstance(leftmost, A.BinaryOp) and \
                        leftmost.op in ("+", "-"):
                    leftmost = leftmost.left
                if isinstance(leftmost, A.IntervalLit):
                    leftmost.value = "-" + str(leftmost.value)
                    return operand
                return A.UnaryOp("-", operand)
            if t.value == "+":
                return self.parse_expr(55)
            if t.value == "*":
                return A.Wildcard()
            if t.value == "[":
                items = []
                while not self.eat_op("]"):
                    items.append(self.parse_expr())
                    self.eat_op(",")
                return A.ArrayLit(items)
            if t.value == "@":
                sys = bool(self.eat_op("@"))     # @@name = system variable
                name = self.ident()
                return A.Variable(("@@" if sys else "@") + name)
            raise ParserError(f"unexpected token {t} in expression")
        # words
        w = t.value
        if w == "NOT":
            return A.UnaryOp("NOT", self.parse_expr(15))
        if w == "TRUE":
            return A.BoolLit(True)
        if w == "FALSE":
            return A.BoolLit(False)
        if w == "NULL":
            return A.NullLit()
        if w == "CASE":
            return self.parse_case()
        if w in ("CAST", "TRY_CAST"):
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_word("AS")
            tname, targs = self.parse_type_name()
            self.expect_op(")")
            return A.Cast(e, tname, targs, safe=(w == "TRY_CAST"))
        if w == "EXTRACT":
            self.expect_op("(")
            field = self.next().value
            self.expect_word("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return A.Extract(field, e)
        if w == "SUBSTRING" and self.at_op("("):
            self.next()
            e = self.parse_expr()
            start = length = None
            if self.eat_word("FROM"):
                start = self.parse_expr()
                if self.eat_word("FOR"):
                    length = self.parse_expr()
            elif self.eat_op(","):
                start = self.parse_expr()
                if self.eat_op(","):
                    length = self.parse_expr()
            self.expect_op(")")
            return A.Substring(e, start, length)
        if w == "TRIM" and self.at_op("("):
            self.next()
            where = "BOTH"
            chars = None
            if self.at_word("BOTH", "LEADING", "TRAILING"):
                where = self.next().value
            if not self.at_word("FROM"):
                first = self.parse_expr()
                if self.eat_word("FROM"):
                    chars = first
                    e = self.parse_expr()
                else:
                    e = first
                    if self.eat_op(","):
                        chars = self.parse_expr()
            else:
                self.expect_word("FROM")
                e = self.parse_expr()
            self.expect_op(")")
            return A.Trim(e, chars, where)
        if w == "OVERLAY" and self.at_op("("):
            # OVERLAY(str PLACING repl FROM pos [FOR len])
            self.next()
            s = self.parse_expr()
            if self.eat_word("PLACING"):
                repl = self.parse_expr()
                self.expect_word("FROM")
                pos = self.parse_expr()
                args = [s, repl, pos]
                if self.eat_word("FOR"):
                    args.append(self.parse_expr())
                self.expect_op(")")
                return A.FunctionCall("overlay", args)
            args = [s]
            while self.eat_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return A.FunctionCall("overlay", args)
        if w == "POSITION" and self.at_op("("):
            self.next()
            sub = self.parse_expr(21)
            self.expect_word("IN")
            s = self.parse_expr()
            self.expect_op(")")
            return A.Position(sub, s)
        if w == "INTERVAL":
            nt = self.next()
            if nt.kind in (Tok.STRING, Tok.NUMBER):
                val = nt.value
            else:
                raise ParserError(f"expected interval literal, found {nt}")
            # sqlparser-rs parses the interval VALUE as an expression:
            # `interval '1' + '1' month` = 1 month + 1 month. Collect a
            # +/- chain of literals; the trailing unit distributes over
            # every leaf.
            chain = [("+", val)]
            while self.peek().kind == Tok.OP and \
                    self.peek().value in ("+", "-") and \
                    self.peek(1).kind in (Tok.STRING, Tok.NUMBER) and \
                    not (self.peek(2).kind == Tok.OP and
                         self.peek(2).value == "::"):
                # a casted literal ('2012-01-01'::date) is an independent
                # operand, not an interval leaf (reference value.rs:270)
                sign = self.next().value
                chain.append((sign, self.next().value))
            unit = None
            if self.peek().kind == Tok.WORD and \
                    self.peek().value in _INTERVAL_SUFFIX_UNITS:
                unit = self.next().value
            expr = A.IntervalLit(chain[0][1], unit)
            for sign, v in chain[1:]:
                expr = A.BinaryOp(sign, expr, A.IntervalLit(v, unit))
            return expr
        if w in ("DATE", "TIMESTAMP", "TIME", "TIMESTAMPTZ") and \
                self.peek().kind == Tok.STRING:
            return A.TypedString(w, self.next().value)
        if w in ("CURRENT_TIME", "CURRENT_DATE", "CURRENT_TIMESTAMP") and \
                not self.at_op("("):
            # parenthesis-free SQL-standard niladic functions
            fn = {"CURRENT_TIME": "current_time",
                  "CURRENT_DATE": "current_date",
                  "CURRENT_TIMESTAMP": "now"}[w]
            return A.FunctionCall(fn, [])
        if w == "EXISTS" and self.at_op("("):
            self.next()
            q = self.parse_query()
            self.expect_op(")")
            return A.Exists(q)
        if w == "ARRAY" and self.at_op("["):
            self.next()
            items = []
            while not self.eat_op("]"):
                items.append(self.parse_expr())
                self.eat_op(",")
            return A.ArrayLit(items)
        # function call or identifier. LEFT/RIGHT are reserved (join
        # keywords) but are also SQL string functions when called.
        if self.at_op("(") and (w not in _RESERVED or w in ("LEFT", "RIGHT")):
            # quoted function names ("sqrt") are case-sensitive: used
            # verbatim, so "SQRT" is an unknown function like the reference
            return self.parse_function_call(
                t.value if t.kind == Tok.IDENT else t.raw.lower())
        # compound identifier
        parts = [t.raw.lower() if t.kind == Tok.WORD else t.value]
        if t.kind == Tok.IDENT:
            parts = [t.value]
        while self.at_op(".") and self.peek(1).kind in (Tok.WORD, Tok.IDENT):
            self.next()
            nt = self.next()
            parts.append(nt.raw.lower() if nt.kind == Tok.WORD else nt.value)
        return A.Identifier(parts)

    def parse_function_call(self, name: str) -> A.Node:
        self.expect_op("(")
        distinct = False
        star = False
        args: List[A.Node] = []
        order_by: List[A.OrderByItem] = []
        if self.eat_op(")"):
            pass
        else:
            if self.eat_word("DISTINCT"):
                distinct = True
            elif self.eat_word("ALL"):
                pass
            if self.at_op("*"):
                self.next()
                star = True
            else:
                args.append(self.parse_expr())
                while self.eat_op(","):
                    args.append(self.parse_expr())
            if self.eat_word("ORDER"):
                self.expect_word("BY")
                order_by = self.parse_order_by_list()
            self.expect_op(")")
        ignore_nulls = False
        if self.eat_word("IGNORE"):
            self.expect_word("NULLS")
            ignore_nulls = True
        elif self.eat_word("RESPECT"):
            self.expect_word("NULLS")   # the default
        filt = None
        if self.eat_word("FILTER"):
            self.expect_op("(")
            self.expect_word("WHERE")
            filt = self.parse_expr()
            self.expect_op(")")
        over = None
        if self.eat_word("OVER"):
            if self.eat_op("("):
                over = self.parse_window_spec()
                self.expect_op(")")
            else:
                # named window reference, resolved in planner via Select.named_windows
                over = A.WindowSpec()
                over.name_ref = self.ident()  # type: ignore[attr-defined]
        return A.FunctionCall(name, args, distinct, over, filt, order_by,
                              star, ignore_nulls)

    def parse_window_spec(self) -> A.WindowSpec:
        spec = A.WindowSpec()
        if self.eat_word("PARTITION"):
            self.expect_word("BY")
            spec.partition_by.append(self.parse_expr())
            while self.eat_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.eat_word("ORDER"):
            self.expect_word("BY")
            spec.order_by = self.parse_order_by_list()
        if self.at_word("ROWS", "RANGE", "GROUPS"):
            spec.frame_units = self.next().value
            if self.eat_word("BETWEEN"):
                spec.frame_start = self.parse_frame_bound()
                self.expect_word("AND")
                spec.frame_end = self.parse_frame_bound()
            else:
                spec.frame_start = self.parse_frame_bound()
                spec.frame_end = A.WindowFrameBound("CURRENT")
        return spec

    def parse_frame_bound(self) -> A.WindowFrameBound:
        if self.eat_word("UNBOUNDED"):
            if self.eat_word("PRECEDING"):
                return A.WindowFrameBound("UNBOUNDED_PRECEDING")
            self.expect_word("FOLLOWING")
            return A.WindowFrameBound("UNBOUNDED_FOLLOWING")
        if self.eat_word("CURRENT"):
            self.expect_word("ROW")
            return A.WindowFrameBound("CURRENT")
        off = self.parse_expr()
        # '5' SECOND PRECEDING — bare literal with interval unit
        # (reference: sqlparser window frame bound accepts interval exprs)
        if self.peek().kind == Tok.WORD and self.peek().value in _INTERVAL_UNITS \
                and isinstance(off, (A.StringLit, A.NumberLit)):
            unit = self.next().value
            off = A.IntervalLit(getattr(off, "value", None) or off.text, unit)
        if self.eat_word("PRECEDING"):
            return A.WindowFrameBound("PRECEDING", off)
        self.expect_word("FOLLOWING")
        return A.WindowFrameBound("FOLLOWING", off)

    def parse_case(self) -> A.Node:
        operand = None
        if not self.at_word("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.eat_word("WHEN"):
            cond = self.parse_expr()
            self.expect_word("THEN")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.eat_word("ELSE"):
            else_ = self.parse_expr()
        self.expect_word("END")
        return A.Case(operand, whens, else_)

    def parse_infix(self, lhs: A.Node, op: str, bp: int) -> A.Node:
        # NOT <op>
        negated = False
        if op == "NOT":
            self.next()
            negated = True
            op = self.peek().value
            bp = _BP[op]
        self.next()
        if op in ("AND", "OR"):
            return A.BinaryOp(op, lhs, self.parse_expr(bp))
        if op == "IS":
            neg = self.eat_word("NOT")
            if self.eat_word("NULL"):
                return A.IsNull(lhs, neg)
            if self.eat_word("TRUE"):
                return A.IsBool(lhs, True, neg)
            if self.eat_word("FALSE"):
                return A.IsBool(lhs, False, neg)
            if self.eat_word("UNKNOWN"):
                return A.IsBool(lhs, None, neg)
            if self.eat_word("DISTINCT"):
                self.expect_word("FROM")
                return A.IsDistinctFrom(lhs, self.parse_expr(bp), neg)
            raise ParserError(f"unexpected token after IS: {self.peek()}")
        if op == "BETWEEN":
            low = self.parse_expr(_BP["BETWEEN"] + 1)
            self.expect_word("AND")
            high = self.parse_expr(_BP["BETWEEN"] + 1)
            return A.Between(lhs, low, high, negated)
        if op == "IN":
            self.expect_op("(")
            if self.at_word("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return A.InSubquery(lhs, q, negated)
            items = [self.parse_expr()]
            while self.eat_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            if len(items) == 1 and isinstance(items[0], A.ScalarSubquery):
                # IN ((SELECT ...)): an extra paren level still means a
                # set-membership subquery, not a one-element scalar list
                return A.InSubquery(lhs, items[0].query, negated)
            return A.InList(lhs, items, negated)
        if op in ("LIKE", "ILIKE"):
            pat = self.parse_expr(bp)
            esc = None
            if self.eat_word("ESCAPE"):
                esc = self.next().value
            return A.Like(lhs, pat, negated, op == "ILIKE", esc)
        if op == "SIMILAR":
            self.expect_word("TO")
            return A.SimilarTo(lhs, self.parse_expr(bp), negated)
        if op == "::":
            tname, targs = self.parse_type_name()
            return A.Cast(lhs, tname, targs)
        if op == "[":
            idx = self.parse_expr()
            self.expect_op("]")
            return A.ArrayIndex(lhs, idx)
        if op == "AT":
            # AT TIME ZONE — parsed, applied as cast-with-tz (tz-naive engine)
            self.expect_word("TIME")
            self.expect_word("ZONE")
            tz = self.parse_expr(bp)
            return A.FunctionCall("at_time_zone", [lhs, tz])
        if op in ("~", "~*", "!~", "!~*"):
            pat = self.parse_expr(bp)
            return A.FunctionCall(
                {"~": "regexp_match_op", "~*": "regexp_imatch_op",
                 "!~": "regexp_not_match_op", "!~*": "regexp_not_imatch_op"}[op],
                [lhs, pat])
        if op in ("~~", "~~*", "!~~", "!~~*"):
            # postgres LIKE operators (reference: sqlparser PGLikeMatch
            # family -> Expr::Like / Expr::ILike)
            pat = self.parse_expr(bp)
            return A.Like(lhs, pat, op.startswith("!"), op.endswith("*"),
                          None)
        # plain binary
        rhs = self.parse_expr(bp)
        return A.BinaryOp(op, lhs, rhs)

    # ---- types ---------------------------------------------------------------
    def parse_type_name(self) -> Tuple[str, Tuple[int, ...]]:
        t = self.next()
        if t.kind not in (Tok.WORD, Tok.IDENT):
            raise ParserError(f"expected type name, found {t}")
        name = t.value.upper()
        if name == "DOUBLE" and self.eat_word("PRECISION"):
            name = "DOUBLE"
        if name in ("TIMESTAMP", "TIME"):
            if self.eat_word("WITH"):
                self.expect_word("TIME")
                self.expect_word("ZONE")
                if name == "TIMESTAMP":
                    name = "TIMESTAMPTZ"
            elif self.eat_word("WITHOUT"):
                self.expect_word("TIME")
                self.expect_word("ZONE")
        if name == "CHARACTER" and self.eat_word("VARYING"):
            name = "VARCHAR"
        if name in ("TINYINT", "SMALLINT", "INT", "INTEGER", "BIGINT") and \
                self.eat_word("UNSIGNED"):
            name = name + " UNSIGNED"
        if name == "STRUCT" and self.at_op("<"):
            # struct<a INT, b VARCHAR> / struct<INT> (anonymous fields);
            # canonicalized into the type-name string, decoded by
            # sql_type_to_datatype (reference: parse struct in
            # sqlparser-rs + planner convert_data_type)
            self.next()
            parts = []
            idx = 0
            while not self.eat_op(">"):
                fname = None
                save = self.i
                t1 = self.next()
                if t1.kind in (Tok.WORD, Tok.IDENT) and \
                        self.peek().kind in (Tok.WORD, Tok.IDENT) and \
                        not self.at_op(",") and not self.at_op(">"):
                    fname = t1.value
                else:
                    self.i = save
                inner, iargs = self.parse_type_name()
                if iargs:
                    inner = f"{inner}({','.join(map(str, iargs))})"
                if fname is None:
                    fname = f"c{idx}"
                idx += 1
                parts.append(f"{fname} {inner}")
                self.eat_op(",")
            name = "STRUCT<" + ", ".join(parts) + ">"
        args: Tuple[int, ...] = ()
        if self.at_op("("):
            self.next()
            vals = []
            while not self.eat_op(")"):
                vals.append(int(self.next().value))
                self.eat_op(",")
            args = tuple(vals)
        # array suffix
        while self.at_op("["):
            self.next()
            self.expect_op("]")
            name = name + "[]"
        return name, args


def parse_sql(sql: str) -> List[A.Statement]:
    return Parser(sql).parse_statements()


def parse_one(sql: str) -> A.Statement:
    stmts = parse_sql(sql)
    if len(stmts) != 1:
        raise ParserError(f"expected a single statement, found {len(stmts)}")
    return stmts[0]
