"""The bytes a query needs: each input column that its SQL names, once,
at the width of its type in the configuration's source (as the generator
makes it: a SMALLINT 2 bytes a row, whatever width the program widens it
to), plus its result once (8 bytes a cell).
Build tables, hash tables and re-reads are not counted, so the count is
the same whatever implements the query."""
from __future__ import annotations

import json
import re
from pathlib import Path


def named_columns(sql: str, columns) -> set:
    """The columns of the configuration that the SQL text names."""
    words = set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", sql))
    return words & set(columns)


def input_bytes(sql: str, tables: dict) -> int:
    """Bytes of the columns that `sql` names, in the generated tables
    ({table: {column: host array}})."""
    sizes = {c: a.nbytes for cols in tables.values() for c, a in cols.items()}
    return sum(sizes[c] for c in named_columns(sql, sizes))


def result_bytes(rows: list) -> int:
    return 8 * sum(len(r) for r in rows)


def peak_bytes_per_s(device_name: str):
    """The card's published memory bandwidth, or None for a card the table
    does not hold."""
    peaks = json.loads((Path(__file__).parent / "peaks.json").read_text())
    entry = peaks["devices"].get(device_name)
    return entry["hbm_bytes_per_s"] if entry else None
