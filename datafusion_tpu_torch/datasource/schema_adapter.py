"""SchemaAdapter: map each file's physical schema onto the table schema.

Listing tables read many files written over time; later files may have
added columns or widened types. The adapter fills columns missing from a
file with nulls and casts present columns to the table's type, so one
logical schema scans over heterogeneous files (reference:
`datafusion/datasource/src/schema_adapter.rs` — DefaultSchemaAdapter
map_schema/map_batch)."""
from __future__ import annotations


def adapt_table(tbl, names, expected_arrow_schema):
    """pyarrow Table (file layout) -> table layout with `names` columns:
    missing columns become all-null, present ones cast to the expected
    arrow type. Raises on uncastable type combinations (the reference
    errors there too: schema_adapter.rs map_schema 'Cannot cast')."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = tbl.num_rows
    out = {}
    have = set(tbl.column_names)
    exp_names = (set(expected_arrow_schema.names)
                 if expected_arrow_schema is not None else set())
    for name in names:
        et = (expected_arrow_schema.field(name).type
              if name in exp_names else None)
        if name in have:
            col = tbl.column(name)
            if et is not None and col.type != et:
                col = pc.cast(col, et)
            out[name] = col
        else:
            out[name] = pa.nulls(n, type=et if et is not None else pa.null())
    return pa.table(out)


def needs_adapting(file_arrow_schema, names, expected_arrow_schema) -> bool:
    have = set(file_arrow_schema.names)
    if any(name not in have for name in names):
        return True
    if expected_arrow_schema is None:
        return False
    exp = set(expected_arrow_schema.names)
    for name in names:
        if name in exp and \
                file_arrow_schema.field(name).type != \
                expected_arrow_schema.field(name).type:
            return True
    return False
