"""pyarrow <-> Batch conversion.

The host IO path reads Parquet/CSV/JSON via pyarrow (the reference reads
them via arrow-rs/parquet crates — `datasource/physical_plan/parquet`),
then converts to the engine's dense-array + validity + dictionary layout
for the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import dt
from ..common.batch import Batch
from ..common.column import Column, Dictionary
from ..common.datatypes import DataType
from ..common.errors import ExecutionError
from ..common.schema import Field, Schema


def arrow_type_to_dtype(t) -> DataType:
    import pyarrow as pa
    if pa.types.is_boolean(t):
        return dt.BOOL
    if pa.types.is_int8(t):
        return dt.INT8
    if pa.types.is_int16(t):
        return dt.INT16
    if pa.types.is_int32(t):
        return dt.INT32
    if pa.types.is_int64(t):
        return dt.INT64
    if pa.types.is_uint8(t):
        return dt.UINT8
    if pa.types.is_uint16(t):
        return dt.UINT16
    if pa.types.is_uint32(t):
        return dt.UINT32
    if pa.types.is_uint64(t):
        return dt.UINT64
    if pa.types.is_float32(t):
        return dt.FLOAT32
    if pa.types.is_float64(t):
        return dt.FLOAT64
    if pa.types.is_decimal(t):
        return dt.decimal(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t) or \
            pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return dt.STRING
    if pa.types.is_date(t):
        return dt.DATE
    if pa.types.is_timestamp(t):
        unit = t.unit if t.unit in ("s", "ms", "us", "ns") else "us"
        return dt.timestamp(unit)
    if pa.types.is_time(t):
        return dt.TIME
    if pa.types.is_dictionary(t):
        return arrow_type_to_dtype(t.value_type)
    if pa.types.is_null(t):
        # all-NULL inferred column (e.g. a JSON file of nulls)
        return dt.NULL
    raise ExecutionError(f"unsupported arrow type {t}")


def arrow_schema_to_schema(aschema, qualifier: Optional[str] = None) -> Schema:
    return Schema([Field(f.name, arrow_type_to_dtype(f.type), f.nullable,
                         qualifier=qualifier) for f in aschema])


def arrow_column_to_column(arr, dtype: DataType) -> Column:
    """ChunkedArray/Array -> Column."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    n = len(arr)
    null_count = arr.null_count
    validity = None
    if null_count:
        validity = np.asarray(pc.is_valid(arr))
    if dtype.is_string:
        # build the sorted dictionary from distinct values only
        uniq = pc.unique(arr.drop_null())
        vals = np.array(sorted(uniq.to_pylist()), dtype=object)
        dic = Dictionary(vals)
        idx = pc.index_in(arr, pa.array(vals, type=arr.type))
        codes = np.asarray(idx.fill_null(0)).astype(np.int32)
        return Column(dt.STRING, codes, validity, dic)
    if dtype.is_decimal:
        # exact: decimal128 -> scaled int64 (p <= 18)
        ints = pc.cast(arr, pa.decimal128(38, dtype.scale))
        py = ints.to_pylist()
        data = np.fromiter(
            ((int(v.scaleb(dtype.scale)) if v is not None else 0) for v in py),
            dtype=np.int64, count=n)
        return Column(dtype, data, validity)
    if dtype.id.value == "date":
        arr32 = pc.cast(arr, pa.date32())
        data = np.asarray(arr32.fill_null(0)).astype("datetime64[D]").astype(np.int32)
        return Column(dtype, data, validity)
    if dtype.id.value == "timestamp":
        # convert to the declared unit first: pyarrow may have inferred a
        # different resolution (CSV inference yields timestamp[ns])
        if not pa.types.is_timestamp(arr.type):
            arr = pc.cast(arr, pa.timestamp(dtype.unit))
        elif arr.type.unit != dtype.unit:
            arr = pc.cast(arr, pa.timestamp(dtype.unit, arr.type.tz))
        data = np.asarray(pc.cast(arr.fill_null(0), pa.int64()))
        return Column(dtype, data.astype(np.int64), validity)
    npdt = dtype.device_dtype()
    if null_count:
        arr = arr.fill_null(0 if npdt.kind != "b" else False)
    data = arr.to_numpy(zero_copy_only=False)
    if data.dtype != npdt:
        data = data.astype(npdt)
    return Column(dtype, data, validity)


def arrow_table_to_batch(table, schema: Optional[Schema] = None) -> Batch:
    if schema is None:
        schema = arrow_schema_to_schema(table.schema)
    cols = []
    for i, f in enumerate(schema):
        cols.append(arrow_column_to_column(table.column(i), f.dtype))
    return Batch(schema, cols, table.num_rows)


def batch_to_arrow(batch: Batch):
    """Batch -> pyarrow.Table (for writes and pandas interop)."""
    import pyarrow as pa
    arrays, names = [], []
    for f, c in zip(batch.schema, batch.columns):
        names.append(f.name)
        vals = c.to_pylist(batch.num_rows)
        d = f.dtype
        if d.is_decimal:
            arrays.append(pa.array(vals, type=pa.decimal128(max(d.precision, 1), d.scale)))
        elif d.is_string:
            arrays.append(pa.array([None if v is None else str(v) for v in vals],
                                   type=pa.string()))
        elif d.id.value == "timestamp":
            arrays.append(pa.array(
                [None if v is None else int(v.astype(np.int64)) if hasattr(v, "astype") else int(v)
                 for v in vals],
                type=pa.timestamp(d.unit)))
        else:
            arrays.append(pa.array(vals))
    return pa.table(dict(zip(names, arrays)))
