"""Embedded Avro Object Container File reader/writer (pure Python).

Reference parity: the reference embeds its own Avro decoder rather than
depending on an external crate (`core/src/datasource/avro_to_arrow/
{schema,arrow_array_reader}.rs`, `AvroExec` `datasource/physical_plan/
avro.rs:101`). No Avro library ships in this image, so this module
implements the container format directly: header (magic `Obj\\x01`,
metadata map with the writer schema JSON + codec, 16-byte sync marker)
followed by blocks of `count, byte-length, records, sync`.

Supported schema surface (matches the reference's flat-record reader):
records of primitives (null/boolean/int/long/float/double/bytes/string),
nullable unions `["null", T]` in either order, enums (decoded to their
symbol strings), fixed, and the date / timestamp-millis / timestamp-micros
logical types. Codecs: null and deflate. The writer exists for COPY TO
and round-trip tests; the reference is read-only for Avro.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary primitives
# ---------------------------------------------------------------------------

def _read_long(b: io.BufferedReader) -> int:
    r = s = 0
    while True:
        x = b.read(1)
        if not x:
            raise EOFError("truncated avro varint")
        x = x[0]
        r |= (x & 0x7F) << s
        if not x & 0x80:
            return (r >> 1) ^ -(r & 1)
        s += 7


def _write_long(out: bytearray, v: int) -> None:
    v = (v << 1) ^ (v >> 63) if v >= 0 else ((-v - 1) << 1) | 1  # zigzag
    v &= (1 << 64) - 1
    while True:
        if v < 0x80:
            out.append(v)
            return
        out.append((v & 0x7F) | 0x80)
        v >>= 7


def _read_bytes(b) -> bytes:
    return b.read(_read_long(b))


# ---------------------------------------------------------------------------
# schema model
# ---------------------------------------------------------------------------

class _FieldDec:
    """One record field: name + a decode(stream) -> python value."""

    __slots__ = ("name", "kind", "nullable", "symbols", "size", "logical",
                 "_null_idx")

    def __init__(self, name, kind, nullable=False, symbols=None, size=0,
                 logical=None):
        self.name = name
        self.kind = kind          # primitive kind after union unwrap
        self.nullable = nullable
        self.symbols = symbols    # enum symbols
        self.size = size          # fixed size
        self.logical = logical    # date | timestamp-millis | timestamp-micros
        self._null_idx = 0


def _parse_field_schema(name: str, s) -> _FieldDec:
    nullable = False
    if isinstance(s, list):                      # union
        branches = [x for x in s if x != "null"]
        if len(branches) != 1 or len(s) > 2:
            raise ValueError(f"unsupported avro union {s!r}")
        nullable = len(branches) != len(s)
        s = branches[0]
    if isinstance(s, dict):
        t = s["type"]
        logical = s.get("logicalType")
        if t == "enum":
            return _FieldDec(name, "enum", nullable, symbols=s["symbols"])
        if t == "fixed":
            return _FieldDec(name, "fixed", nullable, size=s["size"])
        if t in ("int", "long", "float", "double", "string", "bytes",
                 "boolean", "null"):
            if logical in ("date", "timestamp-millis", "timestamp-micros",
                           "time-millis", "time-micros"):
                return _FieldDec(name, t, nullable, logical=logical)
            return _FieldDec(name, t, nullable)
        raise ValueError(f"unsupported avro type {t!r}")
    if s in ("int", "long", "float", "double", "string", "bytes",
             "boolean", "null"):
        return _FieldDec(name, s, nullable)
    raise ValueError(f"unsupported avro type {s!r}")


def _decode_value(b, f: _FieldDec):
    if f.nullable:
        if _read_long(b) == _null_branch_skip(f):
            return None
    return _decode_raw(b, f)


def _null_branch_skip(f):
    # branch index of "null" — we normalize to 0 at parse time by
    # recording unions as ["null", T]; writers using [T, "null"] put
    # null at 1. We detect per-file in _parse_record (stored on field).
    return getattr(f, "_null_idx", 0)


def _decode_raw(b, f: _FieldDec):
    k = f.kind
    if k == "null":
        return None
    if k == "boolean":
        return b.read(1) == b"\x01"
    if k in ("int", "long"):
        return _read_long(b)
    if k == "float":
        return struct.unpack("<f", b.read(4))[0]
    if k == "double":
        return struct.unpack("<d", b.read(8))[0]
    if k == "string":
        return _read_bytes(b).decode("utf-8")
    if k == "bytes":
        return _read_bytes(b)
    if k == "enum":
        return f.symbols[_read_long(b)]
    if k == "fixed":
        return b.read(f.size)
    raise ValueError(k)


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------

def read_avro(path: str) -> Tuple[List[str], Dict[str, list], Dict[str, dict]]:
    """Read an Avro container file -> (field order, {name: python list},
    {name: field meta}). Lists hold Python values with None for nulls."""
    with open(path, "rb") as fh:
        if fh.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an Avro object container file")
        meta: Dict[str, bytes] = {}
        n = _read_long(fh)
        while n != 0:
            if n < 0:           # block with byte-size prefix
                _read_long(fh)
                n = -n
            for _ in range(n):
                k = _read_bytes(fh).decode()
                meta[k] = _read_bytes(fh)
            n = _read_long(fh)
        codec = meta.get("avro.codec", b"null").decode()
        schema = json.loads(meta["avro.schema"].decode())
        if schema.get("type") != "record":
            raise ValueError("top-level avro schema must be a record")
        fields: List[_FieldDec] = []
        for fs in schema["fields"]:
            f = _parse_field_schema(fs["name"], fs["type"])
            # record where "null" sits inside the union for this file
            if f.nullable and isinstance(fs["type"], list):
                f._null_idx = fs["type"].index("null")
            fields.append(f)
        sync = fh.read(16)
        cols: Dict[str, list] = {f.name: [] for f in fields}
        while True:
            head = fh.read(1)
            if not head:
                break
            fh.seek(-1, os.SEEK_CUR)
            try:
                count = _read_long(fh)
            except EOFError:
                break
            nbytes = _read_long(fh)
            block = fh.read(nbytes)
            if codec == "deflate":
                block = zlib.decompress(block, -15)
            elif codec != "null":
                raise ValueError(f"unsupported avro codec {codec}")
            br = io.BytesIO(block)
            for _ in range(count):
                for f in fields:
                    cols[f.name].append(_decode_value(br, f))
            if fh.read(16) != sync:
                raise ValueError(f"{path}: avro sync marker mismatch")
        metas = {f.name: {"kind": f.kind, "logical": f.logical,
                          "nullable": f.nullable} for f in fields}
        return [f.name for f in fields], cols, metas


def avro_to_arrow(path: str):
    """Avro file -> pyarrow.Table (date/timestamp logical types applied)."""
    import pyarrow as pa
    names, cols, metas = read_avro(path)
    arrays, fields = [], []
    for name in names:
        vals = cols[name]
        meta = metas[name]
        k, lg = meta["kind"], meta["logical"]
        if lg == "date":
            t = pa.date32()
        elif lg == "timestamp-millis":
            t = pa.timestamp("ms")
        elif lg == "timestamp-micros":
            t = pa.timestamp("us")
        elif k == "int":
            t = pa.int32()
        elif k == "long":
            t = pa.int64()
        elif k == "float":
            t = pa.float32()
        elif k == "double":
            t = pa.float64()
        elif k == "boolean":
            t = pa.bool_()
        elif k in ("string", "enum"):
            t = pa.string()
        elif k in ("bytes", "fixed"):
            t = pa.binary()
        else:
            t = pa.null()
        arrays.append(pa.array(vals, type=t))
        fields.append(pa.field(name, t, nullable=meta["nullable"]))
    return pa.table(dict(zip(names, arrays)))


# ---------------------------------------------------------------------------
# writer (COPY TO / tests)
# ---------------------------------------------------------------------------

_ARROW_TO_AVRO = {
    "int8": "int", "int16": "int", "int32": "int", "int64": "long",
    "uint8": "int", "uint16": "int", "uint32": "long", "uint64": "long",
    "float": "float", "double": "double", "bool": "boolean",
    "string": "string", "large_string": "string", "binary": "bytes",
}


def arrow_to_avro(table, path: str, codec: str = "deflate") -> None:
    """pyarrow.Table -> Avro container file."""
    import pyarrow as pa
    fields_json = []
    encoders = []
    for f in table.schema:
        t = f.type
        if pa.types.is_date32(t):
            avro_t = {"type": "int", "logicalType": "date"}
            enc = ("long", lambda v: v.toordinal() - 719163
                   if hasattr(v, "toordinal") else int(v))
        elif pa.types.is_timestamp(t):
            avro_t = {"type": "long", "logicalType": "timestamp-micros"}
            enc = ("long", lambda v: int(v.timestamp() * 1_000_000)
                   if hasattr(v, "timestamp") else int(v))
        elif pa.types.is_dictionary(t):
            avro_t = "string"
            enc = ("string", str)
        elif str(t) in _ARROW_TO_AVRO:
            avro_t = _ARROW_TO_AVRO[str(t)]
            enc = (avro_t, None)
        elif pa.types.is_decimal(t):
            avro_t = "double"
            enc = ("double", float)
        else:
            raise ValueError(f"cannot write {t} to avro")
        fields_json.append({"name": f.name, "type": ["null", avro_t]})
        encoders.append(enc)
    schema = {"type": "record", "name": "row", "fields": fields_json}
    sync = os.urandom(16)
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        head = bytearray()
        _write_long(head, 2)
        for k, v in (("avro.schema", json.dumps(schema).encode()),
                     ("avro.codec", codec.encode())):
            _write_long(head, len(k))
            head += k.encode()
            _write_long(head, len(v))
            head += v
        _write_long(head, 0)
        fh.write(bytes(head))
        fh.write(sync)
        body = bytearray()
        data = table.to_pylist()
        for row in data:
            for (kind, conv), f in zip(encoders, table.schema):
                v = row[f.name]
                if v is None:
                    _write_long(body, 0)      # union branch: null
                    continue
                _write_long(body, 1)
                if conv is not None:
                    v = conv(v)
                if kind in ("int", "long"):
                    _write_long(body, int(v))
                elif kind == "float":
                    body += struct.pack("<f", float(v))
                elif kind == "double":
                    body += struct.pack("<d", float(v))
                elif kind == "boolean":
                    body.append(1 if v else 0)
                elif kind == "string":
                    raw = str(v).encode("utf-8")
                    _write_long(body, len(raw))
                    body += raw
                elif kind == "bytes":
                    _write_long(body, len(v))
                    body += bytes(v)
        raw = bytes(body)
        if codec == "deflate":
            c = zlib.compressobj(9, zlib.DEFLATED, -15)
            raw = c.compress(raw) + c.flush()
        block = bytearray()
        _write_long(block, len(data))
        _write_long(block, len(raw))
        fh.write(bytes(block))
        fh.write(raw)
        fh.write(sync)
