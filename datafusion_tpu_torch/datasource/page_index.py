"""Parquet page-index reader (ColumnIndex / OffsetIndex).

Reference parity: page-level pruning (`datasource/physical_plan/parquet/
page_filter.rs`) — the reference's PagePruningPredicate evaluates the
predicate over per-page min/max from the parquet page index and emits a
RowSelection the arrow reader uses to skip pages. pyarrow exposes only
`has_column_index` booleans, not the index contents, so this module
parses the footer thrift (compact protocol) directly and returns per-page
statistics + first-row offsets; `ParquetScanExec` turns them into kept
row ranges per row group (the RowSelection analog — decode-level row
skipping; pyarrow's reader does not support byte-level page skipping).

Thrift compact protocol per the parquet-format spec:
field header = (field-id delta << 4) | type, zigzag varints, and
size-prefixed list headers.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

# compact-protocol type codes
_T_STOP, _T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64, _T_DOUBLE, \
    _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = range(13)


class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def varint(self) -> int:
        r = s = 0
        while True:
            x = self.u8()
            r |= (x & 0x7F) << s
            if not x & 0x80:
                return r
            s += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_value(self, t: int):
        if t == _T_TRUE:
            return True
        if t == _T_FALSE:
            return False
        if t == _T_BYTE:
            return self.zigzag()
        if t in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if t == _T_DOUBLE:
            v = struct.unpack_from("<d", self.b, self.i)[0]
            self.i += 8
            return v
        if t == _T_BINARY:
            n = self.varint()
            v = self.b[self.i:self.i + n]
            self.i += n
            return v
        if t == _T_LIST or t == _T_SET:
            h = self.u8()
            n = h >> 4
            et = h & 0x0F
            if n == 15:
                n = self.varint()
            if et in (_T_TRUE, _T_FALSE):
                # bool list elements are encoded as one byte each (1/2)
                return [self.u8() == 1 for _ in range(n)]
            return [self.read_value(et) for _ in range(n)]
        if t == _T_MAP:
            n = self.varint()
            if n == 0:
                return {}
            h = self.u8()
            kt, vt = h >> 4, h & 0x0F
            return {self.read_value(kt): self.read_value(vt)
                    for _ in range(n)}
        if t == _T_STRUCT:
            return self.read_struct()
        raise ValueError(f"thrift compact type {t}")

    def read_struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        fid = 0
        while True:
            h = self.u8()
            if h == _T_STOP:
                return out
            delta = h >> 4
            t = h & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.read_value(t)


def _decode_stat(raw: Optional[bytes], ptype: int):
    """Decode a ColumnIndex min/max binary by parquet physical type."""
    if raw is None:
        return None
    try:
        if ptype == 0:                      # BOOLEAN
            return bool(raw[0]) if raw else None
        if ptype == 1:                      # INT32
            return struct.unpack("<i", raw)[0]
        if ptype == 2:                      # INT64
            return struct.unpack("<q", raw)[0]
        if ptype == 4:                      # FLOAT
            return struct.unpack("<f", raw)[0]
        if ptype == 5:                      # DOUBLE
            return struct.unpack("<d", raw)[0]
        if ptype == 6:                      # BYTE_ARRAY (utf8 in practice)
            return raw.decode("utf-8", "replace")
    except (struct.error, IndexError):
        return None
    return None                             # INT96 / FIXED: unsupported


def read_page_index(path: str):
    """Returns {(row_group, column_name): (mins, maxs, null_pages,
    first_row_indices)} plus {row_group: num_rows}, or ({}, {}) when the
    file carries no page index."""
    with open(path, "rb") as fh:
        fh.seek(0, 2)
        size = fh.tell()
        fh.seek(size - 8)
        tail = fh.read(8)
        if tail[4:] != b"PAR1":
            return {}, {}
        meta_len = struct.unpack("<I", tail[:4])[0]
        fh.seek(size - 8 - meta_len)
        meta = fh.read(meta_len)
        fmd = _Reader(meta).read_struct()
        # FileMetaData: 2=schema(list<SchemaElement>), 4=row_groups
        schema = fmd.get(2) or []
        # leaf columns in schema order (skip the root; no nested support)
        leaf_types: List[Tuple[str, int]] = []
        for se in schema[1:]:
            name = se.get(4, b"").decode("utf-8", "replace")
            if 1 in se:                    # has a physical type => leaf
                # converted_type DECIMAL(5) / TIMESTAMP_*(9,10): raw
                # int stats are unscaled — not comparable to SQL
                # literals, so mark the column unprunable (ptype -1)
                ptype = -1 if se.get(6) in (5, 9, 10) else se[1]
                leaf_types.append((name, ptype))
        index: Dict[Tuple[int, str], tuple] = {}
        rg_rows: Dict[int, int] = {}
        for rg_i, rg in enumerate(fmd.get(4) or []):
            rg_rows[rg_i] = rg.get(3, 0)   # RowGroup.num_rows
            for c_i, cc in enumerate(rg.get(1) or []):
                # ColumnChunk: 4=offset_index_offset, 5=offset_index_length,
                #              6=column_index_offset, 7=column_index_length
                ci_off, ci_len = cc.get(6), cc.get(7)
                oi_off, oi_len = cc.get(4), cc.get(5)
                if ci_off is None or oi_off is None or c_i >= len(leaf_types):
                    continue
                name, ptype = leaf_types[c_i]
                fh.seek(ci_off)
                ci = _Reader(fh.read(ci_len)).read_struct()
                fh.seek(oi_off)
                oi = _Reader(fh.read(oi_len)).read_struct()
                null_pages = ci.get(1) or []
                mins = [None if np_ else _decode_stat(m, ptype)
                        for m, np_ in zip(ci.get(2) or [], null_pages)]
                maxs = [None if np_ else _decode_stat(m, ptype)
                        for m, np_ in zip(ci.get(3) or [], null_pages)]
                # OffsetIndex.page_locations[].first_row_index (field 3)
                first_rows = [pl.get(3, 0) for pl in (oi.get(1) or [])]
                if len(first_rows) != len(mins):
                    continue
                index[(rg_i, name)] = (mins, maxs, null_pages, first_rows)
        return index, rg_rows
