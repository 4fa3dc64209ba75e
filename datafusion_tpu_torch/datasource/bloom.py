"""Parquet split-block bloom filters (SBBF): read + membership probe.

Used for row-group pruning of equality predicates — a row group whose
bloom filter provably excludes `col = literal` is skipped without
reading any data pages (reference:
`datafusion/datasource-parquet/src/row_group_filter.rs` bloom pruning +
the parquet-format BloomFilter spec: xxHash64(seed=0) over the
plain-encoded value, block index from the upper 32 hash bits, 8
salt-derived bits inside a 32-byte block).
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .page_index import _Reader

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 (the parquet bloom hash; values are short, so a pure
    Python implementation probing one literal is microseconds)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        while i + 32 <= n:
            for _ in range(1):
                v1 = (_rotl((v1 + int.from_bytes(data[i:i + 8], "little")
                             * _P2) & _M64, 31) * _P1) & _M64
                v2 = (_rotl((v2 + int.from_bytes(data[i + 8:i + 16], "little")
                             * _P2) & _M64, 31) * _P1) & _M64
                v3 = (_rotl((v3 + int.from_bytes(data[i + 16:i + 24], "little")
                             * _P2) & _M64, 31) * _P1) & _M64
                v4 = (_rotl((v4 + int.from_bytes(data[i + 24:i + 32], "little")
                             * _P2) & _M64, 31) * _P1) & _M64
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h ^= (_rotl((v * _P2) & _M64, 31) * _P1) & _M64
            h = (h * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        k = int.from_bytes(data[i:i + 8], "little")
        h ^= (_rotl((k * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


_SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
         0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)


class SplitBlockBloom:
    """num_bytes/32 blocks of 8 uint32 words each."""

    def __init__(self, bitset: bytes):
        self.blocks = np.frombuffer(bitset, dtype="<u4").reshape(-1, 8)

    def might_contain_hash(self, h: int) -> bool:
        nblocks = self.blocks.shape[0]
        block = self.blocks[((h >> 32) * nblocks) >> 32]
        key = h & 0xFFFFFFFF
        for i in range(8):
            bit = ((key * _SALT[i]) & 0xFFFFFFFF) >> 27
            if not (int(block[i]) >> bit) & 1:
                return False
        return True

    def might_contain(self, value, physical_type: str) -> Optional[bool]:
        enc = encode_plain(value, physical_type)
        if enc is None:
            return None
        return self.might_contain_hash(xxh64(enc))


def encode_plain(value, physical_type: str) -> Optional[bytes]:
    """Parquet PLAIN encoding of a single value (what the writer hashed)."""
    try:
        if physical_type == "INT32":
            return struct.pack("<i", int(value))
        if physical_type == "INT64":
            return struct.pack("<q", int(value))
        if physical_type == "FLOAT":
            return struct.pack("<f", float(value))
        if physical_type == "DOUBLE":
            return struct.pack("<d", float(value))
        if physical_type in ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY"):
            if isinstance(value, bytes):
                return value
            return str(value).encode("utf-8")
        if physical_type == "BOOLEAN":
            return b"\x01" if value else b"\x00"
    except (ValueError, OverflowError, struct.error):
        return None
    return None


def read_bloom_filter(path: str, offset: int,
                      length: Optional[int] = None
                      ) -> Optional[SplitBlockBloom]:
    """Parse BloomFilterHeader (thrift compact) at `offset` and return the
    bitset. None when the filter uses an algorithm/hash/compression we
    don't understand (only BLOCK + XXHASH + UNCOMPRESSED exist today)."""
    with open(path, "rb") as f:
        f.seek(offset)
        # header is tiny; 128B safely covers it, then read the bitset
        head = f.read(length if length else 128)
        r = _Reader(head)
        try:
            hdr = r.read_struct()
        except Exception:  # noqa: BLE001 — malformed header
            return None
        num_bytes = hdr.get(1)
        algo, hsh, comp = hdr.get(2), hdr.get(3), hdr.get(4)
        if (not isinstance(num_bytes, int) or num_bytes <= 0
                or num_bytes % 32):
            return None
        # each is a thrift union; field id 1 = BLOCK / XXHASH / UNCOMPRESSED
        for u in (algo, hsh, comp):
            if not (isinstance(u, dict) and 1 in u):
                return None
        hdr_len = r.i
        bitset = head[hdr_len:hdr_len + num_bytes]
        if len(bitset) < num_bytes:
            f.seek(offset + hdr_len)
            bitset = f.read(num_bytes)
        if len(bitset) != num_bytes:
            return None
        return SplitBlockBloom(bitset)
