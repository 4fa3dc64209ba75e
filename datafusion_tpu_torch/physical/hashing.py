"""Deterministic vectorized row hashing + multi-column group factorization.

Reference parity: `create_hashes` (`datafusion/common/src/hash_utils.rs:358`)
— multi-column combine with fixed seeds, shared by RepartitionExec and
HashJoinExec so shuffle placement and build-side lookup agree
(`repartition/mod.rs:211`, `hash_join.rs:360`). Our hash must additionally
be identical on every *host* (multi-host shuffle), so it is pure integer
arithmetic: splitmix64 finalizer over device bit patterns; strings hash
their utf-8 bytes via FNV-1a once per dictionary entry (O(|dict|)) and
gather by code.

`factorize` is the GroupValues analog (`aggregates/group_values/`): maps
multi-column keys to dense group ids 0..G-1 by successive per-column
factorization (always fits in int64, no hash collisions to resolve).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..common.column import Column

_U64 = np.uint64
_NULL_HASH = _U64(0x9E3779B97F4A7C15)

# fault-injection mode (reference: force_hash_collisions feature,
# hash_utils.rs:309-318): every row hashes to 0 so the whole join/agg
# suite exercises collision handling
FORCE_HASH_COLLISIONS = False


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += _U64(0x9E3779B97F4A7C15)
        z = x
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def _fnv1a64(b: bytes) -> int:
    h = 0xCBF29CE484222325
    for byte in b:
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv_dictionary_lut(dic) -> np.ndarray:
    """FNV-1a per dictionary entry (C extension when available)."""
    vals = dic.values
    from ..native import fnv1a64_bulk
    lut = fnv1a64_bulk(vals)
    if lut is None:
        lut = np.fromiter((_fnv1a64(str(v).encode()) for v in vals),
                          dtype=np.uint64, count=len(vals))
    return lut


def _column_bits(col: Column) -> np.ndarray:
    """Column -> canonical uint64 value-identity words."""
    data = col.data_host()
    if col.dtype.is_string:
        # hash dictionary values once, gather by code
        lut = fnv_dictionary_lut(col.dictionary)
        if len(lut) == 0:
            return np.zeros(len(col), np.uint64)
        return lut[np.clip(data, 0, len(lut) - 1)]
    if data.dtype.kind == "f":
        # normalize -0.0 -> 0.0 and NaN -> one bit pattern
        d = data.astype(np.float64, copy=True)
        d[d == 0.0] = 0.0
        d[np.isnan(d)] = np.nan
        return d.view(np.uint64).copy()
    if data.dtype == np.bool_:
        return data.astype(np.uint64)
    return data.astype(np.int64).view(np.uint64).copy()


def create_hashes(cols: List[Column], n: Optional[int] = None) -> np.ndarray:
    """Combined 64-bit row hash over key columns. NULL slots contribute a
    fixed tag so (NULL, x) and (y, NULL) land deterministically."""
    if FORCE_HASH_COLLISIONS:
        size = n if n is not None else (len(cols[0]) if cols else 0)
        return np.zeros(size, np.uint64)
    if not cols:
        assert n is not None
        return np.zeros(n, np.uint64)
    out = None
    for c in cols:
        bits = _splitmix64(_column_bits(c))
        v = c.validity_host()
        if v is not None:
            bits = np.where(v, bits, _NULL_HASH)
        if out is None:
            out = bits
        else:
            with np.errstate(over="ignore"):
                # boost-style hash_combine, then re-finalize
                out = _splitmix64(out ^ (bits + _U64(0x9E3779B97F4A7C15)
                                         + (out << _U64(6)) + (out >> _U64(2))))
    if n is not None and len(out) > n:
        out = out[:n]   # columns may be capacity-padded beyond num_rows
    return out


def _dense_codes(arr: np.ndarray) -> Tuple[np.ndarray, int]:
    """Hash-based dense codes (first-appearance order), O(n)."""
    import pandas as pd
    codes, uniques = pd.factorize(arr, use_na_sentinel=False)
    return codes.astype(np.int64), len(uniques)


def factorize_column(col: Column) -> np.ndarray:
    """Per-column dense codes in [0, card); NULL gets its own code."""
    data = col.data_host()
    v = col.validity_host()
    if col.dtype.is_nested:
        # list/struct keys: hash the python representation (reference
        # groups on arrow list values; GROUP BY [..] is rare + small)
        import pandas as pd
        keyed = np.fromiter((repr(x) for x in col.to_pylist(len(data))),
                            dtype=object, count=len(data))
        inv, _ = pd.factorize(keyed, use_na_sentinel=False)
        codes = inv.astype(np.int64) + 1
        if v is not None:
            codes = np.where(v, codes, 0)
        return codes
    if data.dtype.kind == "f":
        d = data.astype(np.float64, copy=True)
        d[d == 0.0] = 0.0
        inv, _ = _dense_codes(d)
    else:
        inv, _ = _dense_codes(data)
    codes = inv + 1
    if v is not None:
        codes = np.where(v, codes, 0)
    return codes


def factorize(cols: List[Column], n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Multi-column keys -> (group_ids [n], first_row_indices [G], G).

    group ids are dense 0..G-1 ordered by first appearance (matches the
    reference's GroupValues intern order, which makes streaming EmitTo
    deterministic).
    """
    if not cols:
        return np.zeros(n, np.int64), np.zeros(min(n, 1), np.int64), min(n, 1)
    combined = factorize_column(cols[0])
    for c in cols[1:]:
        codes = factorize_column(c)
        card = codes.max(initial=0) + 1
        lim = np.iinfo(np.int64).max // max(card, 1)
        if combined.max(initial=0) >= lim:
            # re-densify to avoid overflow
            combined, _ = _dense_codes(combined)
        combined = combined * card + codes
    # hash-based factorize yields group ids already in first-appearance
    # order (matches the reference's GroupValues intern order)
    group_ids, n_groups = _dense_codes(combined)
    # first occurrence per group: reverse-order assignment leaves the
    # earliest row index in place (later writes overwritten by earlier rows)
    first_rows = np.empty(n_groups, np.int64)
    first_rows[group_ids[::-1]] = np.arange(n - 1, -1, -1)
    return group_ids, first_rows, n_groups
