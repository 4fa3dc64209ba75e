"""Columnar substrate: Dictionary + Column.

This replaces Arrow `RecordBatch` columns (reference:
`datafusion/physical-plan` operates on arrow arrays throughout) with a
TPU-first representation:

* numeric / temporal / decimal data are dense 1-D device arrays of the
  type's ``device_dtype()``;
* NULLs are a separate boolean validity array (True = valid), or ``None``
  when the column has no nulls — kernels take the fast path;
* strings are **order-preserving dictionary codes**: the host keeps a
  lexicographically sorted ``Dictionary`` of distinct values and the device
  holds int32 codes, so ``code_a < code_b  <=>  str_a < str_b``. All device
  comparisons/sorts/joins/group-bys on strings run on the codes; host-side
  string kernels (LIKE/regex/substring) evaluate once per dictionary entry.

A Column holds host numpy arrays. Their device copies (torch tensors) live
in a ``DeviceColumnCache`` keyed by the column's never-recycled ``_uid``
(``to_device`` at the end of this module); the host original stays as it
is. Dictionary-coded strings stay int32 codes on the device; the
dictionary stays on the host. There are no padded copies and no capacity
buckets: PyTorch has no static shapes.

A *device-born* column is one that a kernel wrote: its data and validity
are torch tensors on the card and it has no host original (the output of
the row-returning join chain, and a large group table's resident emit).
``to_device`` hands its own tensors back with no copy and no cache entry;
``data_host()`` and ``validity_host()`` make one ``.cpu()`` copy at first
use and keep it, so host operators that read it many times pay one copy.
It is the port's counterpart of a JAX-package ``Column`` holding a jax
array.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import datatypes as dt
from .datatypes import DataType, TypeId
from .errors import internal

__all__ = ["Dictionary", "Column", "concat_columns", "DeviceColumnCache",
           "to_device"]


class Dictionary:
    """A sorted array of distinct string values; code i -> values[i].

    ``values`` is a numpy array of dtype object (python str / bytes).
    Invariant: strictly ascending, so int comparisons on codes agree with
    string comparisons. Code -1 is never used; NULL strings are represented
    by validity=False with code 0.
    """

    __slots__ = ("values", "_lookup")

    def __init__(self, values: np.ndarray):
        self.values = values
        self._lookup = None

    def __len__(self) -> int:
        return len(self.values)

    def lookup(self, s) -> int:
        """Return the code for value ``s``, or -1 if absent."""
        if self._lookup is None:
            self._lookup = {v: i for i, v in enumerate(self.values)}
        return self._lookup.get(s, -1)

    def code_range_for_prefix(self, prefix: str):
        """[lo, hi) of codes whose value starts with ``prefix`` (sorted dict
        makes prefix predicates a 2-sided binary search)."""
        lo = int(np.searchsorted(self.values, prefix, side="left"))
        hi_key = prefix[:-1] + chr(ord(prefix[-1]) + 1) if prefix else None
        hi = int(np.searchsorted(self.values, hi_key, side="left")) if hi_key else len(self.values)
        return lo, hi

    @staticmethod
    def build(raw: np.ndarray):
        """Encode a host array of strings (dtype object, may contain None)
        into (codes int32, validity or None, Dictionary). Uses pandas
        factorize (hash-based, ~5x np.unique on object arrays) then sorts
        the dictionary to keep order-preserving codes."""
        import pandas as pd
        codes_u, uniq_u = pd.factorize(raw, use_na_sentinel=True)
        validity = codes_u >= 0
        all_valid = bool(validity.all())
        uniq_arr = np.asarray(uniq_u, dtype=object)
        order = np.argsort(uniq_arr.astype(str), kind="stable")
        rank = np.empty(len(order), dtype=np.int32)
        rank[order] = np.arange(len(order), dtype=np.int32)
        codes = rank[np.clip(codes_u, 0, None)] if len(order) else \
            np.zeros(len(raw), np.int32)
        if not all_valid:
            codes = np.where(validity, codes, 0).astype(np.int32)
        return (codes.astype(np.int32),
                None if all_valid else validity,
                Dictionary(uniq_arr[order]))

    def merge(self, other: "Dictionary"):
        """Merge two sorted dictionaries; returns (merged, remap_self,
        remap_other) where remap_x[i] is the new code of old code i."""
        sample = self.values[0] if len(self.values) else (
            other.values[0] if len(other.values) else "")
        # binary dictionaries hold bytes: keep them bytes ("S" compares
        # bytewise); str-ifying would corrupt the values (b'x' -> "b'x'")
        kind = "S" if isinstance(sample, (bytes, np.bytes_)) else str
        a = self.values.astype(kind)
        b = other.values.astype(kind)
        merged = np.unique(np.concatenate([a, b]))
        remap_self = np.searchsorted(merged, a).astype(np.int32)
        remap_other = np.searchsorted(merged, b).astype(np.int32)
        return Dictionary(merged.astype(object)), remap_self, remap_other


class Column:
    """One column of a batch. See module docstring for the representation."""

    __slots__ = ("dtype", "_data", "_validity", "dictionary",
                 "_host_cache", "_vhost_cache",
                 "_key_stats", "_uid", "_sorted_cache", "_unique_cache")

    _UID_COUNTER = [0]

    def __init__(self, dtype: DataType, data, validity=None,
                 dictionary: Optional[Dictionary] = None):
        self.dtype = dtype
        self._data = data
        self._validity = validity
        self.dictionary = dictionary
        # monotonic, never-recycled identity: cross-query device caches key
        # on this instead of id() so a replaced/updated table can never
        # alias a stale cache entry
        Column._UID_COUNTER[0] += 1
        self._uid = Column._UID_COUNTER[0]
        if dtype.is_dict_coded and dictionary is None:
            raise internal("dict-coded column without dictionary")

    # ---- basic props -------------------------------------------------------
    def __len__(self) -> int:
        return int(self._data.shape[0])

    def dense_key_stats(self):
        """(kmin, span) when this column holds UNIQUE integers in a
        bounded range (span <= 8*n and <= 2^24) — the contract the
        direct-address join fast path needs (a PK side probed via one
        LUT gather instead of hash + sort-based searchsorted; reference
        contrast: joins/hash_join.rs builds a chained hashmap
        unconditionally). None otherwise. Computed once per column and
        cached, so the O(n log n) host check amortizes across queries
        against a registered table."""
        cached = getattr(self, "_key_stats", None)
        if cached is not None:
            return cached if cached != () else None
        stats = ()
        if self.dtype.is_integer and not self.has_nulls and len(self) > 0:
            try:
                v = np.asarray(self.data_host(), dtype=np.int64)
            except (TypeError, ValueError, OverflowError):
                v = None
            if v is not None and v.ndim == 1:
                kmin = int(v.min())
                span = int(v.max()) - kmin + 1
                if span <= (1 << 24) and span <= 8 * len(v):
                    s = np.sort(v)
                    if s.shape[0] < 2 or bool(np.all(s[1:] != s[:-1])):
                        stats = (kmin, span)
        self._key_stats = stats
        return stats if stats != () else None

    @property
    def has_nulls(self) -> bool:
        return self._validity is not None

    def is_sorted_nondecreasing(self) -> bool:
        """True when this no-null numeric/temporal column is already
        non-decreasing (e.g. TPC-H lineitem.l_orderkey — dbgen emits the
        fact table ordered by its key). One O(n) host check, cached per
        column; lets group-aggregation skip the device argsort entirely
        (reference analog: GroupOrdering::Full, aggregates/order/full.rs)."""
        cached = getattr(self, "_sorted_cache", None)
        if cached is not None:
            return cached
        ok = False
        if not self.has_nulls and not self.dtype.is_string:
            try:
                v = self.data_host()
                ok = bool(v.ndim == 1 and
                          (len(v) < 2 or bool((v[1:] >= v[:-1]).all())))
            except (TypeError, ValueError):
                ok = False
        self._sorted_cache = ok
        return ok

    def is_unique_nonnull(self) -> bool:
        """True when this no-null integer column holds pairwise-distinct
        values (a primary key). One O(n log n) host check, cached per
        column; lets the join-chain fuser prefer build orders whose keys
        are provably unique (fanout-1) over row-count heuristics alone
        (reference analog: join key uniqueness from Statistics /
        distinct_count in join_selection.rs)."""
        cached = getattr(self, "_unique_cache", None)
        if cached is not None:
            return cached
        ok = False
        if not self.has_nulls and self.dtype.is_integer:
            try:
                v = self.data_host()
                if v.ndim == 1:
                    if self.is_sorted_nondecreasing():
                        ok = len(v) < 2 or bool((v[1:] > v[:-1]).all())
                    else:
                        s = np.sort(v)
                        ok = len(s) < 2 or bool((s[1:] > s[:-1]).all())
            except (TypeError, ValueError):
                ok = False
        self._unique_cache = ok
        return ok


    # ---- host arrays ------------------------------------------------------------
    @property
    def device_born(self) -> bool:
        """True when a kernel wrote this column on the card (its data is a
        torch tensor with no host original)."""
        return isinstance(self._data, torch.Tensor)

    def data_host(self) -> np.ndarray:
        if not self.device_born:
            return self._data
        host = getattr(self, "_host_cache", None)
        if host is None:
            host = self._host_cache = self._data.cpu().numpy()
        return host

    def validity_host(self) -> Optional[np.ndarray]:
        if self._validity is None or not self.device_born:
            return self._validity
        host = getattr(self, "_vhost_cache", None)
        if host is None:
            host = self._vhost_cache = self._validity.cpu().numpy()
        return host

    # ---- constructors --------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: Optional[DataType] = None,
                   validity: Optional[np.ndarray] = None) -> "Column":
        """Build a column from a host numpy array, inferring the logical type."""
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            if arr.dtype.kind in ("U", "S"):
                arr = arr.astype(object)
            codes, v, d = Dictionary.build(arr)
            if validity is not None:
                v = validity if v is None else (v & validity)
            return Column(dt.STRING, codes, v, d)
        if dtype is None:
            m = {"b": dt.BOOL, "i": {1: dt.INT8, 2: dt.INT16, 4: dt.INT32, 8: dt.INT64},
                 "u": {1: dt.UINT8, 2: dt.UINT16, 4: dt.UINT32, 8: dt.UINT64},
                 "f": {4: dt.FLOAT32, 8: dt.FLOAT64}}
            k = arr.dtype.kind
            if k == "b":
                dtype = dt.BOOL
            elif k in m:
                dtype = m[k][arr.dtype.itemsize]
            elif k == "M":  # datetime64
                unit = np.datetime_data(arr.dtype)[0]
                if unit == "D":
                    dtype = dt.DATE
                else:
                    dtype = dt.timestamp(unit if unit in ("s", "ms", "us", "ns") else "us")
                arr = arr.astype(np.int64) if dtype.id == TypeId.TIMESTAMP else arr.astype(np.int32)
            else:
                raise internal(f"cannot infer type for numpy dtype {arr.dtype}")
        want = dtype.device_dtype()
        if arr.dtype != want:
            arr = arr.astype(want)
        return Column(dtype, arr, validity)

    @staticmethod
    def from_scalar(sv, n: int) -> "Column":
        """Broadcast a ScalarValue to a length-n column (host)."""
        d = sv.dtype
        if d.id in (TypeId.LIST, TypeId.STRUCT):
            data = np.empty(n, dtype=object)
            for i in range(n):
                data[i] = sv.value
            validity = np.zeros(n, bool) if sv.value is None else None
            return Column(d, data, validity)
        if d.is_dict_coded:
            if sv.value is None:
                return Column(d, np.zeros(n, np.int32), np.zeros(n, bool),
                              Dictionary(np.array([], dtype=object)))
            dic = Dictionary(np.array([sv.value], dtype=object))
            return Column(d, np.zeros(n, np.int32), None, dic)
        v = sv.device_value()
        data = np.full(n, v, dtype=d.device_dtype())
        validity = np.zeros(n, bool) if sv.value is None else None
        return Column(d, data, validity)

    # ---- transformations -------------------------------------------------------
    def take_host(self, indices: np.ndarray) -> "Column":
        data = self.data_host()[indices]
        v = self._validity
        if v is not None:
            v = self.validity_host()[indices]
        return Column(self.dtype, data, v, self.dictionary)

    def filter_host(self, mask: np.ndarray) -> "Column":
        data = self.data_host()[mask]
        v = self._validity
        if v is not None:
            v = self.validity_host()[mask]
        return Column(self.dtype, data, v, self.dictionary)

    def slice_host(self, start: int, length: int) -> "Column":
        data = self.data_host()[start:start + length]
        v = self._validity
        if v is not None:
            v = self.validity_host()[start:start + length]
        return Column(self.dtype, data, v, self.dictionary)

    def with_dictionary_remap(self, new_dict: Dictionary, remap: np.ndarray) -> "Column":
        codes = self.data_host()
        if len(remap) == 0:
            # all rows are NULL (empty source dictionary): any code is dead
            return Column(self.dtype, np.zeros_like(codes),
                          self.validity_host(), new_dict)
        # clamp dead codes under NULL rows so the gather stays in range
        codes = np.clip(codes, 0, len(remap) - 1)
        return Column(self.dtype, remap[codes], self.validity_host(),
                      new_dict)

    # ---- host materialization -----------------------------------------------
    def to_pylist(self, n: Optional[int] = None):
        """Decode to python values (None for NULL). Used by result printing
        and the test oracle."""
        data = self.data_host()
        val = self.validity_host()
        n = len(data) if n is None else n
        out = []
        d = self.dtype
        for i in range(n):
            if val is not None and not val[i]:
                out.append(None)
                continue
            x = data[i]
            if d.id in (TypeId.LIST, TypeId.STRUCT):
                out.append(x)     # host object representation
            elif d.is_dict_coded:
                out.append(self.dictionary.values[int(x)])
            elif d.id == TypeId.DECIMAL:
                from decimal import Decimal as PyDecimal
                out.append(PyDecimal(int(x)).scaleb(-d.scale))
            elif d.id == TypeId.DATE:
                import datetime
                if d.unit == "ms":   # Date64 renders as a timestamp
                    out.append(datetime.datetime(1970, 1, 1)
                               + datetime.timedelta(milliseconds=int(x)))
                else:
                    try:
                        out.append(datetime.date(1970, 1, 1)
                                   + datetime.timedelta(days=int(x)))
                    except OverflowError:
                        # beyond datetime.date's year range: render like
                        # arrow ("+54719-05-25") via civil-from-days
                        z = int(x) + 719468
                        era = (z if z >= 0 else z - 146096) // 146097
                        doe = z - era * 146097
                        yoe = (doe - doe // 1460 + doe // 36524
                               - doe // 146096) // 365
                        y = yoe + era * 400
                        doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
                        mp = (5 * doy + 2) // 153
                        day = doy - (153 * mp + 2) // 5 + 1
                        month = mp + 3 if mp < 10 else mp - 9
                        y += month <= 2
                        sign = "+" if y > 9999 else ""
                        out.append(f"{sign}{y}-{month:02d}-{day:02d}")
            elif d.id == TypeId.TIMESTAMP:
                if d.tz:
                    # stored UTC; rendered in the column zone with its
                    # offset suffix (arrow Timestamp(_, Some(tz)) display)
                    from ..functions.datetime_helpers import format_timestamp
                    out.append(format_timestamp(int(x), d.unit or "ns",
                                                d.tz))
                else:
                    out.append(np.datetime64(int(x), d.unit))
            elif d.id == TypeId.TIME:
                import datetime
                ns = int(x) * {"s": 10**9, "ms": 10**6,
                               "us": 10**3, "ns": 1}[d.unit or "ns"]
                out.append(datetime.time(ns // 3600_000_000_000,
                                         ns // 60_000_000_000 % 60,
                                         ns // 1_000_000_000 % 60,
                                         ns % 1_000_000_000 // 1000))
            elif d.id == TypeId.INTERVAL:
                from ..functions.datetime_helpers import interval_display
                out.append(interval_display(int(x), d.unit))
            elif d.is_boolean:
                out.append(bool(x))
            elif d.is_float:
                out.append(float(x))
            else:
                out.append(int(x))
        return out


def concat_columns(cols: Sequence[Column]) -> Column:
    """Concatenate same-typed columns, merging string dictionaries."""
    if len(cols) == 1:
        return cols[0]
    d = cols[0].dtype
    if d.is_dict_coded:
        merged = cols[0].dictionary
        remaps = [np.arange(len(merged), dtype=np.int32)]
        for c in cols[1:]:
            merged, rs, ro = merged.merge(c.dictionary)
            remaps = [rs[r] for r in remaps]
            remaps.append(ro)
        datas = [r[np.clip(c.data_host(), 0, len(r) - 1)] if len(r)
                 else np.zeros(len(c), np.int32)
                 for r, c in zip(remaps, cols)]
    else:
        merged = None
        datas = [c.data_host() for c in cols]
    data = np.concatenate(datas)
    if any(c.has_nulls for c in cols):
        validity = np.concatenate([
            c.validity_host() if c.has_nulls else np.ones(len(c), bool) for c in cols])
    else:
        validity = None
    return Column(d, data, validity, merged)


# ---- device residency ---------------------------------------------------------

DeviceColumn = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # host arrays from a device fetch are read-only
        a = a.copy()
    return torch.from_numpy(a)


class DeviceColumnCache:
    """(column uid, device) -> (data, validity) device tensors, so repeated
    queries over a registered table skip the host-to-device copy."""

    def __init__(self):
        self._entries: Dict[Tuple[int, str], DeviceColumn] = {}

    def get(self, col: Column, device: torch.device) -> Optional[DeviceColumn]:
        return self._entries.get((col._uid, str(device)))

    def put(self, col: Column, device: torch.device, value: DeviceColumn):
        self._entries[(col._uid, str(device))] = value

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()


def to_device(col: Column, device: torch.device,
              cache: Optional[DeviceColumnCache] = None) -> DeviceColumn:
    """The column's (data, validity) on `device`; validity is None when
    the column has no NULLs. Cached in `cache` when one is given. A
    device-born column on `device` gives its own tensors: no copy, no
    cache entry."""
    if isinstance(col, Column) and col.device_born:
        v = col._validity
        return (col._data.to(device),
                None if v is None else v.to(device))
    if cache is not None:
        hit = cache.get(col, device)
        if hit is not None:
            return hit
    host = col.data_host()
    if host.dtype == object:
        raise TypeError(f"column of {col.dtype} has no device lane")
    data = _tensor(host).to(device)
    v = col.validity_host()
    valid = None if v is None else _tensor(np.asarray(v, bool)).to(device)
    if cache is not None:
        cache.put(col, device, (data, valid))
    return data, valid
