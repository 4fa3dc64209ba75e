"""Columnar compute kernels (host path).

These are the equivalents of arrow's compute kernels that the reference's
physical expressions dispatch to (`datafusion/physical-expr/src/expressions/
binary.rs` → arrow-rs compute). Here every kernel operates on `Column`
(dense array + optional validity + optional string Dictionary) and is fully
vectorized numpy; the device path traces the same logic with jnp (see
`datafusion_tpu.device.jitpath`).

Conventions:
* inputs are `Column`s of equal length (use `broadcast_scalar` first);
* NULL semantics: result validity = AND of input validities, except where
  SQL says otherwise (Kleene AND/OR, IS NULL, COALESCE, ...);
* data under invalid slots is arbitrary but must be in-range for the dtype
  (kernels never trap on masked lanes — same rule as masked TPU lanes).
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from ..common import dt
from ..common.column import Column, Dictionary
from ..common.datatypes import DataType, TypeId
from ..common.errors import ExecutionError, internal
from ..common.scalar import ScalarValue

# --------------------------------------------------------------------------
# validity helpers
# --------------------------------------------------------------------------

def and_validity(*vs: Optional[np.ndarray]) -> Optional[np.ndarray]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v.copy() if out is None else (out & v)
    return out


def valid_mask(col: Column) -> np.ndarray:
    v = col.validity_host()
    return np.ones(len(col), bool) if v is None else v


# --------------------------------------------------------------------------
# broadcasting & casting
# --------------------------------------------------------------------------

def broadcast_scalar(sv: ScalarValue, n: int) -> Column:
    return Column.from_scalar(sv, n)


def unify_dictionaries(a: Column, b: Column):
    """Remap two string columns onto one merged dictionary so code
    comparisons are meaningful."""
    if a.dictionary is b.dictionary:
        return a, b
    merged, ra, rb = a.dictionary.merge(b.dictionary)
    return a.with_dictionary_remap(merged, ra), b.with_dictionary_remap(merged, rb)


def decode_strings(col: Column) -> np.ndarray:
    """Dictionary codes -> host object array of python strings (NULL slots
    hold ''; mask separately)."""
    if len(col.dictionary) == 0:
        return np.full(len(col), "", dtype=object)
    codes = np.clip(col.data_host(), 0, len(col.dictionary) - 1)
    return col.dictionary.values[codes]


def encode_strings(raw: np.ndarray, validity: Optional[np.ndarray]) -> Column:
    """Host object array of str/None -> dictionary-coded string Column."""
    codes, v, dic = Dictionary.build(raw)
    return Column(dt.STRING, codes, and_validity(v, validity), dic)


def dict_map_bool(col: Column, fn) -> Column:
    """Evaluate a str->bool predicate once per dictionary entry, then gather
    by code. This is the core trick for LIKE/regex/string predicates: cost
    O(|dict|) host work + O(n) device gather."""
    lut = np.fromiter((bool(fn(v)) for v in col.dictionary.values),
                      dtype=bool, count=len(col.dictionary))
    if len(lut) == 0:
        data = np.zeros(len(col), bool)
    else:
        data = lut[np.clip(col.data_host(), 0, len(lut) - 1)]
    return Column(dt.BOOL, data, col.validity_host())


def dict_slice_str(col: Column, start0: int, length) -> Column:
    """Vectorized substring over the dictionary values: the object array
    converts once to a fixed-width '<UN' array, a '<U1' view slices the
    char window in C, and the window views back as '<Uw' (NUL padding
    terminates shorter strings correctly). Replaces the per-entry Python
    loop of dict_map_str for substr/left (TPC-H Q22's
    substring(c_phone,1,2) over a 110k-entry dictionary: ~160ms -> ~2ms).
    start0 is 0-based and must be >= 0; length None = to end."""
    vals = col.dictionary.values
    nvals = len(vals)
    if nvals == 0:
        return Column(dt.STRING, np.zeros(len(col), np.int32),
                      col.validity_host(),
                      Dictionary(np.array([], dtype=object)))
    u = vals.astype(str)
    nchar = u.dtype.itemsize // 4
    b = min(max(start0, 0), nchar)
    e = nchar if length is None else min(max(start0 + int(length), 0), nchar)
    if e <= b:
        new_vals = np.full(nvals, "", dtype=object)
    else:
        w = e - b
        m = np.ascontiguousarray(
            u.view("<U1").reshape(nvals, nchar)[:, b:e])
        new_vals = m.view(f"<U{w}").ravel().astype(object)
    uniq, inverse = np.unique(new_vals.astype(str), return_inverse=True)
    remap = inverse.astype(np.int32)
    codes = remap[np.clip(col.data_host(), 0, len(remap) - 1)]
    return Column(dt.STRING, codes, col.validity_host(),
                  Dictionary(uniq.astype(object)))


def dict_map_str(col: Column, fn) -> Column:
    """str->str function applied per dictionary entry; returns a new string
    column with a rebuilt (sorted) dictionary."""
    vals = col.dictionary.values
    new_vals = np.fromiter((fn(v) for v in vals), dtype=object, count=len(vals))
    if len(new_vals) == 0:
        return Column(dt.STRING, np.zeros(len(col), np.int32),
                      col.validity_host(), Dictionary(np.array([], dtype=object)))
    uniq, inverse = np.unique(new_vals.astype(str), return_inverse=True)
    remap = inverse.astype(np.int32)
    codes = remap[np.clip(col.data_host(), 0, len(remap) - 1)]
    return Column(dt.STRING, codes, col.validity_host(),
                  Dictionary(uniq.astype(object)))


def dict_map_values(col: Column, fn, out_type: DataType) -> Column:
    """str->scalar(out_type) function applied per dictionary entry."""
    vals = col.dictionary.values
    npdt = out_type.device_dtype()
    lut = np.fromiter((fn(v) for v in vals), dtype=npdt, count=len(vals))
    if len(lut) == 0:
        data = np.zeros(len(col), npdt)
    else:
        data = lut[np.clip(col.data_host(), 0, len(lut) - 1)]
    return Column(out_type, data, col.validity_host())


_TS_SCALE = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def cast_column(col: Column, to: DataType, safe: bool = False) -> Column:
    """CAST kernel. `safe=True` (TRY_CAST) yields NULL on failure instead of
    raising. Mirrors reference cast semantics (arrow cast + DataFusion
    decimal rules)."""
    frm = col.dtype
    if frm == to:
        return col
    n = len(col)
    validity = col.validity_host()
    data = col.data_host()

    if frm.is_null:
        dic = Dictionary(np.array([], dtype=object)) if to.is_string else None
        if to.is_nested:
            return Column(to, np.full(n, None, dtype=object),
                          np.zeros(n, bool), None)
        return Column(to, np.zeros(n, to.device_dtype()), np.zeros(n, bool), dic)

    if frm.is_string and to.id == TypeId.BINARY:
        # utf-8 bytes of each dictionary entry; codes unchanged
        vals = np.array([s.encode("utf-8") for s in col.dictionary.values],
                        dtype=object)
        return Column(to, data, validity, Dictionary(vals))
    if frm.id == TypeId.BINARY and to.is_string:
        vals = np.array([b.decode("utf-8", "replace")
                         for b in col.dictionary.values], dtype=object)
        return Column(to, data, validity, Dictionary(vals))

    if frm.is_string:
        # parse per dictionary entry
        def parse_factory():
            if to.is_boolean:
                def p(s):
                    s = s.strip().lower()
                    if s in ("true", "t", "yes", "1"): return True
                    if s in ("false", "f", "no", "0"): return False
                    raise ValueError(s)
                return p, np.bool_
            if to.is_integer:
                return (lambda s: int(s.strip())), to.device_dtype()
            if to.is_float:
                return (lambda s: float(s)), to.device_dtype()
            if to.is_decimal:
                from decimal import Decimal as D
                scale = to.scale
                return ((lambda s: int(D(s.strip()).scaleb(scale))),
                        to.device_dtype())   # object when wide
            if to.id == TypeId.DATE:
                import datetime as _d
                epoch = _d.date(1970, 1, 1)

                def parse_date(s):
                    # lenient like arrow: single-digit month/day allowed;
                    # full timestamp strings truncate to their date
                    t = s.strip()
                    if " " in t or "T" in t:
                        from ..functions.datetime_helpers import \
                            parse_timestamp_ns
                        ns = parse_timestamp_ns(t)
                        return (_d.date(1970, 1, 1)
                                + _d.timedelta(days=int(
                                    ns // (86_400 * 10**9)
                                    - (1 if ns < 0 and
                                       ns % (86_400 * 10**9) else 0))))
                    neg = t.startswith("-")
                    parts = (t[1:] if neg else t).split("-")
                    if len(parts) != 3:
                        raise ValueError(t)
                    y, m, d = (int(p) for p in parts)
                    return _d.date(-y if neg else y, m, d)
                if to.unit == "ms":   # Date64: epoch ms
                    def parse_date64(s):
                        t = s.strip()
                        if " " in t or "T" in t:
                            # arrow keeps the time-of-day in Date64 casts
                            from ..functions.datetime_helpers import \
                                parse_timestamp_ns
                            return parse_timestamp_ns(t) // 10**6
                        return (parse_date(t) - epoch).days * 86_400_000
                    return parse_date64, np.int64
                return (lambda s: (parse_date(s) - epoch).days), np.int32
            if to.id == TypeId.TIMESTAMP:
                from ..functions.datetime_helpers import parse_timestamp_ns
                div = 10**9 // _TS_SCALE[to.unit]
                return (lambda s: parse_timestamp_ns(s) // div), np.int64
            if to.id == TypeId.TIME:
                from ..functions.datetime_helpers import parse_time_ns
                div = 10**9 // _TS_SCALE[to.unit or "ns"]
                return (lambda s: parse_time_ns(s) // div), np.int64
            if to.id == TypeId.INTERVAL:
                from ..functions.datetime_helpers import pack_interval
                from ..sql.planner import parse_interval
                def p(s):
                    sv = parse_interval(s, None)
                    months, days, nanos = sv.value
                    return pack_interval(months, days, nanos)
                return p, to.device_dtype()   # packed i128 -> object
            raise ExecutionError(f"cast string -> {to} not supported")
        p, npdt = parse_factory()
        vals = col.dictionary.values
        lut = np.zeros(len(vals), npdt)
        bad = np.zeros(len(vals), bool)
        for i, s in enumerate(vals):
            try:
                lut[i] = p(s)
            except (ValueError, ArithmeticError, Exception) as e:  # noqa: BLE001
                if not safe:
                    # only raise if a *valid row* references this entry
                    refd = (data == i) if validity is None else ((data == i) & validity)
                    if refd.any():
                        raise ExecutionError(f"Cannot cast string '{s}' to {to}") from e
                bad[i] = True
        out = lut[np.clip(data, 0, max(len(lut) - 1, 0))] if len(lut) else np.zeros(n, npdt)
        v = validity
        if bad.any() and len(lut):
            v = and_validity(v, ~bad[np.clip(data, 0, len(lut) - 1)])
        return Column(to, out, v)

    if to.is_string:
        # render per row is unavoidable only for low-cardinality types; we
        # render from a per-distinct-value LUT to stay O(distinct).
        host_vals = Column(frm, data, None, col.dictionary).to_pylist(n)
        def render(x):
            if frm.is_boolean:
                return "true" if x else "false"
            if frm.is_float:
                return repr(float(x))
            return str(x)
        raw = np.fromiter((render(x) for x in host_vals), dtype=object, count=n)
        return encode_strings(raw, validity)

    def _decimal_fit(out_i64, v):
        """arrow validate_decimal_precision: |value| must need at most
        `to.precision` digits; overflow -> NULL (TRY_CAST) or error."""
        if to.precision >= 19 and not to.is_wide_decimal:
            return v     # anything in int64 fits 19+ digits
        cap = 10 ** to.precision
        ok = np.asarray(np.abs(out_i64) < cap, bool)
        if ok.all():
            return v
        if not safe:
            live = ok if v is None else (ok | ~v)
            if not live.all():
                bad = np.argmin(live)
                raise ExecutionError(
                    f"Cannot cast to {to}: value would overflow "
                    f"precision {to.precision} (row {bad})")
            return v
        return and_validity(v, ok)

    if frm.is_decimal and to.is_decimal:
        wide = frm.is_wide_decimal or to.is_wide_decimal
        src = data.astype(object) if wide else data.astype(np.int64)
        out = _rescale_decimal(src, frm.scale, to.scale)
        v = _decimal_fit(out, validity)
        return Column(to, out.astype(to.device_dtype()), v)
    if frm.is_decimal:
        if to.is_float:
            num = data.astype(np.float64) if not frm.is_wide_decimal else \
                np.array([float(x) for x in data], np.float64)
            return Column(to, (num / 10**frm.scale).astype(to.device_dtype()),
                          validity)
        if to.is_integer:
            src = data.astype(object) if frm.is_wide_decimal \
                else data.astype(np.int64)
            return Column(to, _rescale_decimal(src, frm.scale, 0)
                          .astype(to.device_dtype()), validity)
    if to.is_decimal:
        if frm.is_integer or frm.is_boolean:
            acc = object if to.is_wide_decimal else np.int64
            out = data.astype(acc) * 10**to.scale
            return Column(to, out, _decimal_fit(out, validity))
        if frm.is_float:
            scaled = np.round(data.astype(np.float64) * 10**to.scale)
            with np.errstate(invalid="ignore"):
                scaled = np.where(np.isfinite(scaled), scaled, 0.0)
            if to.is_wide_decimal:
                out = np.array([int(x) for x in scaled], object)
            else:
                out = scaled.astype(np.int64)
            return Column(to, out, _decimal_fit(out, validity))

    if frm.is_integer and to.id == TypeId.INTERVAL and \
            (to.unit or "").startswith("rawdur"):
        # arrow_cast(int, 'Duration(unit)'): the integer IS the unit count
        u = (to.unit or "rawdur_ns").split("_", 1)[1]
        mul = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}[u]
        return Column(to, data.astype(np.int64) * mul, validity)
    if (frm.is_float or frm.is_decimal) and to.id == TypeId.TIMESTAMP:
        # numeric seconds; decimals ride float64 like the reference's
        # coercion (including its last-digit rounding)
        secs = data.astype(np.float64) / (10 ** frm.scale) \
            if frm.is_decimal else data.astype(np.float64)
        return Column(to, (secs * _TS_SCALE[to.unit or "ns"])
                      .astype(np.int64), validity)
    if frm.id == TypeId.TIMESTAMP and to.id == TypeId.TIME:
        # time-of-day of the instant
        a, b = _TS_SCALE[frm.unit or "ns"], _TS_SCALE[to.unit or "ns"]
        sod = np.mod(data.astype(np.int64), 86400 * a)
        out = sod * (b // a) if b >= a else sod // (a // b)
        return Column(to, out.astype(np.int64), validity)
    if frm.id == TypeId.TIMESTAMP and to.id == TypeId.TIMESTAMP or \
            frm.id == TypeId.TIME and to.id == TypeId.TIME:
        a, b = _TS_SCALE[frm.unit or "ns"], _TS_SCALE[to.unit or "ns"]
        out = data * (b // a) if b >= a else data // (a // b)
        return Column(to, out.astype(np.int64), validity)
    if frm.id == TypeId.DATE and to.id == TypeId.DATE and frm.unit != to.unit:
        if to.unit == "ms":   # Date32 -> Date64
            return Column(to, data.astype(np.int64) * 86_400_000, validity)
        return Column(to, np.floor_divide(data, 86_400_000).astype(np.int32),
                      validity)
    if frm.id == TypeId.DATE and to.id == TypeId.TIMESTAMP:
        if frm.unit == "ms":   # Date64 holds epoch ms already
            return Column(to, data.astype(np.int64) * (_TS_SCALE[to.unit] // 1000)
                          if _TS_SCALE[to.unit] >= 1000 else
                          data.astype(np.int64) // (1000 // _TS_SCALE[to.unit]),
                          validity)
        return Column(to, data.astype(np.int64) * 86400 * _TS_SCALE[to.unit], validity)
    if frm.id == TypeId.TIMESTAMP and to.id == TypeId.DATE:
        day = 86400 * _TS_SCALE[frm.unit]
        days = np.floor_divide(data, day)
        if to.unit == "ms":
            return Column(to, days.astype(np.int64) * 86_400_000, validity)
        return Column(to, days.astype(np.int32), validity)
    if frm.id == TypeId.DATE and to.is_integer:
        return Column(to, data.astype(to.device_dtype()), validity)

    if (frm.is_numeric or frm.is_boolean or frm.is_temporal) and \
       (to.is_numeric or to.is_boolean or to.is_temporal):
        npdt = to.device_dtype()
        if to.is_integer and frm.is_float:
            with np.errstate(invalid="ignore"):
                rounded = np.where(np.isfinite(data), data, 0)
                out = rounded.astype(npdt)
            if safe:
                ok = np.isfinite(data)
                validity = and_validity(validity, ok)
        else:
            out = data.astype(npdt)
        return Column(to, out, validity)

    if frm.id == TypeId.STRUCT and to.id == TypeId.STRUCT and \
            len(frm.fields) == len(to.fields):
        # positional field cast + rename (VALUES -> declared DDL schema)
        tgt = to.fields

        def conv_struct(row):
            if row is None or not isinstance(row, dict):
                return None
            out_row = {}
            for (sn, _st), (tn, tt) in zip(frm.fields, tgt):
                v = row.get(sn)
                if v is not None and tt.is_integer:
                    v = int(v)
                elif v is not None and tt.is_float:
                    v = float(v)
                elif v is not None and tt.is_string:
                    v = str(v)
                out_row[tn] = v
            return out_row

        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = conv_struct(data[i])
        return Column(to, out, validity)

    if frm.id == TypeId.LIST and to.id == TypeId.LIST:
        # element-wise recursive cast over the python-list repr; a
        # List(Null) source (all-NULL literals) takes the target type
        inner_to = to.inner

        def conv(e):
            if e is None:
                return None
            if isinstance(e, list):
                return [conv(x) for x in e]
            if inner_to is not None and inner_to.is_integer:
                return int(e)
            if inner_to is not None and inner_to.is_float:
                return float(e)
            if inner_to is not None and inner_to.is_string:
                return str(e)
            return e

        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = None if data[i] is None else [conv(e) for e in data[i]]
        return Column(to, out, validity)

    raise ExecutionError(f"cast {frm} -> {to} not supported")


def _rescale_decimal(data: np.ndarray, from_scale: int, to_scale: int) -> np.ndarray:
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * 10**(to_scale - from_scale)
    div = 10**(from_scale - to_scale)
    # round half away from zero (matches reference decimal rounding)
    return np.sign(data) * ((np.abs(data) + div // 2) // div)


# --------------------------------------------------------------------------
# comparison
# --------------------------------------------------------------------------

_CMP = {
    "=": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}


def compare(op: str, l: Column, r: Column) -> Column:
    """Comparison kernel; handles string dictionary unification and numeric
    coercion. Returns BOOL column with AND'd validity."""
    if l.dtype.is_null or r.dtype.is_null:
        # comparison with typed NULL is NULL for every row
        return Column(dt.BOOL, np.zeros(len(l), bool), np.zeros(len(l), bool))
    if l.dtype.is_dict_coded or r.dtype.is_dict_coded:
        if not (l.dtype.is_dict_coded and r.dtype.is_dict_coded):
            # string vs other: coerce the string side (reference:
            # expr/src/type_coercion/binary.rs string-to-other comparison)
            if l.dtype.is_string and not r.dtype.id == TypeId.LIST:
                return compare(op, cast_column(l, r.dtype), r)
            if r.dtype.is_string and not l.dtype.id == TypeId.LIST:
                return compare(op, l, cast_column(r, l.dtype))
            raise ExecutionError(f"cannot compare {l.dtype} with {r.dtype}")
        l, r = unify_dictionaries(l, r)
        data = _CMP[op](l.data_host(), r.data_host())
        return Column(dt.BOOL, data, and_validity(l.validity_host(), r.validity_host()))
    common = _comparison_type(l.dtype, r.dtype)
    lc, rc = cast_column(l, common), cast_column(r, common)
    ld, rd = lc.data_host(), rc.data_host()
    data = _CMP[op](ld, rd)
    if common.is_float:
        # reference semantics (arrow-rs IEEE total order):
        # -NaN < -Inf < finite < Inf < NaN, and NaN == NaN (same sign)
        ln, rn = np.isnan(ld), np.isnan(rd)
        if ln.any() or rn.any():
            cl = np.where(ln, np.where(np.signbit(ld), -1, 1), 0)
            cr = np.where(rn, np.where(np.signbit(rd), -1, 1), 0)
            with np.errstate(invalid="ignore"):
                eqd = (ld == rd) | ((cl != 0) & (cl == cr))
                ltd = (cl < cr) | ((cl == cr) & (ld < rd))
            data = {"=": eqd, "!=": ~eqd, "<": ltd, "<=": ltd | eqd,
                    ">": ~(ltd | eqd), ">=": ~ltd}[op]
    return Column(dt.BOOL, data, and_validity(lc.validity_host(), rc.validity_host()))


def _comparison_type(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a.is_temporal or b.is_temporal:
        if a.id == TypeId.TIMESTAMP or b.id == TypeId.TIMESTAMP:
            # compare at the FINER precision so neither side truncates
            units = [x.unit or "ns" for x in (a, b)
                     if x.id == TypeId.TIMESTAMP]
            unit = max(units, key=lambda u: _TS_SCALE[u])
            tz = next((x.tz for x in (a, b)
                       if x.id == TypeId.TIMESTAMP and x.tz), None)
            return dt.timestamp(unit, tz=tz)
        if a.id == TypeId.TIME and b.id == TypeId.TIME:
            return a if _TS_SCALE[a.unit or "ns"] >= _TS_SCALE[b.unit or "ns"] else b
        return a if a.is_temporal else b
    if a.is_boolean and b.is_boolean:
        return dt.BOOL
    if a.is_null:
        return b
    if b.is_null:
        return a
    return dt.common_numeric_type(a, b)


def is_distinct_from(l: Column, r: Column, negated: bool) -> Column:
    """NULL-safe equality. Never returns NULL."""
    if l.dtype.is_dict_coded and r.dtype.is_dict_coded:
        l, r = unify_dictionaries(l, r)
        eq_data = l.data_host() == r.data_host()
    else:
        common = _comparison_type(l.dtype, r.dtype)
        lc, rc = cast_column(l, common), cast_column(r, common)
        eq_data = lc.data_host() == rc.data_host()
        if common.is_float:
            eq_data |= np.isnan(lc.data_host()) & np.isnan(rc.data_host())
        l, r = lc, rc
    lv, rv = valid_mask(l), valid_mask(r)
    same = (lv & rv & eq_data) | (~lv & ~rv)
    data = same if negated else ~same   # negated == IS NOT DISTINCT FROM
    return Column(dt.BOOL, data, None)


# --------------------------------------------------------------------------
# arithmetic
# --------------------------------------------------------------------------

def arith(op: str, l: Column, r: Column, out_type: DataType) -> Column:
    """+ - * / % with SQL semantics on the pre-computed output type."""
    validity = and_validity(l.validity_host(), r.validity_host())
    vm_l, vm_r = valid_mask(l), valid_mask(r)
    both = vm_l & vm_r

    # temporal arithmetic
    if out_type.id == TypeId.INTERVAL or l.dtype.is_temporal or r.dtype.is_temporal \
            or l.dtype.is_interval or r.dtype.is_interval:
        from ..functions import datetime_impl as dti
        return dti.temporal_arith(op, l, r, out_type, validity)

    if out_type.is_decimal:
        return _decimal_arith(op, l, r, out_type, validity, both)

    lc, rc = cast_column(l, out_type), cast_column(r, out_type)
    a, b = lc.data_host(), rc.data_host()
    if op == "+":
        data = a + b
    elif op == "-":
        data = a - b
    elif op == "*":
        data = a * b
    elif op == "/":
        if out_type.is_integer:
            zero = (b == 0) & both
            if zero.any():
                raise ExecutionError("Divide by zero")
            safe_b = np.where(b == 0, 1, b)
            q = np.abs(a) // np.abs(safe_b)   # SQL integer division truncates toward 0
            data = (np.sign(a) * np.sign(safe_b) * q).astype(a.dtype)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                data = a / b
    elif op == "%":
        zero = (b == 0) & both
        if out_type.is_integer and zero.any():
            raise ExecutionError("Divide by zero")
        safe_b = np.where(b == 0, 1, b) if out_type.is_integer else b
        with np.errstate(divide="ignore", invalid="ignore"):
            data = np.fmod(a, safe_b)    # SQL % truncates toward zero (fmod)
    else:
        raise internal(f"unknown arith op {op}")
    return Column(out_type, data.astype(out_type.device_dtype()), validity)


def _decimal_arith(op: str, l: Column, r: Column, out: DataType,
                   validity, both) -> Column:
    ls = l.dtype.scale if l.dtype.is_decimal else 0
    rs = r.dtype.scale if r.dtype.is_decimal else 0
    # wide decimals (or wide results) compute in exact Python ints
    acc = object if (out.is_wide_decimal or l.dtype.is_wide_decimal
                     or r.dtype.is_wide_decimal) else np.int64
    a = l.data_host().astype(acc) * (10 ** ls) \
        if not l.dtype.is_decimal else l.data_host().astype(acc)
    b = r.data_host().astype(acc) * (10 ** rs) \
        if not r.dtype.is_decimal else r.data_host().astype(acc)
    if op in ("+", "-"):
        s = max(ls, rs)
        a2, b2 = _rescale_decimal(a, ls, s), _rescale_decimal(b, rs, s)
        data = a2 + b2 if op == "+" else a2 - b2
        data = _rescale_decimal(data, s, out.scale)
    elif op == "*":
        data = _rescale_decimal(a * b, ls + rs, out.scale)
    elif op == "/":
        zero = (b == 0) & both
        if zero.any():
            raise ExecutionError("Divide by zero")
        safe_b = np.where(b == 0, 1, b)
        # a/b at out.scale: (a * 10^(out.scale - ls + rs)) / b — i128
        # division truncates toward zero (arrow-rs decimal div kernel)
        shift = out.scale - ls + rs
        if shift >= 0:
            num = a.astype(object) * (10**shift)
        else:
            num = _rescale_decimal(a, 0, 0).astype(object) // (10**(-shift))
        den = safe_b.astype(object)
        absn, absd = np.abs(num), np.abs(den)
        qabs = absn // absd
        sgn = np.sign(num) * np.sign(den)
        data = sgn * qabs   # object ints; width fixed at return
    elif op == "%":
        zero = (b == 0) & both
        if zero.any():
            raise ExecutionError("Divide by zero")
        s = max(ls, rs)
        a2, b2 = _rescale_decimal(a, ls, s), _rescale_decimal(b, rs, s)
        safe_b = np.where(b2 == 0, 1, b2)
        if acc is object:   # fmod semantics (sign of dividend) in exact ints
            data = np.sign(a2) * (np.abs(a2) % np.abs(safe_b))
        else:
            data = np.fmod(a2, safe_b)
        data = _rescale_decimal(data, s, out.scale)
    else:
        raise internal(f"unknown decimal op {op}")
    return Column(out, data.astype(out.device_dtype()), validity)


# --------------------------------------------------------------------------
# boolean logic (Kleene three-valued)
# --------------------------------------------------------------------------

def kleene_and(l: Column, r: Column) -> Column:
    a, b = l.data_host().astype(bool), r.data_host().astype(bool)
    av, bv = valid_mask(l), valid_mask(r)
    # NULL operand treated as True so a valid-FALSE other side still wins
    data = (a | ~av) & (b | ~bv)
    # valid iff both valid, or either side is a valid FALSE
    validity = (av & bv) | (av & ~a) | (bv & ~b)
    return Column(dt.BOOL, data, None if validity.all() else validity)


def kleene_or(l: Column, r: Column) -> Column:
    a, b = l.data_host().astype(bool), r.data_host().astype(bool)
    av, bv = valid_mask(l), valid_mask(r)
    true_l = av & a
    true_r = bv & b
    data = true_l | true_r
    validity = (av & bv) | true_l | true_r
    return Column(dt.BOOL, data, None if validity.all() else validity)


def logical_not(c: Column) -> Column:
    return Column(dt.BOOL, ~c.data_host().astype(bool), c.validity_host())


def true_mask(c: Column) -> np.ndarray:
    """BOOL column -> selection mask (NULL counts as False). The SQL filter
    semantics: keep rows where predicate IS TRUE."""
    return c.data_host().astype(bool) & valid_mask(c)


# --------------------------------------------------------------------------
# LIKE
# --------------------------------------------------------------------------

def like_pattern_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out, i = [], 0
    esc = escape
    while i < len(pattern):
        ch = pattern[i]
        if esc and ch == esc and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def like(col: Column, pattern: str, negated: bool, case_insensitive: bool,
         escape: Optional[str] = None) -> Column:
    lut = None
    if escape is None:
        from ..native import like_bulk
        lut = like_bulk(col.dictionary.values, pattern, case_insensitive)
    if lut is not None:
        if len(lut) == 0:
            data = np.zeros(len(col), bool)
        else:
            data = lut[np.clip(col.data_host(), 0, len(lut) - 1)]
        out = Column(dt.BOOL, data, col.validity_host())
    else:
        flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
        rx = re.compile(like_pattern_to_regex(pattern, escape), flags)
        out = dict_map_bool(col, lambda s: rx.match(s) is not None)
    if negated:
        return logical_not(out)
    return out


# --------------------------------------------------------------------------
# selection / coalesce
# --------------------------------------------------------------------------

def select(mask: np.ndarray, then: Column, else_: Column) -> Column:
    """Row-wise select (CASE): mask True -> then, False -> else_."""
    if then.dtype.is_string or else_.dtype.is_string:
        t, e = unify_dictionaries(then, else_)
        data = np.where(mask, t.data_host(), e.data_host())
        tv, ev = valid_mask(t), valid_mask(e)
        validity = np.where(mask, tv, ev)
        return Column(t.dtype, data.astype(np.int32),
                      None if validity.all() else validity, t.dictionary)
    out_t = then.dtype if not then.dtype.is_null else else_.dtype
    if then.dtype != else_.dtype and then.dtype.is_numeric and else_.dtype.is_numeric:
        out_t = dt.common_numeric_type(then.dtype, else_.dtype)
    t = cast_column(then, out_t) if not then.dtype.is_null else then
    e = cast_column(else_, out_t) if not else_.dtype.is_null else else_
    data = np.where(mask, t.data_host().astype(out_t.device_dtype()),
                    e.data_host().astype(out_t.device_dtype()))
    tv = valid_mask(t) if not then.dtype.is_null else np.zeros(len(then), bool)
    ev = valid_mask(e) if not else_.dtype.is_null else np.zeros(len(else_), bool)
    validity = np.where(mask, tv, ev)
    return Column(out_t, data, None if validity.all() else validity)
