"""Scalar function kernels.

Reference parity: `datafusion/functions/src/{math,core,string,unicode,
datetime,regex,crypto}` (SURVEY.md §2.3). Numeric/temporal functions are
vectorized over device-representation arrays; string functions run once per
dictionary entry (O(|dict|) host work) and gather by code.
"""
from __future__ import annotations

import math
import re
from typing import List, Optional

import numpy as np

from ..common import dt
from ..common.column import Column, Dictionary
from ..common.datatypes import DataType, TypeId
from ..common.errors import ExecutionError
from ..common.scalar import ScalarValue
from ..functions import datetime_impl as dti
from . import kernels as K


def _f64(c: Column) -> np.ndarray:
    return K.cast_column(c, dt.FLOAT64).data_host()


def _unary_float(fn, cols, out_type=None):
    c = cols[0]
    x = _f64(c)
    with np.errstate(all="ignore"):
        out = fn(x)
    v = c.validity_host()
    if out_type is not None and out_type == dt.FLOAT32:
        # f32-preserving math (reference math fns return Float32 for
        # Float32 input); round-trip through f32 so results match bit-wise
        return Column(dt.FLOAT32, out.astype(np.float32), v)
    return Column(dt.FLOAT64, out, v)


def _lit(e) -> Optional[ScalarValue]:
    from .expressions import LiteralExpr
    if e is not None and isinstance(e, LiteralExpr):
        return e.value
    return None


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

# Functions where a NULL argument does NOT force a NULL result
# (reference: each function's `invoke` handles nulls; most use the
# null-propagating columnar kernels, these are the exceptions).
_NULL_TOLERANT = {
    "concat", "concat_ws", "coalesce", "nvl", "nvl2", "ifnull", "nullif",
    "struct", "named_struct", "row", "arrow_typeof", "make_array",
    "make_list", "range", "generate_series", "arrow_cast", "version",
    "isnan", "iszero", "array", "get_field", "greatest", "least",
    # to_char(NULL, fmt) renders the empty string, not NULL (reference
    # to_char.rs null-value handling)
    "to_char", "date_format",
}


# Functions that must ERROR on NULL arguments rather than propagate NULL
# (reference make_date.rs: null parts become 0 and fail date parsing with
# "Unable to parse date from ...").
_ERROR_ON_NULL = {"make_date"}


def _null_propagated(name: str, cols: List[Column], out_type: DataType,
                     n: int) -> Optional[Column]:
    """All-NULL result when any argument is the NULL literal / an all-null
    scalar (SQL strict-function semantics, e.g. lpad('hi', NULL))."""
    if name in _NULL_TOLERANT or name in _ERROR_ON_NULL \
            or name.startswith(("array_", "list_")):
        return None
    if n == 0:
        return None
    for c in cols:
        if c.dtype.id == TypeId.NULL or \
                (c.has_nulls and not np.any(K.valid_mask(c))):
            return Column.from_scalar(
                ScalarValue(out_type if out_type.id != TypeId.NULL
                            else dt.NULL, None), n)
    return None


def dispatch(name: str, cols: List[Column], out_type: DataType, n: int,
             arg_exprs=None) -> Column:
    from ..functions.udf import SCALAR_UDFS
    udf = SCALAR_UDFS.get(name)
    if udf is not None:
        return _call_udf(udf, cols, out_type, n)
    fn = _IMPLS.get(name)
    if fn is None:
        raise ExecutionError(f"scalar function '{name}' is not implemented")
    nulled = _null_propagated(name, cols, out_type, n)
    if nulled is not None:
        return nulled
    return fn(cols, out_type, n, arg_exprs)


def _call_udf(udf, cols: List[Column], out_type: DataType, n: int) -> Column:
    args = []
    for c in cols:
        if c.dtype.is_string:
            args.append(K.decode_strings(c))
        else:
            args.append(c.data_host())
    raw = np.asarray(udf.fn(*args))
    validity = K.and_validity(*[c.validity_host() for c in cols])
    if out_type.is_string:
        return K.encode_strings(raw.astype(object), validity)
    return Column(out_type, raw.astype(out_type.device_dtype()), validity)


# --------------------------------------------------------------------------
# math
# --------------------------------------------------------------------------

def _impl_abs(cols, out_type, n, _):
    if len(cols) != 1:
        raise ExecutionError(
            f"function abs expected 1 argument, got {len(cols)}")
    c = cols[0]
    d = c.data_host()
    if c.dtype.is_integer:
        # abs(INT_MIN) overflows (reference: arrow checked abs) — bound by
        # the LOGICAL type (int8/16 widen to int32 in the host layout)
        bits = {"int8": 8, "int16": 16, "int32": 32, "int64": 64}.get(
            c.dtype.id.value, 64)
        lo = -(1 << (bits - 1))
        v = c.validity_host()
        live = d if v is None else d[v]
        if len(live) and (live == lo).any():
            raise ExecutionError(f"Overflow happened on ABS({lo})")
    with np.errstate(all="ignore"):
        out = np.abs(d)
    return Column(c.dtype, out, c.validity_host())


def _impl_round(cols, out_type, n, _):
    c = cols[0]
    if len(cols) > 1:
        draw = cols[1].data_host().astype(np.int64)
        # reference round.rs casts decimal places to Int32 and errors on
        # overflow ("Invalid values for decimal places: Cast error: ...")
        over = (draw > 2**31 - 1) | (draw < -2**31)
        if over.any():
            i = int(np.nonzero(over)[0][0])
            raise ExecutionError(
                "Invalid values for decimal places: Cast error: Can't cast "
                f"value {int(draw[i])} to type Int32")
        digits_arr = draw
        digits = int(draw[0]) if len(draw) else 0
    else:
        digits_arr = np.zeros(max(n, 1), np.int64)
        digits = 0
    if c.dtype.is_decimal:
        s = c.dtype.scale
        if digits >= s:
            return c
        from .kernels import _rescale_decimal
        scaled = _rescale_decimal(c.data_host(), s, digits)
        return Column(c.dtype, _rescale_decimal(scaled, digits, s), c.validity_host())
    if c.dtype.is_integer:
        return c
    x = c.data_host()
    # SQL round: half away from zero (numpy rounds half-to-even);
    # per-row decimal places supported like the reference. Compute natively
    # in the input float width (round.rs f32 path: value * 10f32.powi(d)),
    # so f32 values a hair under .5 ULP-round up like Rust.
    if len(cols) > 1 and len(digits_arr) == len(x):
        factor = np.power(np.asarray(10.0, x.dtype),
                          digits_arr.astype(x.dtype))
    else:
        factor = np.asarray(10.0, x.dtype) ** np.asarray(digits, x.dtype)
    scaled = x * factor
    out = (np.sign(scaled) * np.floor(np.abs(scaled)
                                      + np.asarray(0.5, x.dtype))) / factor
    return Column(c.dtype, out.astype(c.dtype.device_dtype()), c.validity_host())


def _impl_ceilfloor(which):
    def impl(cols, out_type, n, _):
        c = cols[0]
        if c.dtype.is_integer:
            return c
        if c.dtype.is_decimal:
            s = 10 ** c.dtype.scale
            x = c.data_host()
            q = np.floor_divide(x, s) if which == "floor" else -np.floor_divide(-x, s)
            return Column(c.dtype, q * s, c.validity_host())
        f = np.floor if which == "floor" else np.ceil
        return Column(c.dtype, f(c.data_host()), c.validity_host())
    return impl


def _impl_trunc(cols, out_type, n, _):
    """trunc(x[, decimals]) — truncate toward zero at `decimals` places
    (reference: functions/src/math/trunc.rs, per-row second argument)."""
    c = cols[0]
    if c.dtype.is_integer:
        return c
    x = c.data_host()
    if len(cols) > 1:
        # reference compute_truncate32/64 (trunc.rs:158-166): with a
        # precision argument trunc actually ROUNDS half-away-from-zero at
        # that digit, computed natively in the input float width
        d = cols[1].data_host().astype(np.int64)
        factor = np.power(np.asarray(10.0, x.dtype),
                          d.astype(x.dtype))
        scaled = x * factor
        out = (np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)) / factor
    else:
        out = np.trunc(x)
    return Column(c.dtype, out.astype(c.dtype.device_dtype()),
                  c.validity_host())


def _impl_sign(cols, out_type, n, _):
    c = cols[0]
    return Column(c.dtype, np.sign(c.data_host()), c.validity_host())


def _impl_power(cols, out_type, n, _):
    validity = K.and_validity(cols[0].validity_host(),
                              cols[1].validity_host())
    if cols[0].dtype.is_integer and cols[1].dtype.is_integer:
        # int ^ int stays Int64 and errors on overflow (reference:
        # functions/src/math/power.rs via arrow checked pow)
        a = cols[0].data_host().astype(np.int64)
        b = cols[1].data_host().astype(np.int64)
        with np.errstate(all="ignore"):
            approx = np.abs(a.astype(np.float64)) ** b.astype(np.float64)
        live = np.ones(len(a), bool) if validity is None else validity
        bad = live & (np.abs(b) * np.log2(np.maximum(np.abs(a), 1)) > 62)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            raise ExecutionError(
                f"Overflow happened on: {int(a[i])} ^ {int(b[i])}")
        out = np.power(a, np.maximum(b, 0))
        return Column(dt.INT64, out, validity)
    a, b = _f64(cols[0]), _f64(cols[1])
    with np.errstate(all="ignore"):
        out = np.power(a, b)
    return Column(dt.FLOAT64, out, validity)


def _binary_float(fn, cols, out_type):
    """Binary math with one_of([F32,F32],[F64,F64]) coercion (reference
    atan2/nanvl/log, macros.rs:295-299). Compute in f64, round-trip the
    result through f32 for the Float32 signature — matches the slt
    expectations (f64-accurate value displayed at f32 precision)."""
    a, b = _f64(cols[0]), _f64(cols[1])
    v = K.and_validity(cols[0].validity_host(), cols[1].validity_host())
    with np.errstate(all="ignore"):
        out = fn(a, b)
    if out_type == dt.FLOAT32:
        return Column(dt.FLOAT32, out.astype(np.float32), v)
    return Column(dt.FLOAT64, out, v)


def _impl_atan2(cols, out_type, n, _):
    return _binary_float(np.arctan2, cols, out_type)


def _impl_log(cols, out_type, n, _):
    if len(cols) == 2:   # log(base, x)
        return _binary_float(lambda base, x: np.log(x) / np.log(base),
                             cols, out_type)
    return _unary_float(np.log10, cols, out_type)


def _impl_nanvl(cols, out_type, n, _):
    return _binary_float(lambda x, y: np.where(np.isnan(x), y, x),
                         cols, out_type)


def _impl_isnan(cols, out_type, n, _):
    return Column(dt.BOOL, np.isnan(_f64(cols[0])), cols[0].validity_host())


def _impl_iszero(cols, out_type, n, _):
    return Column(dt.BOOL, _f64(cols[0]) == 0.0, cols[0].validity_host())


def _impl_pi(cols, out_type, n, _):
    return Column(dt.FLOAT64, np.full(n, math.pi), None)


def _impl_random(cols, out_type, n, _):
    return Column(dt.FLOAT64, np.random.random(n), None)


def _impl_factorial(cols, out_type, n, _):
    x = cols[0].data_host().astype(np.int64)
    v = cols[0].validity_host()
    live = x if v is None else x[v]
    if len(live) and live.max(initial=0) > 20:
        # 21! overflows int64 (reference: arrow compute error)
        raise ExecutionError(
            f"Overflow happened on FACTORIAL({int(live.max())})")
    out = np.ones(len(x), np.int64)
    for k in range(2, min(int(x.max(initial=1)), 20) + 1):
        out = np.where(x >= k, out * k, out)
    return Column(dt.INT64, out, v)


def _impl_gcd(cols, out_type, n, _):
    a = cols[0].data_host().astype(np.int64)
    b = cols[1].data_host().astype(np.int64)
    validity = K.and_validity(cols[0].validity_host(),
                              cols[1].validity_host())
    live = np.ones(len(a), bool) if validity is None else validity
    m_ = np.iinfo(np.int64).min
    # gcd(INT64_MIN, 0)/gcd(INT64_MIN, INT64_MIN) = |INT64_MIN|: overflow
    bad = live & (((a == m_) & ((b == 0) | (b == m_)))
                  | ((b == m_) & (a == 0)))
    if bad.any():
        raise ExecutionError(
            "Signed integer overflow in GCD(-9223372036854775808, ...)")
    return Column(dt.INT64, np.gcd(a, b), validity)


def _impl_lcm(cols, out_type, n, _):
    a = cols[0].data_host().astype(np.int64)
    b = cols[1].data_host().astype(np.int64)
    validity = K.and_validity(cols[0].validity_host(),
                              cols[1].validity_host())
    live = np.ones(len(a), bool) if validity is None else validity
    # checked lcm: |a*b|/gcd must fit int64 (reference: checked ops)
    g = np.gcd(a, b)
    safe_g = np.where(g == 0, 1, g)
    with np.errstate(all="ignore"):
        approx = np.abs(a.astype(np.float64) / safe_g) * np.abs(
            b.astype(np.float64))
    m_ = np.iinfo(np.int64).min
    bad = live & ((approx > np.iinfo(np.int64).max) | (a == m_) | (b == m_))
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ExecutionError(
            f"Signed integer overflow in LCM({int(a[i])}, {int(b[i])})")
    out = np.where(g == 0, 0, np.abs(a // safe_g * b))
    return Column(dt.INT64, out, validity)


def _impl_mod(cols, out_type, n, _):
    return K.arith("%", cols[0], cols[1], out_type)


# --------------------------------------------------------------------------
# core: coalesce / nullif / nvl
# --------------------------------------------------------------------------

def _impl_coalesce(cols, out_type, n, _):
    acc = cols[-1]
    for c in reversed(cols[:-1]):
        mask = K.valid_mask(c)
        acc = K.select(mask, c, acc)
    return acc


def _impl_nullif(cols, out_type, n, _):
    a, b = cols
    eq = K.true_mask(K.compare("=", a, b))
    v = K.valid_mask(a) & ~eq
    return Column(a.dtype, a.data_host(), None if v.all() else v, a.dictionary)


def _impl_nvl(cols, out_type, n, _):
    a, b = cols[0], cols[1]
    return K.select(K.valid_mask(a), a, b)


def _impl_nvl2(cols, out_type, n, _):
    a, b, c = cols
    return K.select(K.valid_mask(a), b, c)


def _impl_arrow_typeof(cols, out_type, n, _):
    name = str(cols[0].dtype)
    dic = Dictionary(np.array([name], dtype=object))
    return Column(dt.STRING, np.zeros(n, np.int32), None, dic)


# --------------------------------------------------------------------------
# strings
# --------------------------------------------------------------------------

def string_concat(l: Column, r: Column) -> Column:
    ls = K.decode_strings(l) if l.dtype.is_string else np.array(
        [str(x) for x in l.to_pylist()], dtype=object)
    rs = K.decode_strings(r) if r.dtype.is_string else np.array(
        [str(x) for x in r.to_pylist()], dtype=object)
    out = np.fromiter((a + b for a, b in zip(ls, rs)), dtype=object, count=len(ls))
    return K.encode_strings(out, K.and_validity(l.validity_host(), r.validity_host()))


def _impl_concat(cols, out_type, n, _):
    # concat ignores NULL args (treats as '')
    parts = []
    for c in cols:
        s = K.decode_strings(c) if c.dtype.is_string else np.array(
            [str(x) if x is not None else "" for x in c.to_pylist()], dtype=object)
        if c.has_nulls:
            m = K.valid_mask(c)
            s = np.where(m, s, "")
        parts.append(s)
    out = parts[0].astype(object)
    for p in parts[1:]:
        out = np.fromiter((a + b for a, b in zip(out, p)), dtype=object, count=n)
    return K.encode_strings(out, None)


def _impl_concat_ws(cols, out_type, n, _):
    sep = K.decode_strings(cols[0])
    parts = [K.decode_strings(c) for c in cols[1:]]
    masks = [K.valid_mask(c) for c in cols[1:]]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = sep[i].join(p[i] for p, m in zip(parts, masks) if m[i])
    return K.encode_strings(out, cols[0].validity_host())


def _str_unary(fn):
    def impl(cols, out_type, n, _):
        return K.dict_map_str(cols[0], fn)
    return impl


def _str_to_int(fn):
    def impl(cols, out_type, n, _):
        return K.dict_map_values(cols[0], fn, out_type)
    return impl


def _scalar_args(cols, arg_exprs, start=1):
    """Extract trailing scalar (literal-broadcast) args as python values."""
    out = []
    for i in range(start, len(cols)):
        c = cols[i]
        if c.dtype.is_string:
            vals = K.decode_strings(c)
            out.append(vals[0] if len(vals) else "")
        else:
            out.append(c.to_pylist(1)[0] if len(c) else None)
    return out


def _impl_substr(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    start = int(args[0])
    length = int(args[1]) if len(args) > 1 else None
    if start >= 1 and (length is None or length >= 0):
        # common case: fully vectorized char-window slice over the dict
        return K.dict_slice_str(cols[0], start - 1, length)

    def f(s):
        # SQL substr: 1-based; start<1 shifts window
        b = start - 1
        if length is None:
            return s[max(b, 0):]
        e = b + length
        return s[max(b, 0):max(e, 0)]
    return K.dict_map_str(cols[0], f)


def _impl_left(cols, out_type, n, arg_exprs):
    k = int(_scalar_args(cols, arg_exprs)[0])
    if k >= 0:
        return K.dict_slice_str(cols[0], 0, k)
    return K.dict_map_str(cols[0], lambda s: s[:len(s) + k])


def _impl_right(cols, out_type, n, arg_exprs):
    k = int(_scalar_args(cols, arg_exprs)[0])
    return K.dict_map_str(cols[0], lambda s: s[-k:] if k > 0 else (s[-k:] if k < 0 else ""))


def _impl_lpad(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    k = max(int(args[0]), 0); fill = args[1] if len(args) > 1 else " "
    def f(s):
        if len(s) >= k:
            return s[:k]
        pad = (fill * k)[: k - len(s)] if fill else s
        return pad + s
    return K.dict_map_str(cols[0], f)


def _impl_rpad(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    k = max(int(args[0]), 0); fill = args[1] if len(args) > 1 else " "
    def f(s):
        if len(s) >= k:
            return s[:k]
        pad = (fill * k)[: k - len(s)] if fill else s
        return s + pad
    return K.dict_map_str(cols[0], f)


def _rowwise_strings(cols, n):
    """Decode every arg row-wise: string args -> object arrays, others ->
    host values; plus a combined validity mask."""
    vals, mask = [], np.ones(n, bool)
    for c in cols:
        vals.append(K.decode_strings(c) if c.dtype.is_string
                    else K.cast_column(c, dt.INT64).data_host()
                    if c.dtype.is_integer or c.dtype.is_boolean
                    else c.data_host())
        mask &= K.valid_mask(c)
    return vals, mask


def _impl_substring_index(cols, out_type, n, arg_exprs):
    """substring_index(str, delim, count) — MySQL semantics (reference:
    functions/src/unicode/substrindex.rs)."""
    (s, d, cnt), mask = _rowwise_strings(cols, n)
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not mask[i]:
            out[i] = None
            continue
        si, di, ci = s[i], d[i], int(cnt[i])
        if ci == 0 or not si or not di:
            out[i] = ""
        else:
            parts = si.split(di)
            out[i] = di.join(parts[:ci] if ci > 0 else parts[ci:])
    return K.encode_strings(out, mask if not mask.all() else None)


def _impl_find_in_set(cols, out_type, n, arg_exprs):
    """find_in_set(str, strlist) — 1-based position in the comma list, 0
    when absent (reference: functions/src/unicode/find_in_set.rs)."""
    (s, lst), mask = _rowwise_strings(cols, n)
    out = np.zeros(n, np.int64)
    for i in range(n):
        if mask[i]:
            items = lst[i].split(",")
            out[i] = items.index(s[i]) + 1 if s[i] in items else 0
    return Column(out_type if out_type.is_integer else dt.INT64, out,
                  None if mask.all() else mask)


def _impl_overlay(cols, out_type, n, arg_exprs):
    """overlay(str PLACING chars FROM pos [FOR len]) (reference:
    functions/src/string/overlay.rs)."""
    vals, mask = _rowwise_strings(cols, n)
    s, ch, pos = vals[0], vals[1], vals[2]
    ln = vals[3] if len(vals) > 3 else None
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not mask[i]:
            out[i] = None
            continue
        p = int(pos[i])
        slen = len(s[i])
        # replace_len: chars length for the 3-arg form; min(len, |s|) for
        # the 4-arg form; prefix/suffix gated exactly like the reference
        # (overlay.rs:106-120,145-159 — pos beyond |s| drops the prefix)
        repl = min(int(ln[i]), slen) if ln is not None else len(ch[i])
        res = ""
        if p > 1 and p - 1 < slen:
            res += s[i][:p - 1]
        res += ch[i]
        if p + repl - 1 < slen:
            res += s[i][p + repl - 1:]
        out[i] = res
    return K.encode_strings(out, mask if not mask.all() else None)


def _impl_replace(cols, out_type, n, arg_exprs):
    frm, to = _scalar_args(cols, arg_exprs)
    return K.dict_map_str(cols[0], lambda s: s.replace(frm, to))


def _impl_translate(cols, out_type, n, arg_exprs):
    frm, to = _scalar_args(cols, arg_exprs)
    table = str.maketrans(frm[:len(to)], to[:len(frm)], frm[len(to):])
    return K.dict_map_str(cols[0], lambda s: s.translate(table))


def _impl_split_part(cols, out_type, n, arg_exprs):
    sep, idx = _scalar_args(cols, arg_exprs)
    idx = int(idx)
    def f(s):
        parts = s.split(sep)
        i = idx - 1 if idx > 0 else len(parts) + idx
        return parts[i] if 0 <= i < len(parts) else ""
    return K.dict_map_str(cols[0], f)


def _impl_repeat(cols, out_type, n, arg_exprs):
    k = int(_scalar_args(cols, arg_exprs)[0])
    return K.dict_map_str(cols[0], lambda s: s * max(k, 0))


def _impl_starts_with(cols, out_type, n, arg_exprs):
    p = _scalar_args(cols, arg_exprs)[0]
    return K.dict_map_bool(cols[0], lambda s: s.startswith(p))


def _impl_ends_with(cols, out_type, n, arg_exprs):
    p = _scalar_args(cols, arg_exprs)[0]
    return K.dict_map_bool(cols[0], lambda s: s.endswith(p))


def _impl_contains(cols, out_type, n, arg_exprs):
    p = _scalar_args(cols, arg_exprs)[0]
    return K.dict_map_bool(cols[0], lambda s: p in s)


def _impl_strpos(cols, out_type, n, arg_exprs):
    p = _scalar_args(cols, arg_exprs)[0]
    return K.dict_map_values(cols[0], lambda s: s.find(p) + 1, dt.INT32)


def _impl_btrim(cols, out_type, n, arg_exprs):
    chars = _scalar_args(cols, arg_exprs)[0] if len(cols) > 1 else None
    return K.dict_map_str(cols[0], lambda s: s.strip(chars))


def _impl_ltrim(cols, out_type, n, arg_exprs):
    chars = _scalar_args(cols, arg_exprs)[0] if len(cols) > 1 else None
    return K.dict_map_str(cols[0], lambda s: s.lstrip(chars))


def _impl_rtrim(cols, out_type, n, arg_exprs):
    chars = _scalar_args(cols, arg_exprs)[0] if len(cols) > 1 else None
    return K.dict_map_str(cols[0], lambda s: s.rstrip(chars))


def _impl_initcap(cols, out_type, n, _):
    rx = re.compile(r"[a-zA-Z0-9]+")
    return K.dict_map_str(cols[0], lambda s: rx.sub(lambda m: m.group(0).capitalize(), s))


def _impl_chr(cols, out_type, n, _):
    codes = cols[0].data_host().astype(np.int64)
    out = np.fromiter((chr(int(c)) if c > 0 else "" for c in codes),
                      dtype=object, count=len(codes))
    return K.encode_strings(out, cols[0].validity_host())


def _impl_to_hex(cols, out_type, n, _):
    x = cols[0].data_host().astype(np.int64)
    out = np.fromiter((format(int(v) & 0xFFFFFFFFFFFFFFFF, "x") for v in x),
                      dtype=object, count=len(x))
    return K.encode_strings(out, cols[0].validity_host())


def _impl_levenshtein(cols, out_type, n, arg_exprs):
    import difflib  # noqa: F401
    def lev(a, b):
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]
    a = K.decode_strings(cols[0])
    b = K.decode_strings(cols[1])
    out = np.fromiter((lev(x, y) for x, y in zip(a, b)), dtype=np.int32, count=n)
    return Column(dt.INT32, out, K.and_validity(cols[0].validity_host(),
                                                cols[1].validity_host()))


def _impl_uuid(cols, out_type, n, _):
    import uuid
    out = np.fromiter((str(uuid.uuid4()) for _ in range(n)), dtype=object, count=n)
    return K.encode_strings(out, None)


# --------------------------------------------------------------------------
# regex
# --------------------------------------------------------------------------

def _regex_flags(flags_str: str) -> int:
    f = 0
    for ch in flags_str or "":
        f |= {"i": re.IGNORECASE, "s": re.DOTALL, "m": re.MULTILINE,
              "x": re.VERBOSE}.get(ch, 0)
    return f


import regex as _regex_mod


def _regexp_compile(pat, flags):
    return _regex_mod.compile(pat, _regex_flags(_regexp_check_flags(flags)))


def _regexp_arg_rows(cols, n, start=1):
    """Per-row (pattern, flags) string pairs; None where the arg is NULL."""
    out = []
    for i in range(start, len(cols)):
        c = cols[i]
        vals = K.decode_strings(c) if c.dtype.is_string else c.to_pylist(n)
        v = c.validity_host()
        if len(vals) == 1 and n > 1:
            vals = np.repeat(vals, n)
            v = None if v is None else np.repeat(v, n)
        if v is not None:
            vals = np.where(v[:len(vals)], vals, None)
        out.append(vals)
    return out


def _regexp_check_flags(flags: str) -> str:
    if flags and "g" in flags:
        from ..common.errors import PlanError
        raise PlanError("regexp_like() does not support the global flag")
    return flags


def _impl_regexp_like(cols, out_type, n, arg_exprs):
    from ..physical.expressions import LiteralExpr
    if not cols[0].dtype.is_string and cols[0].dtype.id != TypeId.NULL:
        raise ExecutionError(
            "Cannot infer common argument type for regex operation "
            f"{cols[0].dtype} Regex Utf8")
    if cols[0].dictionary is None:   # NULL literal or untyped null input
        return Column(dt.BOOL, np.zeros(n, bool), np.zeros(n, bool))
    pat_literal = len(arg_exprs) < 2 or isinstance(arg_exprs[1], LiteralExpr)
    flg_literal = len(arg_exprs) < 3 or isinstance(arg_exprs[2], LiteralExpr)
    if pat_literal and flg_literal:
        args = _scalar_args(cols, arg_exprs)
        if (len(cols) > 1 and cols[1].validity_host() is not None
                and not cols[1].validity_host()[:1].all()) or \
                (args and args[0] is None):
            # NULL pattern -> NULL result (arrow regexp kernels)
            return Column(dt.BOOL, np.zeros(n, bool), np.zeros(n, bool))
        if cols[0].dtype.is_string and cols[0].dictionary is None:
            return Column(dt.BOOL, np.zeros(n, bool), np.zeros(n, bool))
        flags = args[1] if len(args) > 1 else ""
        rx = _regexp_compile(args[0] if args else "", flags or "")
        return K.dict_map_bool(cols[0], lambda s: rx.search(s) is not None)
    # pattern/flags vary per row: evaluate row-wise
    strs = K.decode_strings(cols[0])
    sv = cols[0].validity_host()
    argrows = _regexp_arg_rows(cols, n)
    pats = argrows[0]
    flgs = argrows[1] if len(argrows) > 1 else [""] * n
    data = np.zeros(n, bool)
    valid = np.ones(n, bool)
    for i in range(n):
        if (sv is not None and not sv[i]) or pats[i] is None:
            valid[i] = False
            continue
        rx = _regexp_compile(pats[i], flgs[i] or "")
        data[i] = rx.search(strs[i]) is not None
    return Column(dt.BOOL, data, valid if not valid.all() else None)


def _impl_regexp_match(cols, out_type, n, arg_exprs):
    """First-match capture groups as a list column (pg semantics: NULL when
    no match; whole match when the pattern has no groups). Reference:
    functions/src/regex/regexpmatch.rs."""
    if cols[0].dictionary is None:   # NULL literal or untyped null input
        return Column(out_type, np.array([None] * n, object),
                      np.zeros(n, bool))
    strs = K.decode_strings(cols[0])
    sv = cols[0].validity_host()
    argrows = _regexp_arg_rows(cols, n)
    pats = argrows[0] if argrows else np.array([None] * n, object)
    flgs = argrows[1] if len(argrows) > 1 else [""] * n
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    cache = {}
    for i in range(n):
        if (sv is not None and not sv[i]) or pats[i] is None:
            valid[i] = False
            out[i] = None
            continue
        key = (pats[i], flgs[i] or "")
        rx = cache.get(key)
        if rx is None:
            rx = _regexp_compile(pats[i], flgs[i] or "")
            cache[key] = rx
        m = rx.search(strs[i])
        if m is None:
            valid[i] = False
            out[i] = None
        elif rx.groups:
            out[i] = list(m.groups())
        else:
            out[i] = [m.group(0)] if m.group(0) else []
    return Column(out_type, out, valid if not valid.all() else None)


def _impl_regexp_imatch(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    rx = re.compile(args[0], re.IGNORECASE)
    return K.dict_map_bool(cols[0], lambda s: rx.search(s) is not None)


def _impl_regexp_not_match(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    rx = re.compile(args[0])
    return K.dict_map_bool(cols[0], lambda s: rx.search(s) is None)


def _impl_regexp_not_imatch(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    rx = re.compile(args[0], re.IGNORECASE)
    return K.dict_map_bool(cols[0], lambda s: rx.search(s) is None)


def _impl_regexp_like_full(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    rx = re.compile(args[0])
    return K.dict_map_bool(cols[0], lambda s: rx.fullmatch(s) is not None)


def _regexp_rep_template(rep: str) -> str:
    """PostgreSQL backreferences (\\N, also doubled \\\\N through SQL
    string literals) -> Python template backrefs."""
    return rep.replace("\\\\", "\\")


def _impl_regexp_replace(cols, out_type, n, arg_exprs):
    from ..physical.expressions import LiteralExpr
    if cols[0].dictionary is None:   # NULL literal or untyped null input
        return K.encode_strings(np.array([None] * n, object),
                                np.zeros(n, bool))
    all_lit = all(isinstance(e, LiteralExpr) for e in (arg_exprs or [])[1:])
    if all_lit:
        args = _scalar_args(cols, arg_exprs)
        pat, rep = args[0], args[1]
        flags_str = args[2] if len(args) > 2 else ""
        flags_is_null = len(cols) > 3 and cols[3].dictionary is None
        if pat is None or rep is None or flags_is_null:
            return K.encode_strings(np.array([None] * n, object),
                                    np.zeros(n, bool))
        count = 0 if "g" in (flags_str or "") else 1
        rx = _regex_mod.compile(pat,
                                _regex_flags((flags_str or "").replace("g", "")))
        rep = _regexp_rep_template(rep)
        return K.dict_map_str(cols[0], lambda s: rx.sub(rep, s, count=count))
    # per-row pattern / replacement / flags
    strs = K.decode_strings(cols[0])
    sv = cols[0].validity_host()
    argrows = _regexp_arg_rows(cols, n)
    pats = argrows[0]
    reps = argrows[1]
    flgs = argrows[2] if len(argrows) > 2 else [""] * n
    has_flags_arg = len(argrows) > 2
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    cache = {}
    for i in range(n):
        if (sv is not None and not sv[i]) or pats[i] is None or \
                reps[i] is None or (has_flags_arg and flgs[i] is None):
            valid[i] = False
            out[i] = None
            continue
        f = flgs[i] or ""
        key = (pats[i], f)
        rx = cache.get(key)
        if rx is None:
            rx = _regex_mod.compile(pats[i],
                                    _regex_flags(f.replace("g", "")))
            cache[key] = rx
        out[i] = rx.sub(_regexp_rep_template(reps[i]), strs[i],
                        count=0 if "g" in f else 1)
    return K.encode_strings(out, valid if not valid.all() else None)


def _impl_regexp_count(cols, out_type, n, arg_exprs):
    args = _scalar_args(cols, arg_exprs)
    rx = re.compile(args[0], _regex_flags(args[1] if len(args) > 1 else ""))
    return K.dict_map_values(cols[0], lambda s: len(rx.findall(s)), dt.INT64)


# --------------------------------------------------------------------------
# datetime
# --------------------------------------------------------------------------

_TO_CHAR_OK = set("YmdHMSfeyjaAbBCIpRTDFxXvGgUuWwkKlsZznN%+.c0123456789-_:#")


def _to_char_check(fmt: str) -> None:
    i = 0
    while i < len(fmt):
        if fmt[i] == "%":
            if i + 1 >= len(fmt):
                raise ExecutionError("Cast error: Format error")
            c = fmt[i + 1]
            if c == "." and i + 2 < len(fmt):
                i += 1
                c = fmt[i + 1]
            if c in ("K", "Q", "J"):
                raise ExecutionError("Cast error: Format error")
            i += 2
        else:
            i += 1


def _impl_to_char(cols, out_type, n, arg_exprs):
    """chrono strftime rendering of date/time/timestamp/duration values
    with per-row format strings (reference: functions/src/datetime/
    to_char.rs). %f renders 9-digit nanoseconds like chrono."""
    import datetime as _d
    c = cols[0]
    fmts = _regexp_arg_rows(cols, n)[0]
    v = c.validity_host()
    data = c.data_host()
    d = c.dtype
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    scale = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}
    for i in range(n):
        if fmts[i] is None:
            # NULL format -> NULL (reference to_char semantics)
            valid[i] = False
            out[i] = None
            continue
        if v is not None and not v[i]:
            # NULL value with a format -> empty string
            out[i] = ""
            continue
        fmt = fmts[i]
        _to_char_check(fmt)
        if d.id == TypeId.DATE:
            base = _d.datetime(1970, 1, 1) + _d.timedelta(days=int(data[i]))
            nanos = 0
        elif d.id == TypeId.TIME:
            ns = int(data[i]) * scale[d.unit or "ns"]
            base = _d.datetime(1970, 1, 1) + _d.timedelta(
                microseconds=ns // 1000)
            nanos = ns % 10**9
        elif d.id == TypeId.TIMESTAMP:
            ns = int(data[i]) * scale[d.unit or "ns"]
            base = _d.datetime(1970, 1, 1) + _d.timedelta(
                microseconds=ns // 1000)
            nanos = ns % 10**9
        elif d.id == TypeId.INTERVAL:
            from ..functions.datetime_helpers import interval_display
            if (d.unit or "").startswith("rawdur"):
                ns = int(data[i])
                if fmt == "iso8601":
                    u = d.unit.split("_", 1)[1]
                    q = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}[u]
                    suf = {"s": "S", "ms": "MS", "us": "US", "ns": "NS"}
                    out[i] = f"PT{ns // q}{'S' if u == 's' else u.upper()}"
                    continue
                # 'pretty' (or anything else): arrow Duration display,
                # trimmed of zero fraction
                txt = interval_display(ns, d.unit)
                out[i] = txt
                continue
            out[i] = interval_display(int(data[i]), d.unit or "mdn")
            continue
        else:
            raise ExecutionError(f"to_char unsupported input type {d}")
        fmt2 = fmt.replace("%f", f"{nanos:09d}")
        out[i] = base.strftime(fmt2)
    return K.encode_strings(out, None if valid.all() else valid)


def _impl_current_time(cols, out_type, n, _):
    ns = _statement_now_ns() % (86400 * 10**9)
    return Column(dt.TIME, np.full(n, ns, np.int64), None)


def _impl_at_time_zone(cols, out_type, n, arg_exprs):
    """expr AT TIME ZONE 'tz' (reference: sqlparser AtTimeZone ->
    arrow timestamptz): the naive wall time reinterprets in `tz`; a
    tz-typed input converts its display zone (same instant)."""
    from ..functions.tz_util import offsets_for_wall_ns
    c = cols[0]
    args = _scalar_args(cols, arg_exprs)
    tz = args[0]
    had_offset = False
    if c.dtype.is_string:
        if c.dictionary is not None and len(c.dictionary.values):
            # strings carrying an explicit offset/Z denote INSTANTS: the
            # zone only changes the display (postgres AT TIME ZONE)
            had_offset = all(
            	re.search(r"(Z|z|[+-]\d{1,2}:?\d{2})\s*$", str(v))
                for v in c.dictionary.values)
        c = K.cast_column(c, dt.timestamp("ns"))
    if c.dtype.id != TypeId.TIMESTAMP:
        c = K.cast_column(c, dt.timestamp("ns"))
    if had_offset:
        return Column(dt.timestamp(c.dtype.unit or "ns", tz=tz),
                      c.data_host().astype(np.int64), c.validity_host())
    unit = c.dtype.unit or "ns"
    mul = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}[unit]
    data = c.data_host().astype(np.int64)
    if c.dtype.tz:
        # already an instant: only the display zone changes
        return Column(dt.timestamp(unit, tz=tz), data, c.validity_host())
    wall_ns = data * mul
    utc_ns = wall_ns - offsets_for_wall_ns(tz, wall_ns)
    return Column(dt.timestamp(unit, tz=tz), utc_ns // mul,
                  c.validity_host())


def _impl_date_trunc(cols, out_type, n, arg_exprs):
    part = _scalar_args(cols, arg_exprs, start=0)[0]
    c = cols[1]
    if c.dtype.is_null:
        c = K.cast_column(c, out_type)
    return dti.date_trunc(part, c)


def _impl_date_part(cols, out_type, n, arg_exprs):
    part = _scalar_args(cols, arg_exprs, start=0)[0]
    return dti.date_part(part, cols[1])


def _impl_date_bin(cols, out_type, n, arg_exprs):
    from ..physical.expressions import LiteralExpr
    if arg_exprs and len(arg_exprs) > 2 and \
            not isinstance(arg_exprs[2], LiteralExpr):
        raise ExecutionError(
            "DATE_BIN only supports literal values for the origin argument")
    origin = cols[2] if len(cols) > 2 else None
    sv = _lit(arg_exprs[0] if arg_exprs else None)
    exact = None
    if sv is not None and sv.dtype.id == TypeId.INTERVAL and \
            sv.value is not None:
        exact = sv.value   # (months, days, nanos) pre-packing: exact
    return dti.date_bin(cols[0], cols[1], origin, exact_nanos=exact)


def _chrono_strptime(value: str, fmt: str):
    """Parse with a chrono-style format string (reference:
    functions/src/datetime/to_date.rs uses chrono's strftime syntax).
    Returns a datetime; raises ValueError on mismatch, ExecutionError on a
    bad/unsupported format."""
    import datetime as _d
    if "%q" in fmt or "%c" in fmt:
        # soft failure: callers try the next format; surfaced when none fit
        raise ValueError("bad or unsupported format string")
    if fmt.strip() == "%+":
        try:
            return _d.datetime.fromisoformat(value.replace("Z", "+00:00"))
        except ValueError:
            raise ValueError("input contains invalid characters")
    if fmt.strip() == "%s":
        return _d.datetime(1970, 1, 1) + _d.timedelta(seconds=int(value))
    pyfmt = fmt.replace("%.f", ".%f").replace("%#z", "%z")
    value2 = value
    if "%.f" in fmt:
        # python %f caps at 6 digits; trim ns digits (callers needing
        # exact ns use the ISO path)
        value2 = re.sub(r"\.(\d{6})\d+", r".\1", value)
    try:
        return _d.datetime.strptime(value2, pyfmt)
    except ValueError:
        raise ValueError(
            f"Error parsing timestamp from '{value}' using format "
            f"'{fmt}': input contains invalid characters")


def _chrono_parse_rows(cols, n):
    """Parse string rows with chrono-style formats (args 2..): per-row
    (utc_ns or None); formats try in order, first success wins."""
    import datetime as _d
    argrows = _regexp_arg_rows(cols, n)
    strs = K.decode_strings(cols[0])
    sv = cols[0].validity_host()
    out = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    epoch = _d.datetime(1970, 1, 1, tzinfo=_d.timezone.utc)
    for i in range(n):
        if sv is not None and not sv[i]:
            valid[i] = False
            continue
        last_err = None
        done = False
        for fr in argrows:
            fmt = fr[i] if i < len(fr) else fr[0]
            if fmt is None:
                continue
            try:
                dtv = _chrono_strptime(strs[i], fmt)
                if dtv.tzinfo is None:
                    dtv = dtv.replace(tzinfo=_d.timezone.utc)
                td = dtv - epoch
                out[i] = ((td.days * 86_400 + td.seconds) * 10**9
                          + td.microseconds * 1000)
                done = True
                break
            except ValueError as e:
                last_err = e
        if not done:
            raise ExecutionError(str(last_err) if last_err else
                                 f"Cannot parse '{strs[i]}' as timestamp")
    return out, valid


def _impl_to_date(cols, out_type, n, arg_exprs):
    c = cols[0]
    if not c.dtype.is_string or len(cols) < 2:
        if c.dtype.is_string:
            # bare strings may carry a time component; parse as timestamp
            # then truncate (reference: string_to_datetime then cast)
            def parse(sv):
                t = sv.strip()
                if " " in t or "T" in t:
                    import datetime as _d
                    from ..functions.datetime_helpers import \
                        parse_timestamp_ns
                    ns = parse_timestamp_ns(t)
                    return int(ns // (86_400 * 10**9)
                               - (1 if ns < 0 and ns % (86_400 * 10**9)
                                  else 0))
                return None
            vals = K.decode_strings(c)
            needs_time = any(v and (" " in v.strip() or "T" in v.strip())
                             for v in (c.dictionary.values
                                       if c.dictionary is not None else []))
            if needs_time:
                out = np.zeros(n, np.int32)
                v = c.validity_host()
                valid = np.ones(n, bool) if v is None else v.copy()
                for i in range(n):
                    if not valid[i]:
                        continue
                    r = parse(vals[i])
                    if r is None:
                        col1 = K.cast_column(
                            K.encode_strings(np.array([vals[i]], object),
                                             None), dt.DATE)
                        r = int(col1.data_host()[0])
                    out[i] = r
                return Column(dt.DATE, out, None if valid.all() else valid)
        return K.cast_column(c, dt.DATE)
    # chrono format strings: try each in order, first parse wins
    import datetime as _d
    argrows = _regexp_arg_rows(cols, n)
    strs = K.decode_strings(c)
    sv = c.validity_host()
    epoch = _d.date(1970, 1, 1)
    out = np.zeros(n, np.int32)
    valid = np.ones(n, bool)
    for i in range(n):
        if sv is not None and not sv[i]:
            valid[i] = False
            continue
        last_err = None
        done = False
        for fr in argrows:
            fmt = fr[i] if i < len(fr) else fr[0]
            if fmt is None:
                continue
            try:
                dtv = _chrono_strptime(strs[i], fmt)
                if dtv.tzinfo is not None:
                    # chrono normalizes zoned inputs to UTC before the
                    # date truncation
                    dtv = dtv.astimezone(_d.timezone.utc)
                out[i] = (dtv.date() - epoch).days
                done = True
                break
            except ValueError as e:
                last_err = e
        if not done:
            raise ExecutionError(str(last_err) if last_err else
                                 f"Cannot parse '{strs[i]}' as date")
    return Column(dt.DATE, out, None if valid.all() else valid)


def _ts_impl(unit, seconds_semantics=False):
    def impl(cols, out_type, n, _):
        c = cols[0]
        if c.dtype.is_string and len(cols) > 1:
            # chrono format strings (reference: to_timestamp.rs with
            # formats) — first matching format wins
            ns, valid = _chrono_parse_rows(cols, n)
            div = 10**9 // {"s": 1, "ms": 10**3,
                            "us": 10**6, "ns": 10**9}[unit]
            return Column(dt.timestamp(unit), ns // div,
                          None if valid.all() else valid)
        if c.dtype.is_string:
            return K.cast_column(c, dt.timestamp(unit))
        if c.dtype.is_numeric:
            if unit == "s" or seconds_semantics or c.dtype.is_float \
                    or c.dtype.is_decimal:
                # to_timestamp[_seconds] / float / decimal inputs:
                # numeric means seconds
                secs = K.cast_column(c, dt.FLOAT64).data_host()
                scale = {"s": 1, "ms": 1e3, "us": 1e6, "ns": 1e9}[unit]
                return Column(dt.timestamp(unit),
                              (secs * scale).astype(np.int64),
                              c.validity_host())
            # to_timestamp_millis/micros/nanos: the integer IS the unit
            # (reference: to_timestamp.rs unit-native integer inputs)
            vals = c.data_host().astype(np.int64) if not c.dtype.is_float \
                else c.data_host().astype(np.float64).astype(np.int64)
            return Column(dt.timestamp(unit), vals, c.validity_host())
        return K.cast_column(c, dt.timestamp(unit))
    return impl


# per-statement clock: the reference evaluates the now() family once at
# planning time (ConstEvaluator + query_execution_start_time), so
# now()/current_time()/current_date() agree within one statement.
_STATEMENT_CLOCK_NS = [None]


def begin_statement_clock():
    import time
    _STATEMENT_CLOCK_NS[0] = int(time.time() * 1e9)


def _statement_now_ns() -> int:
    if _STATEMENT_CLOCK_NS[0] is None:
        begin_statement_clock()
    return _STATEMENT_CLOCK_NS[0]


def _impl_now(cols, out_type, n, _):
    return Column(dt.timestamp("ns"),
                  np.full(n, _statement_now_ns(), np.int64), None)


def _impl_current_date(cols, out_type, n, _):
    v = _statement_now_ns() // (86400 * 10**9)
    return Column(dt.DATE, np.full(n, v, np.int32), None)


def _impl_make_date(cols, out_type, n, _):
    return dti.make_date(cols[0], cols[1], cols[2])


def _impl_to_unixtime(cols, out_type, n, _):
    c = cols[0]
    if c.dtype.is_numeric:
        # numeric input already IS epoch seconds
        return Column(dt.INT64,
                      K.cast_column(c, dt.FLOAT64).data_host()
                      .astype(np.int64), c.validity_host())
    if c.dtype.is_string and len(cols) > 1:
        ns, valid = _chrono_parse_rows(cols, n)
        return Column(dt.INT64, ns // 10**9,
                      None if valid.all() else valid)
    us = dti._to_micros(K.cast_column(c, dt.timestamp("us"))
                        if not c.dtype.is_temporal else c)
    return Column(dt.INT64, us // 10**6, c.validity_host())


def _impl_from_unixtime(cols, out_type, n, _):
    # reference: from_unixtime returns Timestamp(Second, None)
    secs = cols[0].data_host().astype(np.int64)
    return Column(dt.timestamp("s"), secs, cols[0].validity_host())


# --------------------------------------------------------------------------
# crypto
# --------------------------------------------------------------------------

def _hash_impl(algo):
    import hashlib
    def impl(cols, out_type, n, _):
        h = getattr(hashlib, algo)
        return K.dict_map_str(cols[0], lambda s: h(s.encode()).hexdigest())
    return impl


def _impl_encode(cols, out_type, n, arg_exprs):
    """encode(expr, 'hex'|'base64') (functions/src/encoding/inner.rs)."""
    import base64
    fmt = _scalar_args(cols, arg_exprs)[0].lower()
    col = cols[0]

    def enc(v):
        b = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        if fmt == "hex":
            return b.hex()
        if fmt == "base64":
            # arrow uses unpadded standard base64
            return base64.b64encode(b).decode().rstrip("=")
        raise ExecutionError(f"unknown encoding {fmt!r}")
    return K.dict_map_str(col, enc)


def _impl_decode(cols, out_type, n, arg_exprs):
    import base64
    fmt = _scalar_args(cols, arg_exprs)[0].lower()
    col = cols[0]
    vals = col.dictionary.values

    def dec(v):
        s = v.decode() if isinstance(v, (bytes, bytearray)) else str(v)
        if fmt == "hex":
            return bytes.fromhex(s)
        if fmt == "base64":
            pad = "=" * (-len(s) % 4)
            return base64.b64decode(s + pad)
        raise ExecutionError(f"unknown encoding {fmt!r}")
    new_vals = np.fromiter((dec(v) for v in vals), dtype=object,
                           count=len(vals))
    return Column(dt.BINARY, col.data_host().copy(), col.validity_host(),
                  Dictionary(new_vals))


def _impl_to_hex(cols, out_type, n, _):
    c = cols[0]
    if not c.dtype.is_integer:
        raise ExecutionError(
            f"to_hex expects an integer argument, got {c.dtype}")
    data = c.data_host()[:n]
    vals = np.array([format(int(v), "x") for v in data], dtype=object)
    uniq, inverse = np.unique(vals.astype(str), return_inverse=True)
    return Column(dt.STRING, inverse.astype(np.int32), c.validity_host(),
                  Dictionary(uniq.astype(object)))


def _impl_version(cols, out_type, n, _):
    from .. import __version__
    return K.encode_strings(np.full(n, f"datafusion-tpu {__version__}", dtype=object), None)


# --------------------------------------------------------------------------
# arrays (host object-list columns; reference: functions-array/src/)
# --------------------------------------------------------------------------

def _col_pylist(c: Column, n: int):
    if c.dtype == dt.FLOAT32:
        # keep f32 identity inside composite values so renderers can use
        # the shortest-f32 decimal (struct {c2: 3.1}, not 3.099999904633)
        data = c.data_host()
        mask = K.valid_mask(c)
        return [np.float32(data[i]) if mask[i] else None for i in range(n)]
    return c.to_pylist(n)


def _impl_make_array(cols, out_type, n, _):
    items = [_col_pylist(c, n) for c in cols]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = [it[i] for it in items]
    return Column(out_type, out, None)


def _impl_struct(cols, out_type, n, _):
    """struct(v0, v1, …) -> {c0: v0, …} rows (functions/src/core/struct.rs)."""
    names = [f for f, _t in out_type.fields] or [f"c{i}" for i in range(len(cols))]
    items = [_col_pylist(c, n) for c in cols]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = {nm: it[i] for nm, it in zip(names, items)}
    return Column(out_type, out, None)


def _impl_named_struct(cols, out_type, n, _):
    vals = cols[1::2]
    names = [f for f, _t in out_type.fields]
    items = [_col_pylist(c, n) for c in vals]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = {nm: it[i] for nm, it in zip(names, items)}
    return Column(out_type, out, None)


def _impl_get_field(cols, out_type, n, _):
    """struct['name'] access (functions/src/core/getfield.rs)."""
    structs = cols[0].data_host()
    keys = _col_pylist(cols[1], n)
    vals, valid = [], np.ones(n, bool)
    for i in range(n):
        s = structs[i]
        v = s.get(keys[i]) if isinstance(s, dict) else None
        if v is None:
            vals.append(None)
            valid[i] = False
        else:
            vals.append(v)
    if out_type.is_string:
        return K.encode_strings(np.array(vals, dtype=object),
                                None if valid.all() else valid)
    if out_type.id in (TypeId.LIST, TypeId.STRUCT, TypeId.NULL):
        out = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            out[i] = v
        return Column(out_type, out, None if valid.all() else valid)
    safe = np.array([v if v is not None else 0 for v in vals])
    return Column(out_type, safe.astype(out_type.device_dtype()),
                  None if valid.all() else valid)


def _impl_string_to_array(cols, out_type, n, _):
    s = _col_pylist(cols[0], n)
    sep = _col_pylist(cols[1], n) if len(cols) > 1 else [","] * n
    nullstr = _col_pylist(cols[2], n) if len(cols) > 2 else [None] * n
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    for i in range(n):
        if s[i] is None:
            valid[i] = False
            out[i] = []
            continue
        d = sep[i]
        parts = list(s[i]) if not d else s[i].split(d)
        ns = nullstr[i]
        out[i] = [None if (ns is not None and p == ns) else p for p in parts]
    return Column(out_type, out, None if valid.all() else valid)


def _lists_in(cols, n):
    return _col_pylist(cols[0], n)


def _lists_out(out_type, items, valid=None):
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return Column(out_type, out,
                  valid if valid is not None and not valid.all() else None)


def _impl_array_slice(cols, out_type, n, _):
    ls = _lists_in(cols, n)
    lo = _col_pylist(cols[1], n)
    hi = _col_pylist(cols[2], n)
    out = []
    for x, a, b in zip(ls, lo, hi):
        if x is None:
            out.append([])
            continue
        a = int(a or 1)
        b = int(b if b is not None else len(x))
        # SQL 1-based inclusive; negative counts from the end
        a = len(x) + a + 1 if a < 0 else a
        b = len(x) + b + 1 if b < 0 else b
        out.append(list(x[max(a - 1, 0): b]))
    return _lists_out(out_type, out)


def _impl_array_distinct(cols, out_type, n, _):
    out = []
    for x in _lists_in(cols, n):
        seen, acc = set(), []
        for v in (x or []):
            if v not in seen:
                seen.add(v)
                acc.append(v)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_sort(cols, out_type, n, _):
    desc = _col_pylist(cols[1], n) if len(cols) > 1 else ["ASC"] * n
    out = []
    for x, d in zip(_lists_in(cols, n), desc):
        vals = [v for v in (x or []) if v is not None]
        nulls = [v for v in (x or []) if v is None]
        rev = str(d).upper().startswith("DESC")
        out.append(sorted(vals, reverse=rev) + nulls)
    return _lists_out(out_type, out)


def _impl_array_reverse(cols, out_type, n, _):
    return _lists_out(out_type,
                      [list(reversed(x or [])) for x in _lists_in(cols, n)])


def _impl_array_union(cols, out_type, n, _):
    a = _lists_in(cols, n)
    b = _col_pylist(cols[1], n)
    out = []
    for x, y in zip(a, b):
        seen, acc = set(), []
        for v in (x or []) + (y or []):
            if v not in seen:
                seen.add(v)
                acc.append(v)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_intersect(cols, out_type, n, _):
    a = _lists_in(cols, n)
    b = _col_pylist(cols[1], n)
    out = []
    for x, y in zip(a, b):
        ys = set(y or [])
        seen, acc = set(), []
        for v in (x or []):
            if v in ys and v not in seen:
                seen.add(v)
                acc.append(v)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_except(cols, out_type, n, _):
    a = _lists_in(cols, n)
    b = _col_pylist(cols[1], n)
    out = []
    for x, y in zip(a, b):
        ys = set(y or [])
        seen, acc = set(), []
        for v in (x or []):
            if v not in ys and v not in seen:
                seen.add(v)
                acc.append(v)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_remove(cols, out_type, n, _):
    a = _lists_in(cols, n)
    b = _col_pylist(cols[1], n)
    out = []
    for x, v in zip(a, b):
        acc, removed = [], False
        for e in (x or []):
            if not removed and e == v:
                removed = True
                continue
            acc.append(e)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_remove_all(cols, out_type, n, _):
    a = _lists_in(cols, n)
    b = _col_pylist(cols[1], n)
    return _lists_out(out_type,
                      [[e for e in (x or []) if e != v] for x, v in zip(a, b)])


def _impl_array_repeat(cols, out_type, n, _):
    v = _col_pylist(cols[0], n)
    k = _col_pylist(cols[1], n)
    return _lists_out(out_type,
                      [[x] * int(c or 0) for x, c in zip(v, k)])


def _impl_array_pop_back(cols, out_type, n, _):
    return _lists_out(out_type, [list((x or [])[:-1])
                                 for x in _lists_in(cols, n)])


def _impl_array_pop_front(cols, out_type, n, _):
    return _lists_out(out_type, [list((x or [])[1:])
                                 for x in _lists_in(cols, n)])


def _impl_array_empty(cols, out_type, n, _):
    data = np.fromiter((len(x or []) == 0 for x in _lists_in(cols, n)),
                       bool, count=n)
    return Column(dt.BOOL, data, cols[0].validity_host())


def _series(cols, n, inclusive: bool):
    start = _col_pylist(cols[0], n)
    stop = _col_pylist(cols[1], n)
    step = _col_pylist(cols[2], n) if len(cols) > 2 else [1] * n
    out = []
    for a, b, s in zip(start, stop, step):
        if a is None or b is None or not s:
            out.append([])
            continue
        a, b, s = int(a), int(b), int(s)
        if inclusive:
            b += 1 if s > 0 else -1
        out.append(list(range(a, b, s)))
    return out


def _impl_generate_series(cols, out_type, n, _):
    # inclusive stop (reference: functions-table generate_series)
    return _lists_out(out_type, _series(cols, n, True))


def _impl_range(cols, out_type, n, _):
    # exclusive stop (reference: range)
    return _lists_out(out_type, _series(cols, n, False))


def _impl_array_length(cols, out_type, n, _):
    data = cols[0].data_host()
    v = cols[0].validity_host()
    out = np.fromiter(
        (len(x) if x is not None else 0 for x in data), np.int64, count=n)
    return Column(dt.INT64, out, v)


def _impl_array_element(cols, out_type, n, _):
    lists = cols[0].data_host()
    idx = cols[1].data_host()
    vals, valid = [], np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        k = int(idx[i]) - 1   # 1-based
        if li is None or k < 0 or k >= len(li) or li[k] is None:
            vals.append(None)
            valid[i] = False
        else:
            vals.append(li[k])
    if out_type.is_string:
        return K.encode_strings(np.array(vals, dtype=object),
                                None if valid.all() else valid)
    if out_type.id in (TypeId.LIST, TypeId.STRUCT, TypeId.NULL):
        out = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            out[i] = v
        return Column(out_type, out, None if valid.all() else valid)
    safe = np.array([v if v is not None else 0 for v in vals])
    return Column(out_type, safe.astype(out_type.device_dtype()),
                  None if valid.all() else valid)


def _impl_array_concat(cols, out_type, n, _):
    parts = [c.data_host() for c in cols]
    out = np.empty(n, dtype=object)
    for i in range(n):
        acc = []
        for p in parts:
            if p[i] is not None:
                acc.extend(p[i])
        out[i] = acc
    return Column(cols[0].dtype, out, None)


def _impl_array_contains(cols, out_type, n, _):
    lists = cols[0].data_host()
    needle = _col_pylist(cols[1], n)
    out = np.fromiter(
        (lists[i] is not None and needle[i] in lists[i] for i in range(n)),
        bool, count=n)
    return Column(dt.BOOL, out, cols[0].validity_host())


def _impl_array_position(cols, out_type, n, _):
    lists = cols[0].data_host()
    needle = _col_pylist(cols[1], n)
    vals = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        if li is None or needle[i] not in li:
            valid[i] = False
        else:
            vals[i] = li.index(needle[i]) + 1
    return Column(dt.INT64, vals, None if valid.all() else valid)


def _impl_array_append(cols, out_type, n, _):
    a = _lists_in(cols, n)
    v = _col_pylist(cols[1], n)
    return _lists_out(out_type,
                      [list(x or []) + [e] for x, e in zip(a, v)])


def _impl_array_prepend(cols, out_type, n, _):
    v = _col_pylist(cols[0], n)
    a = _lists_in(cols[1:], n)
    return _lists_out(out_type,
                      [[e] + list(x or []) for e, x in zip(v, a)])


def _impl_array_positions(cols, out_type, n, _):
    lists = cols[0].data_host()
    needle = _col_pylist(cols[1], n)
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        if li is None:
            out[i] = None
            valid[i] = False
        else:
            out[i] = [j + 1 for j, e in enumerate(li) if e == needle[i]]
    return Column(out_type, out, None if valid.all() else valid)


def _impl_array_to_string(cols, out_type, n, arg_exprs):
    lists = cols[0].data_host()
    seps = _col_pylist(cols[1], n)
    null_str = _col_pylist(cols[2], n) if len(cols) > 2 else [None] * n

    def render(e):
        if isinstance(e, bool):
            return "true" if e else "false"
        if isinstance(e, float) and e == int(e):
            return str(e)
        return str(e)

    def flat(li, acc, ns):
        for e in li:
            if isinstance(e, list):
                flat(e, acc, ns)
            elif e is None:
                if ns is not None:
                    acc.append(ns)
            else:
                acc.append(render(e))

    vals = []
    valid = np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        if li is None:
            vals.append(None)
            valid[i] = False
            continue
        acc = []
        flat(li, acc, null_str[i])
        vals.append((seps[i] or "").join(acc))
    arr = np.array(["" if v is None else v for v in vals], dtype=object)
    uniq, inverse = np.unique(arr.astype(str), return_inverse=True)
    return Column(dt.STRING, inverse.astype(np.int32),
                  None if valid.all() else valid,
                  Dictionary(uniq.astype(object)))


def _impl_array_has_all(cols, out_type, n, _):
    a = cols[0].data_host()
    b = cols[1].data_host()
    out = np.fromiter(
        (a[i] is not None and b[i] is not None and
         all(e in a[i] for e in b[i]) for i in range(n)), bool, count=n)
    return Column(dt.BOOL, out, None)


def _impl_array_has_any(cols, out_type, n, _):
    a = cols[0].data_host()
    b = cols[1].data_host()
    out = np.fromiter(
        (a[i] is not None and b[i] is not None and
         any(e in a[i] for e in b[i]) for i in range(n)), bool, count=n)
    return Column(dt.BOOL, out, None)


def _replace_k(x, frm, to, k):
    acc = []
    left = k
    for e in (x or []):
        if left > 0 and e == frm:
            acc.append(to)
            left -= 1
        else:
            acc.append(e)
    return acc


def _impl_array_replace(cols, out_type, n, _):
    a = _lists_in(cols, n)
    f = _col_pylist(cols[1], n)
    t = _col_pylist(cols[2], n)
    return _lists_out(out_type, [_replace_k(x, ff, tt, 1)
                                 for x, ff, tt in zip(a, f, t)])


def _impl_array_replace_n(cols, out_type, n, _):
    a = _lists_in(cols, n)
    f = _col_pylist(cols[1], n)
    t = _col_pylist(cols[2], n)
    k = _col_pylist(cols[3], n)
    return _lists_out(out_type, [_replace_k(x, ff, tt, int(kk or 0))
                                 for x, ff, tt, kk in zip(a, f, t, k)])


def _impl_array_replace_all(cols, out_type, n, _):
    a = _lists_in(cols, n)
    f = _col_pylist(cols[1], n)
    t = _col_pylist(cols[2], n)
    return _lists_out(out_type, [_replace_k(x, ff, tt, 1 << 62)
                                 for x, ff, tt in zip(a, f, t)])


def _impl_array_remove_n(cols, out_type, n, _):
    a = _lists_in(cols, n)
    v = _col_pylist(cols[1], n)
    k = _col_pylist(cols[2], n)
    out = []
    for x, vv, kk in zip(a, v, k):
        left = int(kk or 0)
        acc = []
        for e in (x or []):
            if left > 0 and e == vv:
                left -= 1
                continue
            acc.append(e)
        out.append(acc)
    return _lists_out(out_type, out)


def _impl_array_resize(cols, out_type, n, _):
    a = _lists_in(cols, n)
    sz = _col_pylist(cols[1], n)
    fill = _col_pylist(cols[2], n) if len(cols) > 2 else [None] * n
    out = []
    for x, s, f in zip(a, sz, fill):
        s = int(s or 0)
        cur = list(x or [])
        out.append(cur[:s] + [f] * max(s - len(cur), 0))
    return _lists_out(out_type, out)


def _impl_array_dims(cols, out_type, n, _):
    lists = cols[0].data_host()
    out = np.empty(n, dtype=object)
    valid = np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        if li is None or len(li) == 0:
            out[i] = None
            valid[i] = False
            continue
        dims = []
        cur = li
        while isinstance(cur, list):
            dims.append(len(cur))
            cur = cur[0] if cur else None
        out[i] = dims
    return Column(out_type, out, None if valid.all() else valid)


def _impl_array_ndims(cols, out_type, n, _):
    lists = cols[0].data_host()
    vals = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    for i in range(n):
        li = lists[i]
        if li is None:
            valid[i] = False
            continue
        d = 0
        cur = li
        while isinstance(cur, list):
            d += 1
            cur = cur[0] if cur else None
        vals[i] = d
    return Column(dt.INT64, vals, None if valid.all() else valid)


def _impl_flatten(cols, out_type, n, _):
    lists = cols[0].data_host()
    out = np.empty(n, dtype=object)
    for i in range(n):
        li = lists[i]
        if li is None:
            out[i] = None
            continue
        flat = []
        for x in li:
            if isinstance(x, list):
                flat.extend(x)
            else:
                flat.append(x)
        out[i] = flat
    return Column(cols[0].dtype, out, cols[0].validity_host())


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_IMPLS = {
    # math
    "abs": _impl_abs, "ceil": _impl_ceilfloor("ceil"), "floor": _impl_ceilfloor("floor"),
    "round": _impl_round, "trunc": _impl_trunc, "sign": _impl_sign,
    # Rust f64::signum: +0.0 -> 1, -0.0 -> -1, NaN -> NaN
    "signum": lambda c, o, n, a: _unary_float(
        lambda x: np.where(np.isnan(x), x,
                           np.where(np.signbit(x), -1.0, 1.0)), c, o),
    "sqrt": lambda c, o, n, a: _unary_float(np.sqrt, c, o),
    "cbrt": lambda c, o, n, a: _unary_float(np.cbrt, c, o),
    "exp": lambda c, o, n, a: _unary_float(np.exp, c, o),
    "ln": lambda c, o, n, a: _unary_float(np.log, c, o),
    "log": _impl_log, "log2": lambda c, o, n, a: _unary_float(np.log2, c, o),
    "log10": lambda c, o, n, a: _unary_float(np.log10, c, o),
    "power": _impl_power, "pow": _impl_power,
    "sin": lambda c, o, n, a: _unary_float(np.sin, c, o),
    "cos": lambda c, o, n, a: _unary_float(np.cos, c, o),
    "tan": lambda c, o, n, a: _unary_float(np.tan, c, o),
    "cot": lambda c, o, n, a: _unary_float(lambda x: 1.0 / np.tan(x), c, o),
    "asin": lambda c, o, n, a: _unary_float(np.arcsin, c, o),
    "acos": lambda c, o, n, a: _unary_float(np.arccos, c, o),
    "atan": lambda c, o, n, a: _unary_float(np.arctan, c, o),
    "atan2": _impl_atan2,
    "sinh": lambda c, o, n, a: _unary_float(np.sinh, c, o),
    "cosh": lambda c, o, n, a: _unary_float(np.cosh, c, o),
    "tanh": lambda c, o, n, a: _unary_float(np.tanh, c, o),
    "asinh": lambda c, o, n, a: _unary_float(np.arcsinh, c, o),
    "acosh": lambda c, o, n, a: _unary_float(np.arccosh, c, o),
    "atanh": lambda c, o, n, a: _unary_float(np.arctanh, c, o),
    "degrees": lambda c, o, n, a: _unary_float(np.degrees, c, o),
    "radians": lambda c, o, n, a: _unary_float(np.radians, c, o),
    "pi": _impl_pi, "random": _impl_random, "factorial": _impl_factorial,
    "gcd": _impl_gcd, "lcm": _impl_lcm, "isnan": _impl_isnan,
    "iszero": _impl_iszero, "nanvl": _impl_nanvl, "mod": _impl_mod,
    # core
    "coalesce": _impl_coalesce, "nullif": _impl_nullif, "nvl": _impl_nvl,
    "ifnull": _impl_nvl, "nvl2": _impl_nvl2, "arrow_typeof": _impl_arrow_typeof,
    # string
    "ascii": _str_to_int(lambda s: ord(s[0]) if s else 0),
    "bit_length": _str_to_int(lambda s: len(s.encode()) * 8),
    "char_length": _str_to_int(len), "character_length": _str_to_int(len),
    "length": _str_to_int(len),
    "octet_length": _str_to_int(lambda s: len(s.encode())),
    "lower": _str_unary(str.lower), "upper": _str_unary(str.upper),
    "reverse": _str_unary(lambda s: s[::-1]),
    "trim": _impl_btrim, "btrim": _impl_btrim, "ltrim": _impl_ltrim,
    "rtrim": _impl_rtrim, "initcap": _impl_initcap,
    "concat": _impl_concat, "concat_ws": _impl_concat_ws,
    "left": _impl_left, "right": _impl_right,
    "lpad": _impl_lpad, "rpad": _impl_rpad,
    "repeat": _impl_repeat, "replace": _impl_replace,
    "translate": _impl_translate, "split_part": _impl_split_part,
    "starts_with": _impl_starts_with, "ends_with": _impl_ends_with,
    "contains": _impl_contains, "strpos": _impl_strpos,
    "instr": _impl_strpos, "position": _impl_strpos,
    "substr": _impl_substr, "substring": _impl_substr,
    "chr": _impl_chr, "to_hex": _impl_to_hex, "levenshtein": _impl_levenshtein,
    "substring_index": _impl_substring_index,
    "find_in_set": _impl_find_in_set, "overlay": _impl_overlay,
    "uuid": _impl_uuid,
    # regex
    "regexp_like": _impl_regexp_like, "regexp_like_full": _impl_regexp_like_full,
    "regexp_replace": _impl_regexp_replace, "regexp_count": _impl_regexp_count,
    "regexp_match": _impl_regexp_match,
    "regexp_match_op": _impl_regexp_like,
    "regexp_imatch_op": _impl_regexp_imatch,
    "regexp_not_match_op": _impl_regexp_not_match,
    "regexp_not_imatch_op": _impl_regexp_not_imatch,
    # datetime
    "date_trunc": _impl_date_trunc, "date_part": _impl_date_part,
    "to_char": _impl_to_char, "date_format": _impl_to_char,
    "current_time": _impl_current_time,
    "at_time_zone": _impl_at_time_zone,
    "datepart": _impl_date_part, "date_bin": _impl_date_bin,
    "to_date": _impl_to_date,
    "to_timestamp": _ts_impl("ns", seconds_semantics=True),
    "to_timestamp_micros": _ts_impl("us"),
    "to_timestamp_millis": _ts_impl("ms"), "to_timestamp_seconds": _ts_impl("s"),
    "to_timestamp_nanos": _ts_impl("ns"),
    "now": _impl_now, "current_date": _impl_current_date, "today": _impl_current_date,
    "make_date": _impl_make_date, "to_unixtime": _impl_to_unixtime,
    "from_unixtime": _impl_from_unixtime,
    # crypto
    "encode": _impl_encode, "decode": _impl_decode,
    "to_hex": _impl_to_hex,
    "md5": _hash_impl("md5"), "sha224": _hash_impl("sha224"),
    "sha256": _hash_impl("sha256"), "sha384": _hash_impl("sha384"),
    "sha512": _hash_impl("sha512"),
    # arrays
    "make_array": _impl_make_array, "array": _impl_make_array,
    "struct": _impl_struct, "row": _impl_struct,
    "named_struct": _impl_named_struct,
    "get_field": _impl_get_field,
    "string_to_array": _impl_string_to_array,
    "string_to_list": _impl_string_to_array,
    "array_slice": _impl_array_slice,
    "array_distinct": _impl_array_distinct, "list_distinct": _impl_array_distinct,
    "array_sort": _impl_array_sort, "list_sort": _impl_array_sort,
    "array_reverse": _impl_array_reverse,
    "array_union": _impl_array_union,
    "array_intersect": _impl_array_intersect,
    "array_except": _impl_array_except,
    "array_remove": _impl_array_remove,
    "array_remove_all": _impl_array_remove_all,
    "array_repeat": _impl_array_repeat,
    "array_pop_back": _impl_array_pop_back,
    "array_pop_front": _impl_array_pop_front,
    "empty": _impl_array_empty, "array_empty": _impl_array_empty,
    "generate_series": _impl_generate_series, "range": _impl_range,
    "array_length": _impl_array_length, "cardinality": _impl_array_length,
    "array_element": _impl_array_element,
    "array_concat": _impl_array_concat, "array_cat": _impl_array_concat,
    "array_extract": _impl_array_element,
    "list_element": _impl_array_element,
    "list_extract": _impl_array_element,
    "array_contains": _impl_array_contains, "array_has": _impl_array_contains,
    "list_has": _impl_array_contains,
    "array_position": _impl_array_position,
    "list_position": _impl_array_position,
    "array_indexof": _impl_array_position,
    "list_indexof": _impl_array_position,
    "array_append": _impl_array_append, "list_append": _impl_array_append,
    "list_push_back": _impl_array_append,
    "array_prepend": _impl_array_prepend,
    "list_prepend": _impl_array_prepend,
    "list_push_front": _impl_array_prepend,
    "array_positions": _impl_array_positions,
    "list_positions": _impl_array_positions,
    "array_to_string": _impl_array_to_string,
    "array_join": _impl_array_to_string,
    "list_to_string": _impl_array_to_string,
    "list_join": _impl_array_to_string,
    "array_has_all": _impl_array_has_all,
    "list_has_all": _impl_array_has_all,
    "array_has_any": _impl_array_has_any,
    "list_has_any": _impl_array_has_any,
    "arrays_overlap": _impl_array_has_any,
    "array_replace": _impl_array_replace,
    "list_replace": _impl_array_replace,
    "array_replace_n": _impl_array_replace_n,
    "list_replace_n": _impl_array_replace_n,
    "array_replace_all": _impl_array_replace_all,
    "list_replace_all": _impl_array_replace_all,
    "array_remove_n": _impl_array_remove_n,
    "list_remove_n": _impl_array_remove_n,
    "array_resize": _impl_array_resize, "list_resize": _impl_array_resize,
    "array_dims": _impl_array_dims, "list_dims": _impl_array_dims,
    "array_ndims": _impl_array_ndims, "list_ndims": _impl_array_ndims,
    "list_empty": _impl_array_empty,
    "flatten": _impl_flatten,
    # misc
    "version": _impl_version,
}
