"""Temporal kernels: date/timestamp ± interval, date_trunc, date_part,
date_bin, to_date/to_timestamp, make_date.

Reference parity: `datafusion/functions/src/datetime/` (date_bin.rs,
date_trunc.rs, date_part.rs, to_timestamp.rs, make_date.rs) — re-implemented
vectorized over days-since-epoch int32 / epoch-micros int64 device arrays
via numpy datetime64 calendar math on the host path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..common import dt
from ..common.column import Column
from ..common.datatypes import DataType, TypeId
from ..common.errors import ExecutionError
from .datetime_helpers import pack_interval_np, unpack_interval_np

_TS_SCALE = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


# --------------------------------------------------------------------------
# calendar helpers (vectorized)
# --------------------------------------------------------------------------

def _days_to_ymd(days: np.ndarray):
    d64 = days.astype("datetime64[D]")
    y = d64.astype("datetime64[Y]").astype(np.int64) + 1970
    m64 = d64.astype("datetime64[M]")
    m = m64.astype(np.int64) % 12 + 1
    dom = (d64 - m64.astype("datetime64[D]")).astype(np.int64) + 1
    return y, m, dom


def _ymd_to_days(y, m, dom):
    """(year, month 1-12, day 1-31) -> days since epoch, clamping the day to
    the target month's length (SQL month-add semantics)."""
    total_m = (y - 1970) * 12 + (m - 1)
    first = total_m.astype("datetime64[M]")
    next_first = (total_m + 1).astype("datetime64[M]")
    month_len = (next_first.astype("datetime64[D]") - first.astype("datetime64[D]")).astype(np.int64)
    dom = np.minimum(dom, month_len)
    return (first.astype("datetime64[D]").astype(np.int64) + dom - 1).astype(np.int64)


def _add_months_to_days(days: np.ndarray, months: np.ndarray) -> np.ndarray:
    y, m, dom = _days_to_ymd(days.astype(np.int64))
    total = (y * 12 + (m - 1)) + months
    ny, nm = total // 12, total % 12 + 1
    return _ymd_to_days(ny, nm, dom)


# --------------------------------------------------------------------------
# temporal arithmetic dispatch (called from kernels.arith)
# --------------------------------------------------------------------------

def temporal_arith(op: str, l: Column, r: Column, out_type: DataType,
                   validity) -> Column:
    # a Utf8 operand against an interval/temporal coerces via parsing
    # (reference: interval '1 month' + '1 month' works)
    if l.dtype.is_string and (r.dtype.is_interval or r.dtype.is_temporal):
        from ..physical.kernels import cast_column
        l = cast_column(l, dt.INTERVAL if r.dtype.is_interval
                        else dt.timestamp("ns"))
    elif r.dtype.is_string and (l.dtype.is_interval or l.dtype.is_temporal):
        from ..physical.kernels import cast_column
        r = cast_column(r, dt.INTERVAL if l.dtype.is_interval
                        else dt.timestamp("ns"))
    lt, rt = l.dtype, r.dtype
    # interval +- interval, interval * int
    if lt.is_interval and rt.is_interval:
        lm, ld, lms = unpack_interval_np(l.data_host())
        rm, rd, rms = unpack_interval_np(r.data_host())
        if op == "+":
            data = pack_interval_np(lm + rm, ld + rd, lms + rms)
        elif op == "-":
            data = pack_interval_np(lm - rm, ld - rd, lms - rms)
        else:
            raise ExecutionError(f"interval {op} interval not supported")
        return Column(dt.INTERVAL, data, validity)
    if lt.is_interval and rt.is_numeric or rt.is_interval and lt.is_numeric:
        iv, k = (l, r) if lt.is_interval else (r, l)
        m, d, ms = unpack_interval_np(iv.data_host())
        kk = k.data_host()
        if op == "*":
            data = pack_interval_np(m * kk, d * kk, ms * kk)
        else:
            raise ExecutionError(f"interval {op} number not supported")
        return Column(dt.INTERVAL, data, validity)

    # temporal - temporal -> interval
    if op == "-" and lt.is_temporal and rt.is_temporal:
        if lt.id == TypeId.DATE and rt.id == TypeId.DATE:
            days = l.data_host().astype(np.int64) - r.data_host().astype(np.int64)
            dur = dt.DataType(dt.TypeId.INTERVAL, unit="dur_day")
            return Column(dur, pack_interval_np(0 * days, days, 0 * days), validity)
        a = _to_nanos(l)
        b = _to_nanos(r)
        diff_ns = a - b
        # reference yields a Duration in the finer operand unit, displayed
        # without years/mons ("0 days 0 hours 0 mins 0.011 secs"); stored
        # as RAW nanoseconds (exact — the packed interval word only holds
        # milliseconds)
        ltz, rtz = getattr(lt, "tz", None), getattr(rt, "tz", None)
        if ltz and rtz and ltz != rtz:
            from .tz_util import fixed_offset_ns
            if fixed_offset_ns(ltz) != fixed_offset_ns(rtz):
                raise ExecutionError(
                    f"cannot subtract timestamps with different time "
                    f"zones: {ltz} vs {rtz}")
        order = {"s": 0, "ms": 1, "us": 2, "ns": 3, None: 3}
        units = [x.unit for x in (lt, rt) if x.id == TypeId.TIMESTAMP]
        fine = max(units, key=lambda u: order.get(u, 3)) if units else "ns"
        if len(units) == 2 and units[0] != units[1] and \
                order.get(fine, 3) > 2:
            fine = "us"   # mixed timestamp units cap at microseconds
        dur = dt.DataType(dt.TypeId.INTERVAL, unit=f"rawdur_{fine or 'ns'}")
        if fine != "ns":
            q = {"s": 10**9, "ms": 10**6, "us": 10**3}[fine]
            diff_ns = diff_ns // q * q
        return Column(dur, diff_ns, validity)

    # temporal ± interval
    if lt.is_temporal and rt.is_interval or rt.is_temporal and lt.is_interval:
        t, iv = (l, r) if lt.is_temporal else (r, l)
        if not lt.is_temporal and op == "-":
            raise ExecutionError("interval - timestamp is not valid")
        m, d, ns = unpack_interval_np(iv.data_host())
        # months/days fit int64 (32-bit fields); sub-day stays exact ns
        m, d = m.astype(np.int64), d.astype(np.int64)
        if op == "-":
            m, d, ns = -m, -d, -ns
        carry_us = (ns // 1000).astype(np.int64)
        if t.dtype.id == TypeId.DATE:
            days = t.data_host().astype(np.int64)
            has_m = m.any()
            out_days = _add_months_to_days(days, m) if has_m else days
            out_days = out_days + d
            if carry_us.any():
                # arrow date32 ± MonthDayNano stays a DATE: the interval's
                # time component contributes only whole days, truncated
                # toward zero (date - '1 minute' = same date)
                out_days = out_days + np.sign(carry_us) * (
                    np.abs(carry_us) // 86_400_000_000)
            return Column(dt.DATE, out_days.astype(np.int32), validity)
        # timestamp
        micros = _to_micros(t)
        if m.any():
            days = micros // 86_400_000_000
            within = micros - days * 86_400_000_000
            days = _add_months_to_days(days, m)
            micros = days * 86_400_000_000 + within
        micros = micros + d * 86_400_000_000 + carry_us
        return _cast_ts(Column(dt.timestamp("us"), micros, validity), out_type)

    raise ExecutionError(f"unsupported temporal arithmetic: {lt} {op} {rt}")


def _to_micros(c: Column) -> np.ndarray:
    if c.dtype.id == TypeId.DATE:
        if c.dtype.unit == "ms":   # Date64 stores epoch milliseconds
            return c.data_host().astype(np.int64) * 1000
        return c.data_host().astype(np.int64) * 86_400_000_000
    scale = _TS_SCALE[c.dtype.unit]
    data = c.data_host().astype(np.int64)
    if scale <= 10**6:
        return data * (10**6 // scale)
    return data // (scale // 10**6)


def _cast_ts(c: Column, out_type: DataType) -> Column:
    if out_type.id != TypeId.TIMESTAMP:
        return c
    from ..physical.kernels import cast_column
    return cast_column(c, out_type)


# --------------------------------------------------------------------------
# date_trunc / date_part / date_bin
# --------------------------------------------------------------------------

_PART_ALIASES = {
    "year": "year", "years": "year", "y": "year",
    "quarter": "quarter", "qtr": "quarter",
    "month": "month", "months": "month", "mon": "month",
    "week": "week", "weeks": "week",
    "day": "day", "days": "day", "d": "day",
    "hour": "hour", "hours": "hour", "h": "hour",
    "minute": "minute", "minutes": "minute", "min": "minute",
    "second": "second", "seconds": "second", "s": "second",
    "millisecond": "millisecond", "milliseconds": "millisecond",
    "microsecond": "microsecond", "microseconds": "microsecond",
    "nanosecond": "nanosecond", "nanoseconds": "nanosecond",
    "dow": "dow", "doy": "doy", "epoch": "epoch",
}


def date_trunc(part: str, col: Column) -> Column:
    part = _PART_ALIASES.get(part.lower(), part.lower())
    if col.dtype.is_string:
        from ..physical.kernels import cast_column
        col = cast_column(col, dt.timestamp("ns"))
    is_date = col.dtype.id == TypeId.DATE
    tz = getattr(col.dtype, "tz", None)
    micros = _to_micros(col)
    if tz:
        # calendar truncation happens on the LOCAL wall clock
        # (reference: date_trunc.rs with tz-aware arrays)
        from .tz_util import offsets_for_utc_ns
        off_in = offsets_for_utc_ns(tz, micros * 1000) // 1000
        micros = micros + off_in
    days = micros // 86_400_000_000
    if part in ("year", "quarter", "month", "week"):
        y, m, _ = _days_to_ymd(days)
        if part == "year":
            m = np.ones_like(m)
        elif part == "quarter":
            m = (m - 1) // 3 * 3 + 1
        if part == "week":
            # truncate to Monday
            dow = (days + 3) % 7  # 1970-01-01 was a Thursday
            tdays = days - dow
        else:
            tdays = _ymd_to_days(y, m, np.ones_like(m))
        out_us = tdays * 86_400_000_000
    else:
        step = {"day": 86_400_000_000, "hour": 3_600_000_000,
                "minute": 60_000_000, "second": 1_000_000,
                "millisecond": 1000, "microsecond": 1}.get(part)
        if step is None:
            raise ExecutionError(f"date_trunc: unsupported unit '{part}'")
        out_us = micros // step * step
    if is_date:
        return Column(dt.DATE, (out_us // 86_400_000_000).astype(np.int32),
                      col.validity_host())
    if tz:
        # resolve the truncated wall time back to UTC. An ambiguous wall
        # (DST fold) keeps the INPUT's side: reuse the input offset when
        # it round-trips consistently, else the wall-resolved offset
        from .tz_util import offsets_for_utc_ns, offsets_for_wall_ns
        cand = out_us - off_in
        back = offsets_for_utc_ns(tz, cand * 1000) // 1000
        wall_off = offsets_for_wall_ns(tz, out_us * 1000) // 1000
        out_us = np.where(back == off_in, cand, out_us - wall_off)
    from ..physical.kernels import cast_column
    return cast_column(Column(dt.timestamp("us"), out_us, col.validity_host()),
                       col.dtype)


def date_part(part: str, col: Column) -> Column:
    part = _PART_ALIASES.get(part.lower(), part.lower())
    if col.dtype.is_string:
        from ..physical.kernels import cast_column
        col = cast_column(col, dt.timestamp("ns"))
    micros = _to_micros(col)
    tz = getattr(col.dtype, "tz", None)
    if tz and part != "epoch":
        # calendar fields read off the LOCAL wall clock
        from .tz_util import offsets_for_utc_ns
        micros = micros + offsets_for_utc_ns(tz, micros * 1000) // 1000
    days = micros // 86_400_000_000
    within = micros - days * 86_400_000_000
    if part in ("year", "quarter", "month", "day", "week", "doy"):
        y, m, dom = _days_to_ymd(days)
        if part == "year":
            out = y
        elif part == "quarter":
            out = (m - 1) // 3 + 1
        elif part == "month":
            out = m
        elif part == "day":
            out = dom
        elif part == "doy":
            jan1 = _ymd_to_days(y, np.ones_like(m), np.ones_like(m))
            out = days - jan1 + 1
        else:  # ISO week number
            d64 = days.astype("datetime64[D]")
            # ISO: week of the Thursday of this week
            dow = (days + 3) % 7
            thu = days - dow + 3
            ty = thu.astype("datetime64[D]").astype("datetime64[Y]")
            jan1 = ty.astype("datetime64[D]").astype(np.int64)
            out = (thu - jan1) // 7 + 1
            del d64
    elif part == "dow":
        out = (days + 4) % 7   # 0=Sunday; 1970-01-01 Thursday=4
    elif part == "epoch":
        return Column(dt.FLOAT64, micros / 1e6, col.validity_host())
    elif part == "hour":
        out = within // 3_600_000_000
    elif part == "minute":
        out = within % 3_600_000_000 // 60_000_000
    elif part == "second":
        out = within % 60_000_000 // 1_000_000
    elif part == "millisecond":
        out = within % 60_000_000 // 1000
    elif part == "microsecond":
        out = within % 60_000_000
    elif part == "nanosecond":
        out = within % 60_000_000 * 1000
    else:
        raise ExecutionError(f"date_part: unsupported part '{part}'")
    # reference returns Float64 from date_part (functions/src/datetime/date_part.rs)
    return Column(dt.FLOAT64, out.astype(np.float64), col.validity_host())


def _to_nanos(c: Column) -> np.ndarray:
    if c.dtype.id == TypeId.DATE:
        if c.dtype.unit == "ms":   # Date64 stores epoch milliseconds
            return c.data_host().astype(np.int64) * 10**6
        return c.data_host().astype(np.int64) * (86_400 * 10**9)
    scale = _TS_SCALE[c.dtype.unit]
    return c.data_host().astype(np.int64) * (10**9 // scale)


def date_bin(stride: Column, source: Column, origin: Optional[Column],
             exact_nanos=None) -> Column:
    if source.dtype.is_string:
        from ..physical.kernels import cast_column as _cc
        source = _cc(source, dt.timestamp("ns"))
    if origin is not None and origin.dtype.is_string:
        from ..physical.kernels import cast_column as _cc
        origin = _cc(origin, dt.timestamp("ns"))
    if stride.dtype.is_string:
        # string stride form date_bin('15 minutes', ts): parse as interval
        # (reference: date_bin coerces Utf8 strides via interval parsing)
        from ..sql.planner import parse_interval
        vals = stride.to_pylist(len(stride.data_host()))
        s = next((v for v in vals if v is not None), "0 seconds")
        im, idd, ins = parse_interval(str(s), None).value
        packed = pack_interval_np(np.array([im]), np.array([idd]),
                                  np.array([ins]))
        stride = Column(dt.INTERVAL, packed, None)
    m, d, ns = unpack_interval_np(stride.data_host())
    m, d = m.astype(np.int64), d.astype(np.int64)
    nanos = ns.astype(np.int64)
    if exact_nanos is not None:
        m = np.asarray([exact_nanos[0]], np.int64)
        d = np.asarray([exact_nanos[1]], np.int64)
        nanos = np.asarray([exact_nanos[2]], np.int64)
    if m.any():
        # calendar-month stride (reference: date_bin.rs:213
        # date_bin_months_interval); mixed month+day/time strides rejected
        # like date_bin.rs:279-284
        if d.any() or nanos.any():
            raise ExecutionError(
                "DATE_BIN stride does not support combination of month, day "
                "and nanosecond intervals")
        return _date_bin_months(int(m[0]) if m.ndim else int(m), source, origin)
    stride_ns = d * (86_400 * 10**9) + nanos
    if not stride_ns.any():
        raise ExecutionError("DATE_BIN stride must be non-zero")
    src_ns = _to_nanos(source)
    if origin is not None:
        org = _to_nanos(origin)
    else:
        org = np.zeros_like(src_ns)
    delta = src_ns - org
    binned = org + _bin_distance(delta, stride_ns)
    from ..physical.kernels import cast_column
    v = source.validity_host()
    return cast_column(Column(dt.timestamp("ns"), binned, v), source.dtype)


def _bin_distance(diff: np.ndarray, stride) -> np.ndarray:
    """Distance from origin to the bin containing `diff`, replicating the
    reference's truncated-modulo arithmetic (date_bin.rs:201 compute_distance:
    pre-origin timestamps with stride > 1 always round down one extra bin on
    exact boundaries)."""
    rem = np.fmod(diff, stride)          # truncated remainder, like Rust %
    delta = diff - rem
    return np.where((diff < 0) & (np.asarray(stride) > 1), delta - stride, delta)


def _date_bin_months(stride_months: int, source: Column,
                     origin: Optional[Column]) -> Column:
    """Calendar-month binning (reference: date_bin.rs:213
    date_bin_months_interval): distance in whole months from the origin,
    clamped month-add, then step back one stride if the bin lands after the
    source (possible when the origin is not the 1st-at-midnight)."""
    micros = _to_micros(source)
    if origin is not None:
        org = _to_micros(origin)
        if org.shape != micros.shape:
            org = np.broadcast_to(org, micros.shape)
    else:
        org = np.zeros_like(micros)
    odays = np.floor_divide(org, 86_400_000_000)
    owithin = org - odays * 86_400_000_000
    sdays = np.floor_divide(micros, 86_400_000_000)
    sy, sm, _ = _days_to_ymd(sdays.astype(np.int64))
    oy, om, _ = _days_to_ymd(odays.astype(np.int64))
    month_diff = (sy - oy) * 12 + (sm - om)
    delta = _bin_distance(month_diff.astype(np.int64), stride_months)
    binned = _add_months_to_days(odays, delta) * 86_400_000_000 + owithin
    over = binned > micros
    if over.any():
        delta = np.where(over, delta - stride_months, delta)
        binned = _add_months_to_days(odays, delta) * 86_400_000_000 + owithin
    from ..physical.kernels import cast_column
    v = source.validity_host()
    return cast_column(Column(dt.timestamp("us"), binned, v), source.dtype)


def make_date(y: Column, m: Column, d: Column) -> Column:
    from ..physical.kernels import cast_column

    # reference make_date.rs: NULL is never propagated — a literal NULL
    # errors "null/empty value", a data NULL is read as 0 and fails the
    # date parse ("Unable to parse date from 2024, 0, 23").
    def ints(c: Column) -> np.ndarray:
        if c.dtype.id == TypeId.NULL:
            raise ExecutionError(
                "Unable to parse date from null/empty value")
        if c.dtype.is_string:
            c = cast_column(c, dt.INT64)   # string args parse as integers
        out = c.data_host().astype(np.int64)
        v = c.validity_host()
        if v is not None:
            out = np.where(v, out, 0)      # data NULL part becomes 0
        return out
    yy, mm, dd = ints(y), ints(m), ints(d)
    # u32-conversion range checks (reference converts month/day to u32)
    if (mm < 0).any():
        i = int(np.nonzero(mm < 0)[0][0])
        raise ExecutionError(f"Month value '{int(mm[i])}' is out of range")
    if (dd < 0).any():
        i = int(np.nonzero(dd < 0)[0][0])
        raise ExecutionError(f"Day value '{int(dd[i])}' is out of range")
    bad = (mm < 1) | (mm > 12) | (dd < 1) | (dd > 31)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ExecutionError(
            f"Unable to parse date from {int(yy[i])}, {int(mm[i])}, "
            f"{int(dd[i])}")
    live = np.ones(len(yy), bool)
    validity = None
    # exact construction via civil arithmetic (valid for ANY year, unlike
    # datetime.date); the day must exist in the target month
    first = _ymd_to_days_exact(yy, mm, np.ones_like(dd))
    nxt = _ymd_to_days_exact(yy + (mm == 12), mm % 12 + 1,
                             np.ones_like(dd))
    month_len = nxt - first
    bad2 = live & (dd > month_len)
    if bad2.any():
        i = int(np.nonzero(bad2)[0][0])
        raise ExecutionError(
            f"Unable to parse date from {int(yy[i])}, {int(mm[i])}, "
            f"{int(dd[i])}")
    out = first + dd - 1
    return Column(dt.DATE, out.astype(np.int32), validity)


def _ymd_to_days_exact(y, m, dom):
    """civil days-from-ymd (Howard Hinnant), vectorized, any year."""
    y = np.asarray(y, np.int64)
    m = np.asarray(m, np.int64)
    dom = np.asarray(dom, np.int64)
    y_adj = y - (m <= 2)
    era = np.where(y_adj >= 0, y_adj, y_adj - 399) // 400
    yoe = y_adj - era * 400
    mp = np.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + dom - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
