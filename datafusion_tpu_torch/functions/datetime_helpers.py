"""Interval packing.

The host representation of a (non-Duration) INTERVAL mirrors arrow's
MonthDayNano i128 (`datafusion/common/src/scalar/mod.rs` Interval
variants): one exact 128-bit Python int per value, held in an object
ndarray, with offset-binary fields so field-wise ordering is monotone:

    bits [96..127] months + 2^31
    bits [64..95]  days   + 2^31
    bits [ 0..63]  nanos  + 2^63

Interval COLUMNS therefore never stage onto the device (like wide
decimals); interval arithmetic unpacks, operates componentwise, repacks
on the host. Durations (`dur_*`/`rawdur_*` units) remain raw-nanosecond
int64 lanes and stay device-eligible.
"""
from __future__ import annotations

import numpy as np

_M_OFF = 1 << 31
_D_OFF = 1 << 31
_NS_OFF = 1 << 63
_D_SHIFT = 64
_M_SHIFT = 96


def pack_interval(months: int, days: int, nanos: int) -> int:
    return (((int(months) + _M_OFF) << _M_SHIFT)
            | ((int(days) + _D_OFF) << _D_SHIFT)
            | (int(nanos) + _NS_OFF))


def pack_interval_np(months, days, nanos):
    months = np.asarray(months).astype(object)
    days = np.asarray(days).astype(object)
    nanos = np.asarray(nanos).astype(object)
    out = (((months + _M_OFF) << _M_SHIFT)
           | ((days + _D_OFF) << _D_SHIFT)
           | (nanos + _NS_OFF))
    return np.asarray(out, object)


def unpack_interval_np(packed):
    """-> (months, days, NANOS) object ndarrays of exact Python ints."""
    packed = np.asarray(packed).astype(object)
    months = (packed >> _M_SHIFT) - _M_OFF
    days = ((packed >> _D_SHIFT) & ((1 << 32) - 1)) - _D_OFF
    nanos = (packed & ((1 << 64) - 1)) - _NS_OFF
    return months, days, nanos


def interval_str(packed: int) -> str:
    m, d, ns = unpack_interval_np(np.array([packed]))
    m, d, ns = int(m[0]), int(d[0]), int(ns[0])
    parts = []
    if m:
        parts.append(f"{m} mons")
    if d:
        parts.append(f"{d} days")
    if ns or not parts:
        secs = ns / 1e9
        parts.append(f"{secs:g} secs")
    return " ".join(parts)


# --------------------------------------------------------------------------
# Exact (integer) temporal string parsing and chrono-style formatting.
#
# The reference's timestamp text round-trip is exact at nanosecond precision
# (arrow-cast string_to_timestamp_nanos + chrono Debug formatting); a float64
# path loses the low ~3 digits of a modern epoch-nanos value, so everything
# here is integer arithmetic.
# --------------------------------------------------------------------------
import datetime as _dt
import re as _re

_EPOCH_ORD = _dt.date(1970, 1, 1).toordinal()
_TS_RE = _re.compile(
    r"^(\d{4,5})-(\d{1,2})-(\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d+))?)?"
    r"\s*(Z|z|[+-]\d{1,2}:?\d{2})?)?$")
_TIME_RE = _re.compile(r"^(\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d+))?)?$")
UNIT_NS = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}


def parse_timestamp_ns(s: str) -> int:
    """Parse a timestamp string to UTC epoch nanoseconds, exactly.

    Accepts 'YYYY-MM-DD[ T]HH:MM[:SS[.frac]][Z|±HH:MM]' and bare dates.
    Reference: arrow string_to_timestamp_nanos (used by cast and literals).
    """
    m = _TS_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid timestamp string {s!r}")
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    days = _dt.date(y, mo, d).toordinal() - _EPOCH_ORD
    hh = int(m.group(4) or 0)
    mi = int(m.group(5) or 0)
    ss = int(m.group(6) or 0)
    frac = (m.group(7) or "").ljust(9, "0")[:9]
    secs = days * 86400 + hh * 3600 + mi * 60 + ss
    tz = m.group(8)
    if tz and tz not in ("Z", "z"):
        sign = 1 if tz[0] == "+" else -1
        tz = tz[1:].replace(":", "")
        off_h, off_m = int(tz[:-2]), int(tz[-2:])
        secs -= sign * (off_h * 3600 + off_m * 60)
    return secs * 10**9 + int(frac)


def parse_time_ns(s: str) -> int:
    """Parse 'HH:MM[:SS[.frac]]' to nanoseconds since midnight, exactly."""
    m = _TIME_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid time string {s!r}")
    hh, mi = int(m.group(1)), int(m.group(2))
    ss = int(m.group(3) or 0)
    if hh > 23 or mi > 59 or ss > 59:
        raise ValueError(f"time value out of range: {s!r}")
    frac = (m.group(4) or "").ljust(9, "0")[:9]
    return (hh * 3600 + mi * 60 + ss) * 10**9 + int(frac)


def _frac_str(frac_ns: int) -> str:
    """chrono's AutoSi fractional display: 0, 3, 6 or 9 digits."""
    if frac_ns == 0:
        return ""
    if frac_ns % 1_000_000 == 0:
        return f".{frac_ns // 1_000_000:03d}"
    if frac_ns % 1_000 == 0:
        return f".{frac_ns // 1_000:06d}"
    return f".{frac_ns:09d}"


def format_timestamp(value: int, unit: str, tz=None) -> str:
    """Format an epoch value in `unit` the way chrono Debug does
    ('2018-11-13T17:11:10.011375885'); tz-typed values render in their
    zone with the RFC3339 offset suffix (Z for +00)."""
    ns = int(value) * UNIT_NS[unit]
    suffix = ""
    if tz is not None:
        from .tz_util import offset_suffix, offsets_for_utc_ns
        off = int(offsets_for_utc_ns(tz, np.array([ns], np.int64))[0])
        ns += off
        suffix = offset_suffix(off)
    secs, frac = divmod(ns, 10**9)
    days, sod = divmod(secs, 86400)
    y, mo, d = _civil_from_days(days)
    base = (f"{'' if 0 <= y <= 9999 else '+' if y > 0 else ''}"
            f"{y:04d}-{mo:02d}-{d:02d}"
            f"T{sod // 3600:02d}:{sod // 60 % 60:02d}:{sod % 60:02d}"
            + _frac_str(frac))
    return base + suffix


def format_time(value: int, unit: str) -> str:
    """'18:06:30.243620451' — chrono NaiveTime Debug formatting."""
    ns = int(value) * UNIT_NS[unit]
    sod, frac = divmod(ns, 10**9)
    return f"{sod // 3600:02d}:{sod // 60 % 60:02d}:{sod % 60:02d}" + _frac_str(frac)


def interval_display(packed: int, style: str = "mdn") -> str:
    """arrow's full Interval Display: 'X years Y mons Z days H hours M mins
    S.fff secs', with 9/3/2 fractional digits for MonthDayNano/DayTime/
    YearMonth (arrow-rs interval array Display)."""
    if style.startswith("rawdur"):
        # raw-nanosecond Duration (exact ts - ts): truncate-toward-zero
        # decomposition like arrow's Duration display
        ns = int(packed)
        digits = {"rawdur_ns": 9, "rawdur_us": 6,
                  "rawdur_ms": 3, "rawdur_s": 0}.get(style, 9)
        sign = -1 if ns < 0 else 1
        a = abs(ns)
        days, rem = divmod(a, 86_400 * 10**9)
        hours, rem = divmod(rem, 3_600 * 10**9)
        mins, rem = divmod(rem, 60 * 10**9)
        secs, frac = divmod(rem, 10**9)
        neg = "-" if sign < 0 else ""
        stxt = f"{neg if (secs or frac) else ''}{secs}"
        if digits:
            stxt += "." + f"{frac:09d}"[:digits]
        return (f"{neg if days else ''}{days} days "
                f"{neg if hours else ''}{hours} hours "
                f"{neg if mins else ''}{mins} mins {stxt} secs")
    m, d, ns = unpack_interval_np(np.array([packed]))
    m, d, ns = int(m[0]), int(d[0]), int(ns[0])
    if style == "ym":
        # arrow IntervalYearMonth Display splits years/months
        years = int(m / 12)        # truncate toward zero
        mons = m - years * 12
    else:
        # IntervalMonthDayNano/DayTime keep TOTAL months in `mons`
        # ("interval '5 YEAR'" renders "0 years 60 mons ...")
        years, mons = 0, m
    hours = int(ns / 3_600_000_000_000)
    rem = ns - hours * 3_600_000_000_000
    mins = int(rem / 60_000_000_000)
    rem -= mins * 60_000_000_000
    secs = int(rem / 1_000_000_000)
    frac_ns = abs(rem - secs * 1_000_000_000)
    digits = {"mdn": 9, "dt": 3, "ym": 2, "dur_ns": 9, "dur_us": 6,
              "dur_ms": 3, "dur_s": 0, "dur_day": 0}.get(
        style, 3 if style.startswith("dur") else 9)
    frac = str(frac_ns).zfill(9).ljust(digits, "0")[:digits]
    sign = "-" if (rem < 0 and secs == 0) else ""
    sec_txt = f"{sign}{secs}.{frac}" if digits else f"{sign}{secs}"
    tail = (f"{d} days {hours} hours {mins} mins {sec_txt} secs")
    if style.startswith("dur"):
        # arrow Duration display carries no years/mons component
        return tail
    return f"{years} years {mons} mons " + tail


def _civil_from_days(z: int):
    """Proleptic Gregorian (year, month, day) from days since 1970-01-01 —
    valid for any year, unlike datetime.date (Howard Hinnant's civil_from_days)."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return (y + 1 if m <= 2 else y), m, d
