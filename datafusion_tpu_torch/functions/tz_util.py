"""Session / column time-zone helpers.

Reference parity: `datafusion.execution.time_zone` (config.rs) and arrow's
Timestamp(unit, Some(tz)) semantics — values are ALWAYS stored as UTC
instants; the zone affects parsing of naive wall times, display, and
calendar operations (date_trunc/date_part/date_bin).

Fixed offsets ("+08", "-05:30", "UTC") vectorize trivially; IANA names
("Europe/Brussels") resolve per-instant through zoneinfo (DST), looped per
unique day — exotic in analytics data, correctness over speed.
"""
from __future__ import annotations

import datetime as _dt
from typing import Optional

import numpy as np

_NS = 10 ** 9


def parse_tzinfo(tz: str):
    t = (tz or "").strip()
    if t.upper() in ("UTC", "Z", "+00", "+0000", "+00:00", ""):
        return _dt.timezone.utc
    if t[0] in "+-":
        sign = -1 if t[0] == "-" else 1
        body = t[1:].replace(":", "")
        h = int(body[:2]) if len(body) >= 2 else int(body or 0)
        m = int(body[2:4]) if len(body) >= 4 else 0
        return _dt.timezone(sign * _dt.timedelta(hours=h, minutes=m))
    from zoneinfo import ZoneInfo
    return ZoneInfo(t)


def fixed_offset_ns(tz: str) -> Optional[int]:
    """Offset in ns when `tz` is a fixed offset; None for IANA zones."""
    tzi = parse_tzinfo(tz)
    if isinstance(tzi, _dt.timezone):
        return int(tzi.utcoffset(None).total_seconds()) * _NS
    return None


def offsets_for_utc_ns(tz: str, utc_ns: np.ndarray) -> np.ndarray:
    """Per-value UTC offsets (ns) of the instants in `utc_ns`."""
    fx = fixed_offset_ns(tz)
    if fx is not None:
        return np.full(len(utc_ns), fx, np.int64)
    tzi = parse_tzinfo(tz)
    out = np.zeros(len(utc_ns), np.int64)
    cache = {}
    hour = utc_ns // (3600 * _NS)   # DST shifts on hour boundaries
    for i in range(len(utc_ns)):
        h = int(hour[i])
        off = cache.get(h)
        if off is None:
            inst = _dt.datetime.fromtimestamp(h * 3600,
                                              tz=_dt.timezone.utc)
            off = int(inst.astimezone(tzi).utcoffset().total_seconds()) * _NS
            cache[h] = off
        out[i] = off
    return out


def offsets_for_wall_ns(tz: str, wall_ns: np.ndarray) -> np.ndarray:
    """Offsets to SUBTRACT from naive wall-clock ns (interpreted in `tz`)
    to get UTC instants."""
    fx = fixed_offset_ns(tz)
    if fx is not None:
        return np.full(len(wall_ns), fx, np.int64)
    tzi = parse_tzinfo(tz)
    out = np.zeros(len(wall_ns), np.int64)
    cache = {}
    hour = wall_ns // (3600 * _NS)
    for i in range(len(wall_ns)):
        h = int(hour[i])
        off = cache.get(h)
        if off is None:
            naive = _dt.datetime(1970, 1, 1) + _dt.timedelta(hours=h)
            off = int(naive.replace(tzinfo=tzi).utcoffset()
                      .total_seconds()) * _NS
            cache[h] = off
        out[i] = off
    return out


def wall_to_utc_ns_scalar(naive: _dt.datetime, tz: str) -> int:
    tzi = parse_tzinfo(tz)
    aware = naive.replace(tzinfo=tzi)
    if not isinstance(tzi, _dt.timezone):
        # nonexistent wall time in a DST gap does not round-trip
        back = aware.astimezone(_dt.timezone.utc).astimezone(tzi)
        if back.replace(tzinfo=None) != naive:
            raise ValueError(
                f"timestamp {naive.isoformat()} does not exist in "
                f"time zone {tz} (DST gap)")
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    td = aware - epoch
    return (td.days * 86_400 + td.seconds) * _NS + td.microseconds * 1000


def offset_suffix(offset_ns: int) -> str:
    """Render a UTC offset like arrow/chrono: 'Z' for zero, else ±HH:MM."""
    if offset_ns == 0:
        return "Z"
    sign = "-" if offset_ns < 0 else "+"
    mins = abs(offset_ns) // (60 * _NS)
    return f"{sign}{mins // 60:02d}:{mins % 60:02d}"
