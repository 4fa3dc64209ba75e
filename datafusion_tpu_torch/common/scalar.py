"""ScalarValue — a single typed SQL value (literal / aggregate result).

Reference parity: `ScalarValue` (`datafusion/common/src/scalar/mod.rs:192`).
We keep one dataclass with a DataType tag + a host Python value instead of 45
enum variants; device kernels receive the *device representation* via
``device_value()`` (e.g. a Decimal literal becomes its scaled int64).
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from decimal import Decimal as PyDecimal
from typing import Any, Optional

import numpy as np

from . import datatypes as dt
from .datatypes import DataType, TypeId
from .errors import TypeError_

_EPOCH = _dt.date(1970, 1, 1)
_TS_SCALE = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


@dataclasses.dataclass(frozen=True)
class ScalarValue:
    dtype: DataType
    value: Any  # None => SQL NULL

    # ---- constructors ------------------------------------------------------
    @staticmethod
    def null() -> "ScalarValue":
        return ScalarValue(dt.NULL, None)

    @staticmethod
    def boolean(v: Optional[bool]) -> "ScalarValue":
        return ScalarValue(dt.BOOL, v)

    @staticmethod
    def int64(v: Optional[int]) -> "ScalarValue":
        return ScalarValue(dt.INT64, v)

    @staticmethod
    def float64(v: Optional[float]) -> "ScalarValue":
        return ScalarValue(dt.FLOAT64, v)

    @staticmethod
    def string(v: Optional[str]) -> "ScalarValue":
        return ScalarValue(dt.STRING, v)

    @staticmethod
    def decimal_from_str(text: str) -> "ScalarValue":
        d = PyDecimal(text)
        sign, digits, exp = d.as_tuple()
        scale = max(0, -exp)
        prec = max(len(digits), scale + 1)
        return ScalarValue(dt.decimal(prec, scale), d)

    @staticmethod
    def date(v: Optional[_dt.date]) -> "ScalarValue":
        return ScalarValue(dt.DATE, v)

    @staticmethod
    def timestamp(v: Optional[_dt.datetime], unit: str = "us") -> "ScalarValue":
        return ScalarValue(dt.timestamp(unit), v)

    @staticmethod
    def interval(months: int = 0, days: int = 0, nanos: int = 0) -> "ScalarValue":
        return ScalarValue(dt.INTERVAL, (months, days, nanos))

    # ---- properties --------------------------------------------------------
    @property
    def is_null(self) -> bool:
        return self.value is None

    def device_value(self):
        """Host value converted to the on-device representation (a numpy
        scalar of ``dtype.device_dtype()``). NULL maps to 0 (masked out by
        validity)."""
        d = self.dtype
        npdt = d.device_dtype()
        if self.value is None:
            return npdt.type(0)
        v = self.value
        if d.id == TypeId.DECIMAL:
            q = PyDecimal(v).scaleb(d.scale)
            return npdt.type(int(q))
        if d.id == TypeId.DATE:
            mul = 86_400_000 if d.unit == "ms" else 1   # Date64 = epoch ms
            if isinstance(v, _dt.datetime):
                # Date64 renders as a midnight timestamp; keep epoch ms
                if d.unit == "ms":
                    td = v - _dt.datetime(1970, 1, 1)
                    return npdt.type((td.days * 86_400 + td.seconds) * 1000
                                     + td.microseconds // 1000)
                v = v.date()
            if isinstance(v, _dt.date):
                return npdt.type((v - _EPOCH).days * mul)
            return npdt.type(int(v) * mul)
        if d.id == TypeId.TIMESTAMP:
            if isinstance(v, _dt.datetime):
                # integer arithmetic: float64 seconds loses the last ~3
                # digits of a modern epoch-nanos value
                epoch = _dt.datetime(1970, 1, 1, tzinfo=v.tzinfo if v.tzinfo else None)
                td = v - epoch
                secs = td.days * 86400 + td.seconds
                scale = _TS_SCALE[d.unit]
                return npdt.type(secs * scale + td.microseconds * scale // 10**6)
            return npdt.type(int(v))
        if d.id == TypeId.BOOL:
            return npdt.type(bool(v))
        if d.is_string:
            raise TypeError_("string scalars are dictionary-encoded per column; "
                             "use kernels.encode_literal")
        if d.id == TypeId.INTERVAL:
            if (d.unit or "").startswith("rawdur"):
                return npdt.type(int(v))   # raw-ns Duration
            months, days, nanos = v
            # packed interval: see functions/datetime.py
            from ..functions.datetime_helpers import pack_interval
            return npdt.type(pack_interval(months, days, nanos))
        return npdt.type(v)

    def cast(self, to: DataType) -> "ScalarValue":
        if self.dtype == to:
            return self
        if self.value is None:
            return ScalarValue(to, None)
        v = self.value
        if to.is_float:
            return ScalarValue(to, float(v))
        if to.is_integer:
            return ScalarValue(to, int(v))
        if to.is_decimal:
            return ScalarValue(to, PyDecimal(str(v)))
        if to.is_string:
            return ScalarValue(to, str(v))
        if to.is_boolean:
            return ScalarValue(to, bool(v))
        if to.id == TypeId.DATE:
            if isinstance(v, str):
                return ScalarValue(to, _dt.date.fromisoformat(v))
            if isinstance(v, _dt.datetime):
                return ScalarValue(to, v.date())
            return ScalarValue(to, v)
        if to.id == TypeId.TIMESTAMP:
            if isinstance(v, str):
                return ScalarValue(to, _dt.datetime.fromisoformat(v))
            if isinstance(v, _dt.date):
                return ScalarValue(to, _dt.datetime(v.year, v.month, v.day))
            if isinstance(v, (float, PyDecimal)):
                # numeric seconds -> target-unit count (matches the columnar
                # float->timestamp cast, kernels.py; keeps cast(1.1 as
                # timestamp) fractional seconds when constant-folded)
                scale = _TS_SCALE[to.unit or "ns"]
                return ScalarValue(to, int(round(float(v) * scale)))
            return ScalarValue(to, v)
        raise TypeError_(f"cannot cast scalar {self} to {to}")

    def __str__(self) -> str:
        if self.value is None:
            return "NULL"
        if self.dtype.is_string:
            return f"Utf8(\"{self.value}\")"
        if self.dtype.id == TypeId.TIMESTAMP and isinstance(self.value, int):
            from ..functions.datetime_helpers import format_timestamp
            txt = format_timestamp(self.value, self.dtype.unit or "ns",
                                   self.dtype.tz).replace("T", " ")
            return f"{self.dtype}({txt})"
        return f"{self.dtype}({self.value})"

    __repr__ = __str__
