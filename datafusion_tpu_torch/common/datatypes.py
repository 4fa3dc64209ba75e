"""Logical data types and their TPU device representations.

Reference parity: DataFusion's arrow DataType surface as used by DFSchema
(`datafusion/common/src/dfschema.rs:108`) and ScalarValue
(`datafusion/common/src/scalar/mod.rs:192`).

TPU-first design: every logical type maps to a dense device representation
natively supported (or efficiently emulated) by XLA:TPU:

  BOOL                 -> bool_
  INT8/16/32           -> int32   (TPU VPU lanes are 32-bit; narrow ints widen)
  INT64                -> int64   (XLA emulates via 2x s32; exact)
  FLOAT32              -> float32
  FLOAT64              -> float64 (XLA double-double emulation on TPU; ~49-bit
                                   mantissa — exact money math uses DECIMAL)
  DECIMAL(p<=18, s)    -> int64 scaled integer (exact arithmetic)
  STRING               -> int32 dictionary codes; dictionary values stay on
                          host (order-preserving codes: dict sorted at build)
  DATE                 -> int32 days since unix epoch
  TIMESTAMP            -> int64 epoch micro/nanoseconds
  TIME                 -> int64 nanoseconds since midnight
  INTERVAL             -> int64 (months<<40 | days<<20 ...) — see interval.py
  NULL                 -> int32 all-invalid

Strings never live on device as bytes: group/join/sort/compare run on the
int32 codes; host-side kernels (LIKE, regex, substring) operate once per
dictionary entry, then gather by code on device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class TypeId(enum.Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL = "decimal"
    STRING = "string"
    BINARY = "binary"
    DATE = "date"
    TIMESTAMP = "timestamp"
    TIME = "time"
    INTERVAL = "interval"
    LIST = "list"
    STRUCT = "struct"


_INT_IDS = {
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
}
_FLOAT_IDS = {TypeId.FLOAT32, TypeId.FLOAT64}

_UNIT_NAMES = {"s": "Second", "ms": "Millisecond",
               "us": "Microsecond", "ns": "Nanosecond"}
_ID_NAMES = {
    TypeId.NULL: "Null", TypeId.BOOL: "Boolean", TypeId.STRING: "Utf8",
    TypeId.BINARY: "Binary",
    TypeId.UINT8: "UInt8", TypeId.UINT16: "UInt16",
    TypeId.UINT32: "UInt32", TypeId.UINT64: "UInt64",
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical SQL type. Immutable and hashable.

    ``precision``/``scale`` used by DECIMAL; ``unit`` by TIMESTAMP ('s','ms',
    'us','ns'); ``inner`` by LIST; ``fields`` by STRUCT.
    """

    id: TypeId
    precision: int = 0
    scale: int = 0
    unit: str = "us"
    inner: Optional["DataType"] = None
    fields: Tuple[Tuple[str, "DataType"], ...] = ()
    tz: Optional[str] = None   # TIMESTAMP only; values always stored UTC

    # ---- classification -------------------------------------------------
    @property
    def is_null(self) -> bool:
        return self.id == TypeId.NULL

    @property
    def is_integer(self) -> bool:
        return self.id in _INT_IDS

    @property
    def is_signed_integer(self) -> bool:
        return self.id in (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)

    @property
    def is_float(self) -> bool:
        return self.id in _FLOAT_IDS

    @property
    def is_decimal(self) -> bool:
        return self.id == TypeId.DECIMAL

    @property
    def is_wide_decimal(self) -> bool:
        """Decimal stored as exact Python ints (object ndarray) instead of
        int64 lanes: Decimal256 (precision > 38), or a scale whose scaled
        integers structurally overflow int64 (10^scale > 2^63). Decimal128
        at moderate scales keeps the int64 fast path (18-digit effective
        exactness, the engine's documented decimal posture); wide decimals
        are excluded from device lowering."""
        return self.id == TypeId.DECIMAL and (
            self.precision > 38 or self.scale > 18)

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_float or self.is_decimal

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.STRING

    @property
    def is_dict_coded(self) -> bool:
        """Represented as dictionary codes + value table (string/binary)."""
        return self.id in (TypeId.STRING, TypeId.BINARY)

    @property
    def is_temporal(self) -> bool:
        return self.id in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIME)

    @property
    def is_boolean(self) -> bool:
        return self.id == TypeId.BOOL

    @property
    def is_interval(self) -> bool:
        return self.id == TypeId.INTERVAL

    @property
    def is_nested(self) -> bool:
        return self.id in (TypeId.LIST, TypeId.STRUCT)

    # ---- device representation ------------------------------------------
    def device_dtype(self) -> np.dtype:
        """The numpy/jax dtype of the on-device array backing this type."""
        m = {
            TypeId.NULL: np.int32,
            TypeId.BOOL: np.bool_,
            TypeId.INT8: np.int32,
            TypeId.INT16: np.int32,
            TypeId.INT32: np.int32,
            TypeId.INT64: np.int64,
            TypeId.UINT8: np.int32,
            TypeId.UINT16: np.int32,
            TypeId.UINT32: np.int64,   # widen to preserve range
            TypeId.UINT64: np.uint64,  # full range on host; device kernels
                                       # reinterpret as int64 lanes
            TypeId.FLOAT32: np.float32,
            TypeId.FLOAT64: np.float64,
            TypeId.DECIMAL: np.int64,
            TypeId.STRING: np.int32,   # dictionary codes
            TypeId.BINARY: np.int32,   # dictionary codes
            TypeId.DATE: np.int32,
            TypeId.TIMESTAMP: np.int64,
            TypeId.TIME: np.int64,
            TypeId.INTERVAL: np.int64,
        }
        if self.id == TypeId.DATE and self.unit == "ms":
            return np.dtype(np.int64)   # Date64: epoch milliseconds
        if self.is_wide_decimal:
            # exact Python ints on host; never staged to device
            return np.dtype(object)
        if self.id == TypeId.INTERVAL and \
                not (self.unit or "").startswith("rawdur"):
            # packed MonthDayNano i128 analog (incl. dur_day, which stores
            # packed day counts): exact Python ints on host
            return np.dtype(object)
        if self.id not in m:
            raise NotImplementedError(f"no device repr for {self}")
        return np.dtype(m[self.id])

    def bit_width(self) -> int:
        return self.device_dtype().itemsize * 8

    # ---- display ---------------------------------------------------------
    def __str__(self) -> str:
        # matches arrow DataType's Display exactly (what the reference's
        # arrow_typeof and plan text print; sqllogictest compares these)
        if self.id == TypeId.DECIMAL:
            w = 256 if self.precision > 38 else 128
            return f"Decimal{w}({self.precision}, {self.scale})"
        if self.id == TypeId.TIMESTAMP:
            tz = f'Some("{self.tz}")' if self.tz else "None"
            return f"Timestamp({_UNIT_NAMES[self.unit]}, {tz})"
        if self.id == TypeId.TIME:
            bits = 32 if self.unit in ("s", "ms") else 64
            return f"Time{bits}({_UNIT_NAMES[self.unit]})"
        if self.id == TypeId.DATE:
            return "Date64" if self.unit == "ms" else "Date32"
        if self.id == TypeId.INTERVAL:
            if self.unit.startswith("dur"):
                u = _UNIT_NAMES.get(self.unit[4:], "Millisecond")
                return f"Duration({u})"
            style = {"dt": "DayTime", "ym": "YearMonth"}.get(self.unit,
                                                             "MonthDayNano")
            return f"Interval({style})"
        if self.id == TypeId.LIST:
            return f"List({self.inner})"
        if self.id == TypeId.STRUCT:
            return "Struct(" + ", ".join(f"{n}: {t}" for n, t in self.fields) + ")"
        return _ID_NAMES.get(self.id) or self.id.value.capitalize()

    def __repr__(self) -> str:
        return str(self)


# Singleton-ish constructors ------------------------------------------------
NULL = DataType(TypeId.NULL)
BOOL = DataType(TypeId.BOOL)
INT8 = DataType(TypeId.INT8)
INT16 = DataType(TypeId.INT16)
INT32 = DataType(TypeId.INT32)
INT64 = DataType(TypeId.INT64)
UINT8 = DataType(TypeId.UINT8)
UINT16 = DataType(TypeId.UINT16)
UINT32 = DataType(TypeId.UINT32)
UINT64 = DataType(TypeId.UINT64)
FLOAT32 = DataType(TypeId.FLOAT32)
FLOAT64 = DataType(TypeId.FLOAT64)
STRING = DataType(TypeId.STRING)
BINARY = DataType(TypeId.BINARY)
DATE = DataType(TypeId.DATE)          # Date32: int32 days since epoch
DATE64 = DataType(TypeId.DATE, unit="ms")  # Date64: int64 ms since epoch
TIME = DataType(TypeId.TIME, unit="ns")
INTERVAL = DataType(TypeId.INTERVAL, unit="mdn")
INTERVAL_DT = DataType(TypeId.INTERVAL, unit="dt")    # Interval(DayTime)
INTERVAL_YM = DataType(TypeId.INTERVAL, unit="ym")    # Interval(YearMonth)


def decimal(precision: int, scale: int) -> DataType:
    # precision <= 18 rides int64 on host and device; wider decimals
    # (Decimal128 beyond 18 digits, Decimal256) are exact Python-int
    # object arrays on the host and never lower to device programs
    return DataType(TypeId.DECIMAL, precision=min(precision, 76),
                    scale=scale)


def timestamp(unit: str = "us", tz: Optional[str] = None) -> DataType:
    assert unit in ("s", "ms", "us", "ns")
    return DataType(TypeId.TIMESTAMP, unit=unit, tz=tz)


def time(unit: str = "ns") -> DataType:
    """Time-of-day; unit covers arrow Time32(s/ms) and Time64(us/ns)."""
    assert unit in ("s", "ms", "us", "ns")
    return DataType(TypeId.TIME, unit=unit)


def list_(inner: DataType) -> DataType:
    return DataType(TypeId.LIST, inner=inner)


def struct(fields) -> DataType:
    return DataType(TypeId.STRUCT, fields=tuple(fields))


_INT_RANK = {
    TypeId.INT8: 1, TypeId.UINT8: 1,
    TypeId.INT16: 2, TypeId.UINT16: 2,
    TypeId.INT32: 3, TypeId.UINT32: 3,
    TypeId.INT64: 4, TypeId.UINT64: 4,
}


def _as_decimal(t: DataType) -> DataType:
    """Integer -> decimal coercion (reference:
    type_coercion/binary.rs coerce_numeric_type_to_decimal):
    i8->(3,0) i16->(5,0) i32->(10,0) i64->(20,0)."""
    if t.is_decimal:
        return t
    p = {1: 3, 2: 5, 3: 10, 4: 20}[_INT_RANK[t.id]]
    return decimal(p, 0)


def decimal_arith_type(op_char: str, a: DataType, b: DataType) -> DataType:
    """Output type of decimal arithmetic, matching arrow-rs decimal kernel
    typing used by the reference (binary.rs / arrow arithmetic::decimal):
    add/sub: (max(s1,s2) + max(p1-s1, p2-s2) + 1, max(s1,s2))
    mul:     (p1 + p2 + 1, s1 + s2)
    div:     (p1 + s2 + 4, s1 + 4)
    mod:     (min(p1-s1, p2-s2) + max(s1,s2), max(s1,s2))
    precision capped at 38. Verified against the reference decimal.slt
    arrow_typeof answers (c1 DECIMAL(10,6), c5 DECIMAL(12,7))."""
    a, b = _as_decimal(a), _as_decimal(b)
    p1, s1, p2, s2 = a.precision, a.scale, b.precision, b.scale
    if op_char in "+-":
        s = max(s1, s2)
        p = s + max(p1 - s1, p2 - s2) + 1
    elif op_char == "*":
        s = s1 + s2
        p = p1 + p2 + 1
    elif op_char == "/":
        s = s1 + 4
        p = p1 + s2 + 4
    else:   # %
        s = max(s1, s2)
        p = min(p1 - s1, p2 - s2) + s
    return decimal(min(p, 38), min(s, 38))


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Binary numeric coercion, mirroring DataFusion's type_coercion rules
    (`datafusion/expr/src/type_coercion/binary.rs`) at the granularity our
    device reprs distinguish."""
    if a == b:
        return a
    if a.is_null:
        return b
    if b.is_null:
        return a
    if a.is_float or b.is_float:
        if a.id == TypeId.FLOAT64 or b.id == TypeId.FLOAT64 or a.is_decimal or b.is_decimal or \
           a.id == TypeId.INT64 or b.id == TypeId.INT64:
            return FLOAT64
        return FLOAT32 if (a.id == TypeId.FLOAT32 and b.is_integer) or (b.id == TypeId.FLOAT32 and a.is_integer) or (a.id == b.id == TypeId.FLOAT32) else FLOAT64
    if a.is_decimal and b.is_decimal:
        scale = max(a.scale, b.scale)
        whole = max(a.precision - a.scale, b.precision - b.scale)
        return decimal(min(whole + scale, 38), scale)
    if a.is_decimal and b.is_integer:
        return decimal(max(a.precision, _INT_RANK[b.id] * 5 + a.scale), a.scale)
    if b.is_decimal and a.is_integer:
        return common_numeric_type(b, a)
    if a.is_integer and b.is_integer:
        rank = max(_INT_RANK[a.id], _INT_RANK[b.id])
        return {1: INT8, 2: INT16, 3: INT32, 4: INT64}[rank] if a.is_signed_integer and b.is_signed_integer else \
               {1: INT16, 2: INT32, 3: INT64, 4: INT64}[rank] if (a.is_signed_integer != b.is_signed_integer) else \
               {1: UINT8, 2: UINT16, 3: UINT32, 4: UINT64}[rank]
    raise TypeError(f"no common numeric type for {a} and {b}")
