"""Statistics with exactness tracking.

Reference parity: `Statistics`/`Precision` (`datafusion/common/src/stats.rs:29,218`).
Used by join-side selection, broadcast thresholds, and pruning.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional


class Exactness(enum.Enum):
    EXACT = "exact"
    INEXACT = "inexact"
    ABSENT = "absent"


@dataclasses.dataclass
class Precision:
    value: Optional[Any] = None
    exactness: Exactness = Exactness.ABSENT

    @staticmethod
    def exact(v) -> "Precision":
        return Precision(v, Exactness.EXACT)

    @staticmethod
    def inexact(v) -> "Precision":
        return Precision(v, Exactness.INEXACT)

    @staticmethod
    def absent() -> "Precision":
        return Precision()

    @property
    def is_exact(self) -> bool:
        return self.exactness == Exactness.EXACT

    def get(self, default=None):
        return self.value if self.value is not None else default

    def to_inexact(self) -> "Precision":
        if self.exactness == Exactness.EXACT:
            return Precision(self.value, Exactness.INEXACT)
        return self

    def add(self, other: "Precision") -> "Precision":
        if self.value is None or other.value is None:
            return Precision.absent()
        ex = Exactness.EXACT if self.is_exact and other.is_exact else Exactness.INEXACT
        return Precision(self.value + other.value, ex)

    def __repr__(self):
        if self.exactness == Exactness.ABSENT:
            return "Absent"
        tag = "Exact" if self.is_exact else "Inexact"
        return f"{tag}({self.value})"


@dataclasses.dataclass
class ColumnStatistics:
    null_count: Precision = dataclasses.field(default_factory=Precision.absent)
    min_value: Precision = dataclasses.field(default_factory=Precision.absent)
    max_value: Precision = dataclasses.field(default_factory=Precision.absent)
    distinct_count: Precision = dataclasses.field(default_factory=Precision.absent)


@dataclasses.dataclass
class Statistics:
    num_rows: Precision = dataclasses.field(default_factory=Precision.absent)
    total_byte_size: Precision = dataclasses.field(default_factory=Precision.absent)
    column_statistics: List[ColumnStatistics] = dataclasses.field(default_factory=list)

    @staticmethod
    def unknown(num_columns: int = 0) -> "Statistics":
        return Statistics(column_statistics=[ColumnStatistics() for _ in range(num_columns)])

    def to_inexact(self) -> "Statistics":
        return Statistics(self.num_rows.to_inexact(), self.total_byte_size.to_inexact(),
                          self.column_statistics)

    def scale_rows(self, selectivity: float) -> "Statistics":
        nr = self.num_rows
        if nr.value is not None:
            nr = Precision.inexact(int(nr.value * selectivity))
        bs = self.total_byte_size
        if bs.value is not None:
            bs = Precision.inexact(int(bs.value * selectivity))
        return Statistics(nr, bs, self.column_statistics)
