"""User-defined functions.

Reference parity: `ScalarUDF(Impl)` (`datafusion/expr/src/udf.rs:56`),
`AggregateUDF` (`udaf.rs:69`), `WindowUDF` (`udwf.rs`), and the
`Accumulator` trait (`accumulator.rs:52`).

Scalar UDFs are vectorized: the callable receives one numpy array per
argument (NULL slots carry arbitrary in-range values; a separate validity
mask is ANDed into the result). Aggregate UDFs implement the grouped
accumulator protocol (update/merge/state/evaluate over dense group ids —
`groups_accumulator.rs:25`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..common.datatypes import DataType
from ..common.errors import PlanError


class ScalarUDF:
    def __init__(self, name: str, fn: Callable, input_types: List[DataType],
                 return_type: DataType, volatility: str = "immutable"):
        self.name = name.lower()
        self.fn = fn
        self.input_types = input_types
        self.return_type = return_type
        self.volatility = volatility   # immutable | stable | volatile


class AggregateUDF:
    """`accumulator_factory()` must return an object implementing the
    GroupsAccumulator protocol (physical/aggregates.py)."""

    def __init__(self, name: str, accumulator_factory: Callable,
                 input_types: List[DataType], return_type: DataType,
                 state_types: Optional[List[DataType]] = None):
        self.name = name.lower()
        self.accumulator_factory = accumulator_factory
        self.input_types = input_types
        self.return_type = return_type
        self.state_types = state_types


class WindowUDF:
    """`evaluator(args: List[np.ndarray], partition_slices) -> np.ndarray`
    (reference: PartitionEvaluator, `expr/src/partition_evaluator.rs:89`)."""

    def __init__(self, name: str, evaluator: Callable,
                 input_types: List[DataType], return_type: DataType):
        self.name = name.lower()
        self.evaluator = evaluator
        self.input_types = input_types
        self.return_type = return_type


# global registries (sessions also keep their own view; the SQL planner's
# type resolution consults these)
SCALAR_UDFS: Dict[str, ScalarUDF] = {}
AGGREGATE_UDFS: Dict[str, AggregateUDF] = {}
WINDOW_UDFS: Dict[str, WindowUDF] = {}


def register_scalar_udf(udf: ScalarUDF) -> None:
    SCALAR_UDFS[udf.name] = udf


def register_aggregate_udf(udf: AggregateUDF) -> None:
    AGGREGATE_UDFS[udf.name] = udf


def register_window_udf(udf: WindowUDF) -> None:
    WINDOW_UDFS[udf.name] = udf
