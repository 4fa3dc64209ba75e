"""Foundation layer: types, schema, scalars, columnar substrate, config,
errors, statistics.

Reference parity: the `datafusion-common` crate (SURVEY.md §2.1).
"""
from . import datatypes as dt  # noqa: F401
from .batch import Batch, concat_batches, round_capacity  # noqa: F401
from .column import Column, Dictionary, concat_columns  # noqa: F401
from .config import ConfigOptions  # noqa: F401
from .datatypes import DataType, TypeId  # noqa: F401
from .errors import (  # noqa: F401
    DataFusionError, ExecutionError, InternalError, ParserError, PlanError,
    ResourcesExhausted, SchemaError, internal,
)
from .scalar import ScalarValue  # noqa: F401
from .schema import Field, Schema  # noqa: F401
from .stats import ColumnStatistics, Precision, Statistics  # noqa: F401
