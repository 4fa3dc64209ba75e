"""Function signature registry: name -> return type rules.

Reference parity: `Signature`/`TypeSignature` (`datafusion/expr/src/signature.rs:40,88`)
and the return-type logic of each ScalarUDFImpl / AggregateUDF.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from ..common import dt
from ..common.datatypes import DataType
from ..common.errors import PlanError

# --------------------------------------------------------------------------
# scalar functions
# --------------------------------------------------------------------------

def _unify_elem(args: List[DataType]) -> DataType:
    """Common element type of make_array args: NULL args defer to the
    other elements; numerics widen (reference: coerce_arguments_for_
    signature ArrayAppend/MakeArray coercion)."""
    elem = dt.NULL
    for t in args:
        if t.is_null:
            continue
        if elem.is_null:
            elem = t
        elif elem != t and elem.is_numeric and t.is_numeric:
            elem = dt.common_numeric_type(elem, t)
    return elem


def _same(args: List[DataType]) -> DataType:
    return args[0]


def _f64(args) -> DataType:
    return dt.FLOAT64


def _str(args) -> DataType:
    return dt.STRING


def _i64(args) -> DataType:
    return dt.INT64


def _i32(args) -> DataType:
    return dt.INT32


def _bool(args) -> DataType:
    return dt.BOOL


def _date(args) -> DataType:
    return dt.DATE


def _ts(args) -> DataType:
    return dt.timestamp("ns")


def _numeric_same(args) -> DataType:
    a = args[0]
    return a if a.is_numeric else dt.FLOAT64


def _float_same(args) -> DataType:
    """Float32 stays Float32, everything else computes in Float64
    (reference: functions/src/math — math_unary_function signatures)."""
    return dt.FLOAT32 if args and args[0] == dt.FLOAT32 else dt.FLOAT64


def _float_coerce(args) -> DataType:
    """one_of([F32...], [F64...]) signatures (reference atan2/nanvl/log,
    macros.rs:295-299): the Float32 signature is listed first, so any
    argument set with no Float64 member coerces to Float32."""
    if args and all(a == dt.FLOAT32 or a.is_integer or a.is_null
                    for a in args):
        return dt.FLOAT32
    return dt.FLOAT64


SCALAR_FUNCTIONS: Dict[str, Callable[[List[DataType]], DataType]] = {
    # math (reference: functions/src/math/)
    "abs": _numeric_same, "ceil": _numeric_same, "floor": _numeric_same,
    "round": _numeric_same, "trunc": _numeric_same, "sign": _numeric_same,
    "signum": _float_same,
    "sqrt": _float_same, "cbrt": _float_same, "exp": _float_same,
    "ln": _float_same, "log": _float_coerce,
    "log2": _float_same, "log10": _float_same, "power": _f64, "pow": _f64,
    "sin": _float_same, "cos": _float_same, "tan": _float_same,
    "asin": _float_same, "acos": _float_same,
    "atan": _float_same, "atan2": _float_coerce, "sinh": _float_same,
    "cosh": _float_same, "tanh": _float_same,
    "asinh": _float_same, "acosh": _float_same, "atanh": _float_same,
    "degrees": _float_same,
    "radians": _float_same, "pi": _f64, "random": _f64, "factorial": _i64,
    "gcd": _i64, "lcm": _i64, "isnan": _bool, "iszero": _bool,
    "nanvl": _float_coerce, "cot": _float_same, "mod": _numeric_same,
    # core (functions/src/core/)
    "coalesce": _same, "nullif": _same, "nvl": _same, "nvl2": lambda a: a[1],
    "ifnull": _same, "arrow_typeof": _str,
    # struct family — names resolved with literal args in
    # ScalarFunction.data_type; these are the type-only fallbacks
    "struct": lambda a: dt.struct((f"c{i}", t) for i, t in enumerate(a)),
    "row": lambda a: dt.struct((f"c{i}", t) for i, t in enumerate(a)),
    "named_struct": lambda a: dt.struct(
        (f"c{i}", t) for i, t in enumerate(a[1::2])),
    "get_field": lambda a: dt.NULL,
    # string (functions/src/string/, unicode/)
    "ascii": _i32, "bit_length": _i32, "btrim": _str, "char_length": _i32,
    "character_length": _i32, "length": _i32, "chr": _str, "concat": _str,
    "concat_ws": _str, "initcap": _str, "left": _str, "lower": _str,
    "lpad": _str, "ltrim": _str, "octet_length": _i32, "repeat": _str,
    "replace": _str, "reverse": _str, "right": _str, "rpad": _str,
    "rtrim": _str, "split_part": _str, "starts_with": _bool,
    "ends_with": _bool, "strpos": _i32, "substr": _str, "substring": _str,
    "translate": _str, "trim": _str, "upper": _str, "uuid": _str,
    "levenshtein": _i32, "find_in_set": _i32, "to_hex": _str,
    "substring_index": _str,
    "overlay": _str, "instr": _i32, "position": _i32, "contains": _bool,
    # regex (functions/src/regex/)
    "regexp_like": _bool, "regexp_match": lambda a: dt.list_(dt.STRING),
    "regexp_replace": _str, "regexp_count": _i64,
    "regexp_match_op": _bool, "regexp_imatch_op": _bool,
    "regexp_not_match_op": _bool, "regexp_not_imatch_op": _bool,
    # datetime (functions/src/datetime/)
    "date_trunc": lambda a: (a[1] if len(a) > 1 and not a[1].is_null
                             else dt.timestamp("ns")),
    "date_part": _f64, "datepart": _f64,
    "date_bin": lambda a: a[-1] if a else dt.timestamp("us"),
    "to_date": _date,
    "to_timestamp": _ts, "to_timestamp_micros": lambda a: dt.timestamp("us"),
    "to_timestamp_millis": lambda a: dt.timestamp("ms"),
    "to_timestamp_seconds": lambda a: dt.timestamp("s"),
    "to_timestamp_nanos": lambda a: dt.timestamp("ns"),
    "now": _ts, "current_date": _date, "current_time": lambda a: dt.TIME,
    "today": _date, "make_date": _date, "to_char": _str,
    "date_format": _str,
    "to_unixtime": _i64, "from_unixtime": lambda a: dt.timestamp("s"),
    "at_time_zone": _same,
    # crypto/encoding (host-side)
    "md5": _str, "sha224": _str, "sha256": _str, "sha384": _str,
    "sha512": _str, "digest": _str, "encode": _str, "decode": _str,
    # arrays (functions-array/src/)
    "make_array": lambda a: dt.list_(_unify_elem(a)),
    "string_to_array": lambda a: dt.list_(dt.STRING),
    "string_to_list": lambda a: dt.list_(dt.STRING),
    "array_slice": _same, "array_distinct": _same, "list_distinct": _same,
    "array_sort": _same, "list_sort": _same, "array_reverse": _same,
    "array_union": _same, "array_intersect": _same, "array_except": _same,
    "array_remove": _same, "array_remove_all": _same,
    "array_pop_back": _same, "array_pop_front": _same,
    "array_repeat": lambda a: dt.list_(a[0]),
    "empty": _bool, "array_empty": _bool,
    "generate_series": lambda a: dt.list_(dt.INT64),
    "range": lambda a: dt.list_(dt.INT64),
    "array": lambda a: dt.list_(a[0] if a else dt.NULL),
    "array_length": _i64, "cardinality": _i64,
    "array_element": lambda a: (a[0].inner or dt.NULL),
    "array_extract": lambda a: (a[0].inner or dt.NULL),
    "list_element": lambda a: (a[0].inner or dt.NULL),
    "list_extract": lambda a: (a[0].inner or dt.NULL),
    "array_concat": _same, "array_cat": _same,
    "array_append": _same, "array_prepend": lambda a: a[-1],
    "array_contains": _bool, "array_has": _bool, "list_has": _bool,
    "array_position": _i64, "list_position": _i64,
    "array_indexof": _i64, "list_indexof": _i64,
    "list_append": _same, "list_push_back": _same,
    "list_prepend": lambda a: a[-1], "list_push_front": lambda a: a[-1],
    "array_positions": lambda a: dt.list_(dt.INT64),
    "list_positions": lambda a: dt.list_(dt.INT64),
    "array_to_string": _str, "array_join": _str,
    "list_to_string": _str, "list_join": _str,
    "array_has_all": _bool, "list_has_all": _bool,
    "array_has_any": _bool, "list_has_any": _bool,
    "arrays_overlap": _bool,
    "array_replace": _same, "list_replace": _same,
    "array_replace_n": _same, "list_replace_n": _same,
    "array_replace_all": _same, "list_replace_all": _same,
    "array_remove_n": _same, "list_remove_n": _same,
    "array_resize": _same, "list_resize": _same,
    "array_dims": lambda a: dt.list_(dt.INT64),
    "list_dims": lambda a: dt.list_(dt.INT64),
    "array_ndims": _i64, "list_ndims": _i64,
    "list_empty": _bool,
    "flatten": _same,
    "range_list": lambda a: dt.list_(dt.INT64),
    # misc
    "version": _str,
}


# Fixed arities for scalar functions whose signature admits an exact
# argument count (reference: each ScalarUDFImpl's Signature; mismatches are
# "Error during planning: No function matches the given name and argument
# types"). Entries are sets of allowed counts; unlisted names are unchecked.
SCALAR_ARITY: Dict[str, frozenset] = {
    "pi": frozenset({0}), "random": frozenset({0}), "now": frozenset({0}),
    "current_date": frozenset({0}), "current_time": frozenset({0}),
    "today": frozenset({0}), "uuid": frozenset({0}),
    "version": frozenset({0}),
    "abs": frozenset({1}), "sqrt": frozenset({1}), "cbrt": frozenset({1}),
    "exp": frozenset({1}), "ln": frozenset({1}), "log2": frozenset({1}),
    "log10": frozenset({1}), "sin": frozenset({1}), "cos": frozenset({1}),
    "tan": frozenset({1}), "asin": frozenset({1}), "acos": frozenset({1}),
    "atan": frozenset({1}), "sinh": frozenset({1}), "cosh": frozenset({1}),
    "tanh": frozenset({1}), "asinh": frozenset({1}), "acosh": frozenset({1}),
    "atanh": frozenset({1}), "degrees": frozenset({1}),
    "radians": frozenset({1}), "signum": frozenset({1}),
    "factorial": frozenset({1}), "isnan": frozenset({1}),
    "iszero": frozenset({1}), "cot": frozenset({1}),
    "ceil": frozenset({1}), "floor": frozenset({1}),
    "sign": frozenset({1}), "ascii": frozenset({1}),
    "bit_length": frozenset({1}), "char_length": frozenset({1}),
    "character_length": frozenset({1}), "length": frozenset({1}),
    "chr": frozenset({1}), "initcap": frozenset({1}),
    "lower": frozenset({1}), "upper": frozenset({1}),
    "octet_length": frozenset({1}), "reverse": frozenset({1}),
    "md5": frozenset({1}), "sha224": frozenset({1}),
    "sha256": frozenset({1}), "sha384": frozenset({1}),
    "sha512": frozenset({1}), "arrow_typeof": frozenset({1}),
    "to_hex": frozenset({1}), "levenshtein": frozenset({2}),
    "find_in_set": frozenset({2}), "strpos": frozenset({2}),
    "left": frozenset({2}), "right": frozenset({2}),
    "repeat": frozenset({2}), "starts_with": frozenset({2}),
    "ends_with": frozenset({2}), "split_part": frozenset({3}),
    "translate": frozenset({3}), "replace": frozenset({3}),
    "power": frozenset({2}), "pow": frozenset({2}),
    "atan2": frozenset({2}), "nanvl": frozenset({2}),
    "gcd": frozenset({2}), "lcm": frozenset({2}), "mod": frozenset({2}),
    "log": frozenset({1, 2}), "round": frozenset({1, 2}),
    "trunc": frozenset({1, 2}), "make_date": frozenset({3}),
    "nullif": frozenset({2}), "nvl": frozenset({2}),
    "ifnull": frozenset({2}), "nvl2": frozenset({3}),
    "substr": frozenset({2, 3}), "substring": frozenset({2, 3}),
    "lpad": frozenset({2, 3}), "rpad": frozenset({2, 3}),
    "date_part": frozenset({2}), "datepart": frozenset({2}),
    "date_trunc": frozenset({2}), "date_bin": frozenset({2, 3}),
}


def scalar_return_type(name: str, arg_types: List[DataType]) -> DataType:
    from .udf import SCALAR_UDFS
    u = SCALAR_UDFS.get(name)
    if u is not None:
        return u.return_type
    f = SCALAR_FUNCTIONS.get(name)
    if f is None:
        raise PlanError(f"Invalid function '{name}'")
    return f(arg_types)


def is_scalar_function(name: str) -> bool:
    from .udf import SCALAR_UDFS
    return name in SCALAR_FUNCTIONS or name in SCALAR_UDFS


# --------------------------------------------------------------------------
# aggregate functions
# --------------------------------------------------------------------------

def _sum_type(args: List[DataType]) -> DataType:
    a = args[0]
    if a.is_temporal:
        # the reference rejects sum over dates/times/timestamps
        # (sum.rs coerce_types: "Sum not supported for {t}")
        raise PlanError(f"Sum not supported for {a}")
    if a.is_decimal:
        # reference widens sum(decimal(p,s)) -> decimal(min(cap,p+10),s);
        # cap is 38 for Decimal128, 76 for Decimal256 inputs
        cap = 76 if a.precision > 38 else 38
        return dt.decimal(min(cap, a.precision + 10), a.scale)
    if a.is_integer:
        # unsigned sums widen to UInt64, signed to Int64 (sum.rs signature)
        return dt.INT64 if a.is_signed_integer else dt.UINT64
    return dt.FLOAT64


def _avg_type(args: List[DataType]) -> DataType:
    a = args[0]
    if a.is_temporal:
        raise PlanError(f"Avg not supported for {a}")
    if a.is_decimal:
        cap = 76 if a.precision > 38 else 38
        return dt.decimal(min(cap, a.precision + 4), min(a.scale + 4, cap))
    return dt.FLOAT64


AGGREGATE_FUNCTIONS: Dict[str, Callable[[List[DataType]], DataType]] = {
    "count": lambda a: dt.INT64,
    "sum": _sum_type,
    "avg": _avg_type, "mean": _avg_type,
    "min": _same, "max": _same,
    "median": _same,
    "stddev": _f64, "stddev_samp": _f64, "stddev_pop": _f64,
    "var": _f64, "variance": _f64, "var_samp": _f64, "var_pop": _f64,
    "covar": _f64, "covar_samp": _f64, "covar_pop": _f64, "corr": _f64,
    "first_value": _same, "last_value": _same,
    "array_agg": lambda a: dt.list_(a[0]),
    "string_agg": _str,
    "bit_and": _same, "bit_or": _same, "bit_xor": _same,
    "bool_and": _bool, "bool_or": _bool, "every": _bool,
    "approx_distinct": lambda a: dt.UINT64,
    "approx_median": lambda a: dt.FLOAT64 if a[0].is_decimal else a[0],
    "approx_percentile_cont": lambda a: dt.FLOAT64 if a[0].is_decimal else a[0],
    "approx_percentile_cont_with_weight":
        lambda a: dt.FLOAT64 if a[0].is_decimal else a[0],
    "nth_value": _same,
    "grouping": lambda a: dt.INT32,
    "regr_slope": _f64, "regr_intercept": _f64, "regr_count": _i64,
    "regr_r2": _f64, "regr_avgx": _f64, "regr_avgy": _f64,
    "regr_sxx": _f64, "regr_syy": _f64, "regr_sxy": _f64,
}


def aggregate_return_type(name: str, arg_types: List[DataType]) -> DataType:
    from .udf import AGGREGATE_UDFS
    u = AGGREGATE_UDFS.get(name)
    if u is not None:
        return u.return_type
    f = AGGREGATE_FUNCTIONS.get(name)
    if f is None:
        raise PlanError(f"Invalid aggregate function '{name}'")
    if not arg_types:
        return dt.INT64  # count(*)
    return f(arg_types)


def is_aggregate_function(name: str) -> bool:
    from .udf import AGGREGATE_UDFS
    return name in AGGREGATE_FUNCTIONS or name in AGGREGATE_UDFS


# --------------------------------------------------------------------------
# window functions (built-ins beyond aggregates-as-window)
# --------------------------------------------------------------------------

WINDOW_FUNCTIONS: Dict[str, Callable[[List[DataType]], DataType]] = {
    # reference: ranks/row_number/ntile return UInt64
    # (functions-window row_number.rs, rank.rs, ntile.rs)
    "row_number": lambda a: dt.UINT64,
    "rank": lambda a: dt.UINT64,
    "dense_rank": lambda a: dt.UINT64,
    "percent_rank": _f64,
    "cume_dist": _f64,
    "ntile": lambda a: dt.UINT64,
    "lag": _same, "lead": _same,
    "first_value": _same, "last_value": _same,
    "nth_value": _same,
}


def window_return_type(name: str, arg_types: List[DataType]) -> DataType:
    from .udf import WINDOW_UDFS
    u = WINDOW_UDFS.get(name)
    if u is not None:
        return u.return_type
    if name in WINDOW_FUNCTIONS:
        if not arg_types and name in ("row_number", "rank", "dense_rank", "ntile"):
            return WINDOW_FUNCTIONS[name]([])
        return WINDOW_FUNCTIONS[name](arg_types)
    return aggregate_return_type(name, arg_types)


def is_window_function(name: str) -> bool:
    from .udf import WINDOW_UDFS
    return name in WINDOW_FUNCTIONS or name in WINDOW_UDFS
