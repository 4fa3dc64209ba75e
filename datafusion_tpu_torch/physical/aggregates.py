"""Grouped aggregate accumulators.

Reference parity: the `GroupsAccumulator` trait
(`datafusion/expr/src/groups_accumulator.rs:25` — update_batch /
merge_batch / state / evaluate over dense group indices) and the built-in
aggregates (`datafusion/functions-aggregate/src/`). State is dense
per-group tensors (one slot per group id) updated with vectorized
scatter-reductions — exactly the layout the TPU segment-reduce kernels use.

Two-phase protocol (AggregateMode Partial -> Final, `aggregates/mod.rs:64`):
  Partial:  update(values, group_ids) ... state() -> per-group state columns
  Final:    merge(state_cols, group_ids) ... evaluate() -> result column
Accumulators with non-scalar state (median, count distinct, array_agg)
report supports_two_phase() = False and the planner keeps them single-phase.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..common import dt
from ..common.column import Column, Dictionary
from ..common.datatypes import DataType, TypeId
from ..common.errors import ExecutionError, internal
from ..common.schema import Field
from . import kernels as K


def _grow(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if len(arr) >= n:
        return arr
    out = np.full(n, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class GroupsAccumulator:
    name: str = "?"

    def __init__(self, in_type: DataType, out_type: DataType):
        self.in_type = in_type
        self.out_type = out_type

    # number of raw input argument columns
    num_args = 1

    def supports_two_phase(self) -> bool:
        return True

    def update(self, values: List[Column], group_ids: np.ndarray, n_groups: int) -> None:
        raise NotImplementedError

    def merge(self, states: List[Column], group_ids: np.ndarray, n_groups: int) -> None:
        raise NotImplementedError

    def state(self, n_groups: int) -> List[Column]:
        raise NotImplementedError

    def state_fields(self, base: str) -> List[Field]:
        raise NotImplementedError

    def evaluate(self, n_groups: int) -> Column:
        raise NotImplementedError


# --------------------------------------------------------------------------
# count
# --------------------------------------------------------------------------

class CountAcc(GroupsAccumulator):
    name = "count"

    def __init__(self, in_type, out_type, count_star: bool = False,
                 nargs: int = 1):
        super().__init__(in_type, dt.INT64)
        self.counts = np.zeros(0, np.int64)
        self.count_star = count_star
        self.num_args = 0 if count_star else nargs

    def update(self, values, group_ids, n_groups):
        self.counts = _grow(self.counts, n_groups, 0)
        if self.count_star or not values:
            np.add.at(self.counts, group_ids, 1)
        else:
            # count(a, b, ...) counts rows where EVERY argument is non-null
            # (reference: functions-aggregate/src/count.rs multi-expr path)
            m = K.valid_mask(values[0])
            for extra in values[1:]:
                m = m & K.valid_mask(extra)
            np.add.at(self.counts, group_ids[m], 1)

    def merge(self, states, group_ids, n_groups):
        self.counts = _grow(self.counts, n_groups, 0)
        np.add.at(self.counts, group_ids, states[0].data_host())

    def state(self, n_groups):
        return [Column(dt.INT64, _grow(self.counts, n_groups, 0))]

    def state_fields(self, base):
        return [Field(f"{base}[count]", dt.INT64, False)]

    def evaluate(self, n_groups):
        return Column(dt.INT64, _grow(self.counts, n_groups, 0))


# --------------------------------------------------------------------------
# sum / avg
# --------------------------------------------------------------------------

class SumAcc(GroupsAccumulator):
    name = "sum"

    def __init__(self, in_type, out_type):
        super().__init__(in_type, out_type)
        self._npdt = out_type.device_dtype()
        # reference sums Float32 in f32 (sum.rs uses the input's native
        # accumulator); results carry f32 rounding though typed Float64
        if in_type.id == TypeId.FLOAT32 and out_type.is_float:
            self._npdt = np.dtype(np.float32)
        self.sums = np.zeros(0, self._npdt)
        self.counts = np.zeros(0, np.int64)

    def _vals(self, c: Column) -> np.ndarray:
        if self.out_type.is_decimal:
            src_scale = c.dtype.scale if c.dtype.is_decimal else 0
            data = c.data_host().astype(np.int64)
            if src_scale != self.out_type.scale:
                data = data * 10 ** (self.out_type.scale - src_scale)
            return data
        return K.cast_column(c, self.out_type).data_host().astype(self._npdt)

    def update(self, values, group_ids, n_groups):
        self.sums = _grow(self.sums, n_groups, 0)
        self.counts = _grow(self.counts, n_groups, 0)
        c = values[0]
        m = K.valid_mask(c)
        v = self._vals(c)
        np.add.at(self.sums, group_ids[m], v[m])
        np.add.at(self.counts, group_ids[m], 1)

    def merge(self, states, group_ids, n_groups):
        self.sums = _grow(self.sums, n_groups, 0)
        self.counts = _grow(self.counts, n_groups, 0)
        sm = K.valid_mask(states[0])
        np.add.at(self.sums, group_ids[sm], states[0].data_host()[sm])
        np.add.at(self.counts, group_ids, states[1].data_host())

    def state(self, n_groups):
        return [self.evaluate(n_groups),
                Column(dt.INT64, _grow(self.counts, n_groups, 0))]

    def state_fields(self, base):
        return [Field(f"{base}[sum]", self.out_type, True),
                Field(f"{base}[count]", dt.INT64, False)]

    def evaluate(self, n_groups):
        sums = _grow(self.sums, n_groups, 0)
        counts = _grow(self.counts, n_groups, 0)
        v = counts > 0
        return Column(self.out_type,
                      sums.astype(self.out_type.device_dtype(), copy=False),
                      None if v.all() else v)


class AvgAcc(SumAcc):
    name = "avg"

    def __init__(self, in_type, out_type):
        # accumulate in a wider type, divide at evaluate
        if out_type.is_decimal:
            acc_t = dt.decimal(38, in_type.scale if in_type.is_decimal else 0)
        else:
            acc_t = dt.FLOAT64
        super().__init__(in_type, acc_t)
        self.final_type = out_type

    def state_fields(self, base):
        return [Field(f"{base}[sum]", self.out_type, True),
                Field(f"{base}[count]", dt.INT64, False)]

    def state(self, n_groups):
        # partial state ships the RAW sums — SumAcc.state() goes through
        # evaluate(), which AvgAcc overrides with the division; reusing
        # it here made two-phase avg divide twice (caught by the pod's
        # cross-process Partial->Final path)
        sums = _grow(self.sums, n_groups, 0)
        counts = _grow(self.counts, n_groups, 0)
        v = counts > 0
        return [Column(self.out_type,
                       sums.astype(self.out_type.device_dtype(),
                                   copy=False),
                       None if v.all() else v),
                Column(dt.INT64, counts)]

    def evaluate(self, n_groups):
        sums = _grow(self.sums, n_groups, 0)
        counts = _grow(self.counts, n_groups, 0)
        valid = counts > 0
        safe = np.where(valid, counts, 1)
        ft = self.final_type
        if ft.is_decimal:
            # sums are at input scale; result at ft.scale. The reference
            # divides in i128 (DecimalAverager::avg div_wrapping,
            # physical-expr-common/src/aggregate/utils.rs:213) —
            # truncation toward zero, NOT round-half-up
            shift = 10 ** (ft.scale - self.out_type.scale)
            num = sums.astype(object) * int(shift)
            den = safe.astype(object)
            q = np.sign(num) * (np.abs(num) // den)
            data = q.astype(np.int64)
        else:
            data = sums / safe
        return Column(ft, data.astype(ft.device_dtype()),
                      None if valid.all() else valid)


# --------------------------------------------------------------------------
# min / max
# --------------------------------------------------------------------------

class MinMaxAcc(GroupsAccumulator):
    def __init__(self, in_type, out_type, is_min: bool):
        super().__init__(in_type, out_type)
        self.is_min = is_min
        self.name = "min" if is_min else "max"
        self._npdt = out_type.device_dtype()
        self._float_keys = False
        if out_type.is_dict_coded:
            self._init = np.int32(2**31 - 1) if is_min else np.int32(-1)
            self.dictionary = Dictionary(np.array([], dtype=object))
        elif self._npdt.kind == "f":
            # arrow total order (-NaN < -Inf < ... < Inf < NaN): track the
            # winner as a monotone uint64 key so NaN sorts greatest instead
            # of poisoning np.minimum/np.maximum
            self._float_keys = True
            self._npdt = np.dtype(np.uint64)
            self._init = np.uint64(0xFFFFFFFFFFFFFFFF) if is_min else np.uint64(0)
        elif self._npdt.kind == "b":
            self._init = True if is_min else False
        elif self._npdt.kind == "O":
            # object-int storage (wide decimal / packed interval): a bound
            # dominating both 10^76 decimals and 128-bit packed intervals
            cap = 1 << 200
            self._init = cap if is_min else -cap
        else:
            info = np.iinfo(self._npdt)
            self._init = info.max if is_min else info.min
        self.best = np.zeros(0, self._npdt)
        self.seen = np.zeros(0, bool)

    @staticmethod
    def _enc_float(data: np.ndarray) -> np.ndarray:
        bits = data.astype(np.float64).view(np.uint64)
        neg = (bits >> np.uint64(63)) == 1
        return np.where(neg, ~bits, bits | np.uint64(1 << 63))

    @staticmethod
    def _dec_float(key: np.ndarray) -> np.ndarray:
        neg = (key >> np.uint64(63)) == 0
        bits = np.where(neg, ~key, key & np.uint64((1 << 63) - 1))
        return bits.view(np.float64)

    def _sync_dict(self, c: Column) -> np.ndarray:
        """Merge the incoming batch's dictionary into the running one,
        remapping stored best codes; returns remapped incoming codes."""
        if c.dictionary is self.dictionary:
            return c.data_host()
        merged, r_self, r_other = self.dictionary.merge(c.dictionary)
        if len(r_self) and len(self.best):
            live = self.seen[: len(self.best)] if len(self.seen) else None
            safe = np.clip(self.best, 0, len(r_self) - 1)
            remapped = r_self[safe]
            self.best = np.where(self.seen, remapped, self._init) \
                if len(self.seen) == len(self.best) else remapped
            del live
        self.dictionary = merged
        return r_other[c.data_host()] if len(r_other) else c.data_host()

    def _apply(self, data, validity, group_ids, n_groups):
        self.best = _grow(self.best, n_groups, self._init)
        self.seen = _grow(self.seen, n_groups, False)
        m = validity if validity is not None else np.ones(len(data), bool)
        fn = np.minimum if self.is_min else np.maximum
        if data.dtype == np.bool_:
            conv = data.astype(np.int32)
            best = self.best.astype(np.int32)
            fn.at(best, group_ids[m], conv[m])
            self.best = best.astype(np.bool_)
        else:
            fn.at(self.best, group_ids[m], data[m])
        seen_new = np.zeros(n_groups, bool)
        seen_new[group_ids[m]] = True
        self.seen |= seen_new

    def update(self, values, group_ids, n_groups):
        c = values[0]
        if self.out_type.is_dict_coded:
            data = self._sync_dict(c)
        else:
            data = K.cast_column(c, self.out_type).data_host()
            if self._float_keys:
                data = self._enc_float(data)
        self._apply(data, c.validity_host(), group_ids, n_groups)

    def merge(self, states, group_ids, n_groups):
        c = states[0]
        if self.out_type.is_dict_coded:
            data = self._sync_dict(c)
        else:
            data = c.data_host()
            if self._float_keys:
                data = self._enc_float(data)
        self._apply(data, c.validity_host(), group_ids, n_groups)

    def state(self, n_groups):
        return [self.evaluate(n_groups)]

    def state_fields(self, base):
        return [Field(f"{base}[{self.name}]", self.out_type, True)]

    def evaluate(self, n_groups):
        best = _grow(self.best, n_groups, self._init)
        seen = _grow(self.seen, n_groups, False)
        dic = self.dictionary if self.out_type.is_dict_coded else None
        if dic is not None:
            best = np.clip(best, 0, max(len(dic) - 1, 0)).astype(np.int32)
        elif self._float_keys:
            best = self._dec_float(best).astype(self.out_type.device_dtype())
        return Column(self.out_type, best, None if seen.all() else seen, dic)


# --------------------------------------------------------------------------
# variance family (count/sum/sumsq moments)
# --------------------------------------------------------------------------

class VarAcc(GroupsAccumulator):
    def __init__(self, in_type, out_type, ddof: int, stddev: bool):
        super().__init__(in_type, dt.FLOAT64)
        self.ddof = ddof       # 1 = sample, 0 = population
        self.stddev = stddev
        self.name = ("stddev" if stddev else "var") + ("_pop" if ddof == 0 else "")
        self.n = np.zeros(0, np.int64)
        self.s = np.zeros(0, np.float64)
        self.ss = np.zeros(0, np.float64)

    def _ensure(self, g):
        self.n = _grow(self.n, g, 0)
        self.s = _grow(self.s, g, 0.0)
        self.ss = _grow(self.ss, g, 0.0)

    def update(self, values, group_ids, n_groups):
        self._ensure(n_groups)
        c = values[0]
        m = K.valid_mask(c)
        x = K.cast_column(c, dt.FLOAT64).data_host()
        g = group_ids[m]
        xm = x[m]
        np.add.at(self.n, g, 1)
        np.add.at(self.s, g, xm)
        np.add.at(self.ss, g, xm * xm)

    def merge(self, states, group_ids, n_groups):
        self._ensure(n_groups)
        np.add.at(self.n, group_ids, states[0].data_host())
        np.add.at(self.s, group_ids, states[1].data_host())
        np.add.at(self.ss, group_ids, states[2].data_host())

    def state(self, n_groups):
        self._ensure(n_groups)
        return [Column(dt.INT64, self.n[:n_groups].copy()),
                Column(dt.FLOAT64, self.s[:n_groups].copy()),
                Column(dt.FLOAT64, self.ss[:n_groups].copy())]

    def state_fields(self, base):
        return [Field(f"{base}[count]", dt.INT64, False),
                Field(f"{base}[sum]", dt.FLOAT64, False),
                Field(f"{base}[sumsq]", dt.FLOAT64, False)]

    def evaluate(self, n_groups):
        self._ensure(n_groups)
        n = self.n[:n_groups]
        valid = n > self.ddof
        safe_n = np.where(n > 0, n, 1).astype(np.float64)
        mean = self.s[:n_groups] / safe_n
        m2 = self.ss[:n_groups] - safe_n * mean * mean
        m2 = np.maximum(m2, 0.0)
        denom = np.where(valid, n - self.ddof, 1).astype(np.float64)
        out = m2 / denom
        if self.stddev:
            out = np.sqrt(out)
        return Column(dt.FLOAT64, out, None if valid.all() else valid)


class CovarAcc(GroupsAccumulator):
    num_args = 2

    def __init__(self, in_type, out_type, ddof: int, kind: str):
        super().__init__(in_type, dt.FLOAT64)
        self.ddof = ddof
        self.kind = kind  # covar | corr
        self.name = kind
        self.n = np.zeros(0, np.int64)
        self.sx = np.zeros(0, np.float64)
        self.sy = np.zeros(0, np.float64)
        self.sxx = np.zeros(0, np.float64)
        self.syy = np.zeros(0, np.float64)
        self.sxy = np.zeros(0, np.float64)

    def _ensure(self, g):
        for a in ("n", "sx", "sy", "sxx", "syy", "sxy"):
            setattr(self, a, _grow(getattr(self, a),
                                   g, 0 if a == "n" else 0.0))

    def update(self, values, group_ids, n_groups):
        self._ensure(n_groups)
        cx, cy = values
        m = K.valid_mask(cx) & K.valid_mask(cy)
        x = K.cast_column(cx, dt.FLOAT64).data_host()[m]
        y = K.cast_column(cy, dt.FLOAT64).data_host()[m]
        g = group_ids[m]
        np.add.at(self.n, g, 1)
        np.add.at(self.sx, g, x)
        np.add.at(self.sy, g, y)
        np.add.at(self.sxx, g, x * x)
        np.add.at(self.syy, g, y * y)
        np.add.at(self.sxy, g, x * y)

    def merge(self, states, group_ids, n_groups):
        self._ensure(n_groups)
        for arr, st in zip(("n", "sx", "sy", "sxx", "syy", "sxy"), states):
            np.add.at(getattr(self, arr), group_ids, st.data_host())

    def state(self, n_groups):
        self._ensure(n_groups)
        return [Column(dt.INT64, self.n[:n_groups].copy())] + [
            Column(dt.FLOAT64, getattr(self, a)[:n_groups].copy())
            for a in ("sx", "sy", "sxx", "syy", "sxy")]

    def state_fields(self, base):
        return [Field(f"{base}[n]", dt.INT64, False)] + [
            Field(f"{base}[{a}]", dt.FLOAT64, False)
            for a in ("sx", "sy", "sxx", "syy", "sxy")]

    def evaluate(self, n_groups):
        self._ensure(n_groups)
        n = self.n[:n_groups].astype(np.float64)
        safe = np.where(n > 0, n, 1.0)
        cxy = self.sxy[:n_groups] - self.sx[:n_groups] * self.sy[:n_groups] / safe
        if self.kind == "corr":
            cxx = self.sxx[:n_groups] - self.sx[:n_groups] ** 2 / safe
            cyy = self.syy[:n_groups] - self.sy[:n_groups] ** 2 / safe
            denom = np.sqrt(np.maximum(cxx * cyy, 0.0))
            # zero variance (incl. a single point) yields 0, not NULL
            # (reference: functions-aggregate/src/correlation.rs evaluate)
            valid = n > 0
            out = np.where(denom > 0, cxy / np.where(denom > 0, denom, 1.0), 0.0)
        else:
            valid = n > self.ddof
            out = cxy / np.where(valid, n - self.ddof, 1.0)
        return Column(dt.FLOAT64, out, None if valid.all() else valid)


# --------------------------------------------------------------------------
# collecting accumulators (single-phase): median, count distinct, array_agg
# --------------------------------------------------------------------------

class CollectingAcc(GroupsAccumulator):
    """Buffers (group_id, value) pairs; subclasses reduce at evaluate.

    ``keep_nulls`` keeps NULL input rows in the buffer (array_agg/first/last
    semantics); ``order_specs`` + order columns (wired by AggregateExec when
    the SQL has ``agg(x ORDER BY y)``) make ``_collect`` return rows sorted
    by the order keys (reference: aggregate_function ordering args,
    functions-aggregate/src/array_agg.rs OrderSensitiveArrayAggAccumulator).
    """

    keep_nulls = False

    def __init__(self, in_type, out_type):
        super().__init__(in_type, out_type)
        self._groups: List[np.ndarray] = []
        self._vals: List[Column] = []
        self._ocols: List[List[Column]] = []
        self.order_specs: List[Tuple[bool, bool]] = []  # (asc, nulls_first)

    def supports_two_phase(self):
        return False

    def update(self, values, group_ids, n_groups, order_cols=None):
        c = values[0]
        if self.keep_nulls:
            m = np.ones(len(c), bool)
        else:
            m = K.valid_mask(c)
        self._groups.append(group_ids[m])
        keep_all = m.all()
        self._vals.append(c if keep_all else c.filter_host(m))
        if order_cols:
            self._ocols.append([o if keep_all else o.filter_host(m)
                                for o in order_cols])

    def merge(self, states, group_ids, n_groups):
        raise internal(f"{self.name} does not support two-phase execution")

    def _collect(self):
        """Returns (group_ids, values) — ordered by the ORDER BY keys when
        present (stable, so ties keep input order)."""
        from ..common.column import concat_columns
        if not self._groups:
            return np.zeros(0, np.int64), None
        g = np.concatenate(self._groups)
        vals = concat_columns(self._vals) if len(self._vals) > 1 else self._vals[0]
        if self._ocols and self.order_specs:
            from .plan.sort import order_keys
            ocols = [concat_columns([bat[j] for bat in self._ocols])
                     if len(self._ocols) > 1 else self._ocols[0][j]
                     for j in range(len(self.order_specs))]
            keys: List[np.ndarray] = []
            for c, (asc, nf) in zip(ocols, self.order_specs):
                keys.extend(order_keys(c, asc, nf))
            order = np.lexsort(tuple(reversed(keys)))
            g = g[order]
            vals = vals.take_host(order)
        return g, vals


class MedianAcc(CollectingAcc):
    name = "median"

    def evaluate(self, n_groups):
        g, vals = self._collect()
        out_np = self.out_type.device_dtype()
        result = np.zeros(n_groups, out_np)
        seen = np.zeros(n_groups, bool)
        if vals is not None and len(g):
            exact_int = self.out_type.is_integer or self.out_type.is_decimal
            if exact_int:
                # operate on the raw (scaled) integers: a float64 detour
                # loses the low digits of int64/decimal values
                # (reference: functions-aggregate/src/median.rs works on the
                # native arrow type)
                x = vals.data_host()
                if vals.dtype.is_decimal and self.out_type.is_decimal \
                        and vals.dtype.scale != self.out_type.scale:
                    x = x.astype(np.int64) * 10 ** (
                        self.out_type.scale - vals.dtype.scale)
            else:
                x = K.cast_column(vals, dt.FLOAT64).data_host() \
                    if not self.out_type.is_string else vals.data_host()
            order = np.lexsort((x, g))
            gs, xs = g[order], np.asarray(x)[order]
            starts = np.searchsorted(gs, np.arange(n_groups), side="left")
            ends = np.searchsorted(gs, np.arange(n_groups), side="right")
            cnt = ends - starts
            has = cnt > 0
            mid = starts + np.maximum(cnt - 1, 0) // 2
            lo = xs[np.clip(mid, 0, max(len(xs) - 1, 0))] if len(xs) else np.zeros(n_groups)
            hi_idx = np.clip(starts + cnt // 2, 0, max(len(xs) - 1, 0))
            hi = xs[hi_idx] if len(xs) else np.zeros(n_groups)
            even = (cnt % 2 == 0) & has
            if exact_int:
                # overflow-safe exact midpoint, truncating toward zero like
                # the reference's i128 (lo+hi)/2
                s = lo.astype(object) + hi.astype(object)
                q = np.array([int(abs(v) // 2) * (1 if v >= 0 else -1)
                              for v in s], dtype=object)
                result = np.where(even, q, lo.astype(object)).astype(out_np)
            else:
                med = np.where(even, (lo + hi) / 2.0, lo)
                result = med.astype(out_np)
            seen = has
        return Column(self.out_type, result, None if seen.all() else seen)


class CountDistinctAcc(CollectingAcc):
    name = "count_distinct"

    def __init__(self, in_type, approx: bool = False):
        super().__init__(in_type, dt.INT64)
        self.name = "approx_distinct" if approx else "count_distinct"

    def evaluate(self, n_groups):
        from .hashing import factorize
        g, vals = self._collect()
        counts = np.zeros(n_groups, np.int64)
        if vals is not None and len(g):
            from .hashing import _dense_codes
            codes = factorize([vals], len(g))[0]
            pair = g * (codes.max(initial=0) + 1) + codes
            pair_ids, n_pairs = _dense_codes(pair)
            first = np.empty(n_pairs, np.int64)
            first[pair_ids[::-1]] = np.arange(len(pair) - 1, -1, -1)
            np.add.at(counts, g[first], 1)
        return Column(dt.INT64, counts)


class ApproxDistinctAcc(GroupsAccumulator):
    """HyperLogLog cardinality (reference:
    physical-expr/src/aggregate/hyperloglog.rs, 2^14 registers)."""
    name = "approx_distinct"

    def __init__(self, in_type):
        super().__init__(in_type, dt.INT64)
        from .sketches import HyperLogLog
        self.hll = HyperLogLog()

    def supports_two_phase(self):
        return False

    def update(self, values, group_ids, n_groups):
        from .hashing import create_hashes
        c = values[0]
        m = K.valid_mask(c)
        h = create_hashes([c])
        self.hll.add_hashed(h[m], group_ids[m], n_groups)

    def merge(self, states, group_ids, n_groups):
        raise internal("approx_distinct does not support two-phase execution")

    def evaluate(self, n_groups):
        return Column(dt.INT64, self.hll.estimate(n_groups))


class ArrayAggAcc(CollectingAcc):
    name = "array_agg"
    keep_nulls = True   # reference array_agg keeps NULL elements

    def evaluate(self, n_groups):
        g, vals = self._collect()
        out = np.empty(n_groups, dtype=object)
        for i in range(n_groups):
            out[i] = []
        if vals is not None and len(g):
            pyvals = vals.to_pylist()
            for gi, v in zip(g, pyvals):
                out[gi].append(v)
        # represented as a host object column of lists; zero input rows
        # yield [] (reference: array_agg over LIMIT 0 returns empty list)
        return Column(dt.list_(self.in_type), out, None)


class NthValueAcc(CollectingAcc):
    """nth_value(x, n ORDER BY ...) aggregate (reference:
    functions-aggregate/src/nth_value.rs)."""
    name = "nth_value"
    keep_nulls = True
    num_args = 2

    def __init__(self, in_type, out_type):
        super().__init__(in_type, out_type)
        self.nth = 1

    def update(self, values, group_ids, n_groups, order_cols=None):
        if len(values) > 1 and len(values[1]):
            self.nth = int(values[1].data_host()[0])
        super().update(values[:1], group_ids, n_groups, order_cols)

    def evaluate(self, n_groups):
        g, vals = self._collect()
        if vals is None:
            return Column(self.out_type,
                          np.zeros(n_groups, self.out_type.device_dtype()),
                          np.zeros(n_groups, bool))
        # position within group along the collected (ordered) sequence
        nth = self.nth
        pick = np.full(n_groups, -1, np.int64)
        counts = np.zeros(n_groups, np.int64)
        if nth < 0:
            g, vals = g[::-1], vals.take_host(np.arange(len(g) - 1, -1, -1))
            nth = -nth
        for i, gi in enumerate(g):
            counts[gi] += 1
            if counts[gi] == nth:
                pick[gi] = i
        has = pick >= 0
        safe = np.where(has, pick, 0)
        out = vals.take_host(safe)
        v = K.and_validity(out.validity_host(), None if has.all() else has)
        return Column(vals.dtype, out.data_host(), v, out.dictionary)


class StringAggAcc(CollectingAcc):
    name = "string_agg"
    num_args = 2

    def __init__(self, in_type, out_type):
        super().__init__(in_type, dt.STRING)
        self.sep = ","

    def update(self, values, group_ids, n_groups, order_cols=None):
        if len(values) > 1 and len(values[1]):
            s = values[1]
            if s.dtype.is_string and len(s.dictionary):
                self.sep = str(s.dictionary.values[int(s.data_host()[0])])
        super().update(values[:1], group_ids, n_groups, order_cols)

    def evaluate(self, n_groups):
        g, vals = self._collect()
        parts: List[List[str]] = [[] for _ in range(n_groups)]
        if vals is not None and len(g):
            pyvals = vals.to_pylist()
            for gi, v in zip(g, pyvals):
                parts[gi].append(str(v))
        seen = np.array([len(p) > 0 for p in parts], bool) if n_groups else np.zeros(0, bool)
        raw = np.fromiter((self.sep.join(p) for p in parts), dtype=object,
                          count=n_groups)
        c = K.encode_strings(raw, None if seen.all() else seen)
        return c


# --------------------------------------------------------------------------
# first/last, bool/bit ops
# --------------------------------------------------------------------------

class FirstLastAcc(CollectingAcc):
    """first_value/last_value(x [ORDER BY ...] [IGNORE NULLS]) (reference:
    functions-aggregate/src/first_last.rs). NULL values count unless
    IGNORE NULLS; the winner is the first/last row in the ORDER BY order
    (input order when unordered)."""
    keep_nulls = True

    def __init__(self, in_type, out_type, first: bool,
                 ignore_nulls: bool = False):
        super().__init__(in_type, out_type)
        self.first = first
        self.ignore_nulls = ignore_nulls
        self.name = "first_value" if first else "last_value"

    def evaluate(self, n_groups):
        if not self.first and self.order_specs:
            # LAST_VALUE(x ORDER BY k) keeps the FIRST-encountered row among
            # max-key ties (the reference replaces the candidate only on a
            # strictly greater ordering): realize it as first-of-descending
            self.order_specs = [(not asc, not nf)
                                for asc, nf in self.order_specs]
            pick_first = True
        else:
            pick_first = self.first
        g, vals = self._collect()
        if vals is None:
            return Column(self.out_type,
                          np.zeros(n_groups, self.out_type.device_dtype()),
                          np.zeros(n_groups, bool))
        if self.ignore_nulls and vals.has_nulls:
            m = vals.validity_host()
            g, vals = g[m], vals.filter_host(m)
        idx = np.arange(len(g))
        pick = np.full(n_groups, -1, np.int64)
        if pick_first:
            pick[g[::-1]] = idx[::-1]
        else:
            pick[g] = idx
        has = pick >= 0
        safe = np.where(has, pick, 0)
        out = vals.take_host(safe)
        v = K.and_validity(out.validity_host(), has if not has.all() else None)
        return Column(vals.dtype, out.data_host(), v, out.dictionary)


class BoolAcc(GroupsAccumulator):
    def __init__(self, in_type, out_type, is_and: bool):
        super().__init__(in_type, dt.BOOL)
        self.is_and = is_and
        self.name = "bool_and" if is_and else "bool_or"
        self.acc = np.zeros(0, bool)
        self.seen = np.zeros(0, bool)

    def update(self, values, group_ids, n_groups):
        self.acc = _grow(self.acc, n_groups, self.is_and)
        self.seen = _grow(self.seen, n_groups, False)
        c = values[0]
        m = K.valid_mask(c)
        d = c.data_host().astype(bool)
        fn = np.logical_and if self.is_and else np.logical_or
        tmp = self.acc.astype(np.int8)
        red = np.minimum if self.is_and else np.maximum
        red.at(tmp, group_ids[m], d[m].astype(np.int8))
        self.acc = tmp.astype(bool)
        s = np.zeros(n_groups, bool)
        s[group_ids[m]] = True
        self.seen |= s
        del fn

    def merge(self, states, group_ids, n_groups):
        self.update(states, group_ids, n_groups)

    def state(self, n_groups):
        return [self.evaluate(n_groups)]

    def state_fields(self, base):
        return [Field(f"{base}[{self.name}]", dt.BOOL, True)]

    def evaluate(self, n_groups):
        acc = _grow(self.acc, n_groups, self.is_and)
        seen = _grow(self.seen, n_groups, False)
        return Column(dt.BOOL, acc, None if seen.all() else seen)


class BitAcc(GroupsAccumulator):
    def __init__(self, in_type, out_type, op: str):
        super().__init__(in_type, out_type)
        self.op = op
        self.name = f"bit_{op}"
        self._npdt = out_type.device_dtype()
        init = {"and": -1, "or": 0, "xor": 0}[op]
        self._init = init
        self.acc = np.zeros(0, self._npdt)
        self.seen = np.zeros(0, bool)

    def update(self, values, group_ids, n_groups):
        self.acc = _grow(self.acc, n_groups, self._init)
        self.seen = _grow(self.seen, n_groups, False)
        c = values[0]
        m = K.valid_mask(c)
        d = K.cast_column(c, self.out_type).data_host()
        fn = {"and": np.bitwise_and, "or": np.bitwise_or,
              "xor": np.bitwise_xor}[self.op]
        fn.at(self.acc, group_ids[m], d[m])
        s = np.zeros(n_groups, bool)
        s[group_ids[m]] = True
        self.seen |= s

    def merge(self, states, group_ids, n_groups):
        self.update(states, group_ids, n_groups)

    def state(self, n_groups):
        return [self.evaluate(n_groups)]

    def state_fields(self, base):
        return [Field(f"{base}[{self.name}]", self.out_type, True)]

    def evaluate(self, n_groups):
        acc = _grow(self.acc, n_groups, self._init)
        seen = _grow(self.seen, n_groups, False)
        return Column(self.out_type, acc, None if seen.all() else seen)


class DistinctReduceAcc(CollectingAcc):
    """sum/avg DISTINCT: collect (group, value) pairs, dedup, reduce
    (reference: count_distinct/{native,bytes}.rs generalized)."""

    def __init__(self, in_type, out_type, kind: str):
        super().__init__(in_type, out_type)
        self.kind = kind
        self.name = f"{kind}_distinct"

    def evaluate(self, n_groups):
        from .hashing import factorize
        g, vals = self._collect()
        npdt = self.out_type.device_dtype()
        sums = np.zeros(n_groups, np.float64 if not self.out_type.is_decimal
                        and not self.out_type.is_integer else np.int64)
        counts = np.zeros(n_groups, np.int64)
        if vals is not None and len(g):
            from .hashing import _dense_codes
            codes = factorize([vals], len(g))[0]
            card = codes.max(initial=0) + 1
            pair = g * card + codes
            pair_ids, n_pairs = _dense_codes(pair)
            first = np.empty(n_pairs, np.int64)
            first[pair_ids[::-1]] = np.arange(len(pair) - 1, -1, -1)
            gsel = g[first]
            raw = K.cast_column(vals, self.out_type).data_host() \
                if not self.out_type.is_decimal else \
                vals.data_host().astype(np.int64) * (
                    10 ** (self.out_type.scale -
                           (vals.dtype.scale if vals.dtype.is_decimal else 0)))
            vsel = raw[first]
            np.add.at(sums, gsel, vsel)
            np.add.at(counts, gsel, 1)
        has = counts > 0
        v = None if has.all() else has
        if self.kind == "sum":
            return Column(self.out_type, sums.astype(npdt), v)
        safe = np.where(has, counts, 1)
        if self.out_type.is_decimal:
            # i128 division truncates toward zero (DecimalAverager::avg)
            q = np.sign(sums) * (np.abs(sums.astype(object)) // safe)
            return Column(self.out_type, q.astype(np.int64), v)
        return Column(self.out_type, (sums / safe).astype(npdt), v)


class DistinctWrapAcc(CollectingAcc):
    """DISTINCT for an arbitrary aggregate: buffer (group, value) pairs,
    drop duplicate values within each group, then run the plain accumulator
    over the deduplicated rows (reference: the *Distinct accumulator
    variants in functions-aggregate, e.g. median.rs DistinctMedianAccumulator,
    bit_and_or_xor.rs DistinctBitXorAccumulator)."""

    def __init__(self, in_type, out_type, inner_factory, name: str):
        super().__init__(in_type, out_type)
        self.inner_factory = inner_factory
        self.name = f"{name}_distinct"
        # NULL handling mirrors the wrapped aggregate (array_agg keeps a
        # single NULL among the distinct values, median/var drop them)
        self.keep_nulls = bool(getattr(inner_factory(), "keep_nulls", False))

    def evaluate(self, n_groups):
        inner = self.inner_factory()
        g, vals = self._collect()
        if vals is not None and len(g):
            if vals.dtype.is_nested:
                seen, keep = set(), []
                for i, v in enumerate(vals.to_pylist()):
                    key = (int(g[i]), repr(v))
                    if key not in seen:
                        seen.add(key)
                        keep.append(i)
                sel = np.asarray(keep, np.int64)
            else:
                from .hashing import factorize, _dense_codes
                codes = factorize([vals], len(g))[0].astype(np.int64)
                card = int(codes.max(initial=0)) + 1
                if vals.has_nulls:
                    # all NULL rows share one extra distinct slot
                    codes = np.where(vals.validity_host(), codes, card)
                    card += 1
                pair = g.astype(np.int64) * card + codes
                pair_ids, n_pairs = _dense_codes(pair)
                first = np.empty(n_pairs, np.int64)
                first[pair_ids[::-1]] = np.arange(len(pair) - 1, -1, -1)
                sel = np.sort(first)
            inner.update([vals.take_host(sel)], g[sel], n_groups)
        return inner.evaluate(n_groups)


class RegrAcc(GroupsAccumulator):
    """Linear-regression aggregate family regr_* (reference:
    functions-aggregate/src/regr.rs). Accumulates the five moments
    (n, Σx, Σy, Σxx, Σyy, Σxy) over rows where BOTH x and y are non-null;
    note the SQL argument order is regr_*(y, x)."""
    num_args = 2

    def __init__(self, out_type, kind: str):
        super().__init__(dt.FLOAT64, dt.FLOAT64 if kind != "count" else dt.INT64)
        self.kind = kind
        self.name = f"regr_{kind}"
        self.n = np.zeros(0, np.int64)
        self.sx = np.zeros(0, np.float64)
        self.sy = np.zeros(0, np.float64)
        self.sxx = np.zeros(0, np.float64)
        self.syy = np.zeros(0, np.float64)
        self.sxy = np.zeros(0, np.float64)

    def supports_two_phase(self):
        return True

    def _ensure(self, g):
        self.n = _grow(self.n, g, 0)
        for a in ("sx", "sy", "sxx", "syy", "sxy"):
            setattr(self, a, _grow(getattr(self, a), g, 0.0))

    def update(self, values, group_ids, n_groups):
        self._ensure(n_groups)
        y, x = values[0], values[1]
        m = K.valid_mask(y) & K.valid_mask(x)
        xv = K.cast_column(x, dt.FLOAT64).data_host()[m]
        yv = K.cast_column(y, dt.FLOAT64).data_host()[m]
        gi = group_ids[m]
        np.add.at(self.n, gi, 1)
        np.add.at(self.sx, gi, xv)
        np.add.at(self.sy, gi, yv)
        np.add.at(self.sxx, gi, xv * xv)
        np.add.at(self.syy, gi, yv * yv)
        np.add.at(self.sxy, gi, xv * yv)

    def merge(self, states, group_ids, n_groups):
        self._ensure(n_groups)
        np.add.at(self.n, group_ids, states[0].data_host())
        for i, a in enumerate(("sx", "sy", "sxx", "syy", "sxy")):
            np.add.at(getattr(self, a), group_ids, states[i + 1].data_host())

    def state(self, n_groups):
        self._ensure(n_groups)
        return [Column(dt.INT64, self.n)] + [
            Column(dt.FLOAT64, getattr(self, a))
            for a in ("sx", "sy", "sxx", "syy", "sxy")]

    def state_fields(self, base):
        return [Field(f"{base}[n]", dt.INT64, False)] + [
            Field(f"{base}[{a}]", dt.FLOAT64, False)
            for a in ("sx", "sy", "sxx", "syy", "sxy")]

    def evaluate(self, n_groups):
        self._ensure(n_groups)
        n = self.n.astype(np.float64)
        has = self.n > 0
        safe = np.where(has, n, 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            mx, my = self.sx / safe, self.sy / safe
            vxx = self.sxx - self.sx * self.sx / safe   # n*var(x)
            vyy = self.syy - self.sy * self.sy / safe
            vxy = self.sxy - self.sx * self.sy / safe
            k = self.kind
            if k == "count":
                return Column(dt.INT64, self.n.copy())
            if k == "avgx":
                out, valid = mx, has
            elif k == "avgy":
                out, valid = my, has
            elif k == "sxx":
                out, valid = vxx, has
            elif k == "syy":
                out, valid = vyy, has
            elif k == "sxy":
                out, valid = vxy, has
            elif k == "slope":
                out, valid = vxy / vxx, has & (vxx != 0)
            elif k == "intercept":
                out, valid = my - (vxy / vxx) * mx, has & (vxx != 0)
            elif k == "r2":
                # reference: NULL when var(x)=0; 1.0 when var(y)=0
                out = np.where(vyy == 0, 1.0, (vxy * vxy) / (vxx * vyy))
                valid = has & (vxx != 0)
            else:
                raise internal(f"unknown regr kind {k}")
        out = np.where(valid, out, 0.0)
        return Column(dt.FLOAT64, out, None if valid.all() else valid)


class ApproxPercentileAcc(GroupsAccumulator):
    """t-digest percentile, bit-identical to the reference on identical
    input order (reference: physical-expr-common/src/aggregate/tdigest.rs,
    functions-aggregate/src/approx_percentile_cont.rs: each update batch is
    sorted and folded into the digest via merge_sorted)."""
    name = "approx_percentile_cont"
    num_args = 2

    def __init__(self, in_type, out_type):
        super().__init__(in_type, out_type)
        self.q = 0.5
        self.max_size = 100
        self._digests: dict = {}   # group id -> RefTDigest

    def supports_two_phase(self):
        return False

    def update(self, values, group_ids, n_groups):
        from .sketches import RefTDigest
        if len(values) > 1 and len(values[1]):
            # the percentile literal may arrive as a scaled-int decimal
            self.q = float(
                K.cast_column(values[1], dt.FLOAT64).data_host()[0])
        if len(values) > 2 and len(values[2]):
            self.max_size = int(values[2].data_host()[0])
        c = values[0]
        m = K.valid_mask(c)
        x = K.cast_column(c, dt.FLOAT64).data_host()[m]
        g = group_ids[m]
        order = np.lexsort((x, g))
        xs, gs = x[order], g[order]
        bounds = np.flatnonzero(np.diff(gs)) + 1
        for gi, seg in zip(gs[np.concatenate([[0], bounds])] if len(gs) else [],
                           np.split(xs, bounds)):
            d = self._digests.get(int(gi))
            if d is None:
                d = RefTDigest(self.max_size)
            self._digests[int(gi)] = d.merge_sorted(seg)

    def merge(self, states, group_ids, n_groups):
        raise internal(
            "approx_percentile_cont does not support two-phase execution")

    def evaluate(self, n_groups):
        npdt = self.out_type.device_dtype()
        out = np.zeros(n_groups, npdt)
        seen = np.zeros(n_groups, bool)
        for gi, d in self._digests.items():
            if gi < n_groups and d.count > 0:
                v = d.estimate_quantile(self.q)
                # Rust `q as iN` truncates toward zero
                out[gi] = int(v) if self.out_type.is_integer else v
                seen[gi] = True
        return Column(self.out_type, out, None if seen.all() else seen)


class ApproxPercentileWeightedAcc(ApproxPercentileAcc):
    """approx_percentile_cont_with_weight(value, weight, q) (reference:
    functions-aggregate/src/approx_percentile_cont_with_weight.rs: every
    row becomes a single-centroid digest with count 1 — including its
    weight quirk — merged via merge_digests)."""
    name = "approx_percentile_cont_with_weight"
    num_args = 3

    def update(self, values, group_ids, n_groups):
        from .sketches import RefTDigest
        if len(values) > 2 and len(values[2]):
            self.q = float(
                K.cast_column(values[2], dt.FLOAT64).data_host()[0])
        c = values[0]
        m = K.valid_mask(c)
        if len(values) > 1:
            m = m & K.valid_mask(values[1])
            w = K.cast_column(values[1], dt.FLOAT64).data_host()
        else:
            w = np.ones(len(c))
        x = K.cast_column(c, dt.FLOAT64).data_host()
        for gi in np.unique(group_ids[m]):
            sel = m & (group_ids == gi)
            rows = [_row_digest(float(mv), float(wv))
                    for mv, wv in zip(x[sel], w[sel])]
            prior = self._digests.get(int(gi), RefTDigest(self.max_size))
            self._digests[int(gi)] = RefTDigest.merge_digests(
                rows + [prior], self.max_size)


def _row_digest(mean: float, weight: float):
    from .sketches import RefTDigest
    d = RefTDigest(100)
    d.centroids = [(mean, weight)]
    d.count = 1.0     # reference quirk: count 1 regardless of weight
    d.min = mean
    d.max = mean
    return d


# --------------------------------------------------------------------------
# factory
# --------------------------------------------------------------------------

def create_accumulator(name: str, in_types: List[DataType],
                       out_type: DataType, distinct: bool = False,
                       count_star: bool = False,
                       ignore_nulls: bool = False) -> GroupsAccumulator:
    from ..functions.udf import AGGREGATE_UDFS
    udaf = AGGREGATE_UDFS.get(name)
    if udaf is not None:
        return udaf.accumulator_factory()
    it = in_types[0] if in_types else dt.INT64
    if distinct:
        if name == "count":
            return CountDistinctAcc(it)
        if name == "sum":
            return DistinctReduceAcc(it, out_type, "sum")
        if name in ("avg", "mean"):
            return DistinctReduceAcc(it, out_type, "avg")
        if name in ("min", "max"):
            distinct = False   # distinct is a true no-op for min/max only
        else:
            # any other aggregate: dedup (group, value) pairs, then run the
            # plain accumulator (median/var/bit_xor/array_agg/...)
            return DistinctWrapAcc(
                it, out_type,
                lambda: create_accumulator(name, in_types, out_type,
                                           count_star=count_star,
                                           ignore_nulls=ignore_nulls),
                name)
    if name == "count":
        return CountAcc(it, out_type, count_star=count_star,
                        nargs=len(in_types))
    if name == "sum":
        return SumAcc(it, out_type)
    if name in ("avg", "mean"):
        return AvgAcc(it, out_type)
    if name == "min":
        return MinMaxAcc(it, out_type, True)
    if name == "max":
        return MinMaxAcc(it, out_type, False)
    if name in ("stddev", "stddev_samp"):
        return VarAcc(it, out_type, 1, True)
    if name == "stddev_pop":
        return VarAcc(it, out_type, 0, True)
    if name in ("var", "variance", "var_samp"):
        return VarAcc(it, out_type, 1, False)
    if name == "var_pop":
        return VarAcc(it, out_type, 0, False)
    if name in ("covar", "covar_samp"):
        return CovarAcc(it, out_type, 1, "covar")
    if name == "covar_pop":
        return CovarAcc(it, out_type, 0, "covar")
    if name == "corr":
        return CovarAcc(it, out_type, 1, "corr")
    if name == "median":
        return MedianAcc(it, out_type)
    if name == "approx_median":
        # t-digest at q=0.5 (reference: approx_median.rs delegates to
        # ApproxPercentileCont)
        return ApproxPercentileAcc(it, out_type)
    if name == "approx_distinct":
        return ApproxDistinctAcc(it)
    if name == "array_agg":
        return ArrayAggAcc(it, out_type)
    if name == "string_agg":
        return StringAggAcc(it, out_type)
    if name == "first_value":
        return FirstLastAcc(it, out_type, True, ignore_nulls)
    if name == "last_value":
        return FirstLastAcc(it, out_type, False, ignore_nulls)
    if name == "nth_value":
        return NthValueAcc(it, out_type)
    if name.startswith("regr_") and name[5:] in (
            "slope", "intercept", "count", "r2", "avgx", "avgy",
            "sxx", "syy", "sxy"):
        return RegrAcc(out_type, name[5:])
    if name in ("bool_and", "every"):
        return BoolAcc(it, out_type, True)
    if name == "bool_or":
        return BoolAcc(it, out_type, False)
    if name in ("bit_and", "bit_or", "bit_xor"):
        return BitAcc(it, out_type, name[4:])
    if name == "approx_percentile_cont":
        return ApproxPercentileAcc(it, out_type)
    if name == "approx_percentile_cont_with_weight":
        return ApproxPercentileWeightedAcc(it, out_type)
    raise ExecutionError(f"aggregate function '{name}' is not implemented")
